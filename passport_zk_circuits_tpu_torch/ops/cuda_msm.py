"""K10 wrappers: multi-scalar multiplication over BN254 G1 and G2 on the
card (csrc/msm.cu), Pippenger's bucket method.

No TPU kernel is replaced: the JAX package leaves the MSM to XLA
(``passport_zk_circuits_tpu/ops/msm.py:122``). ``msm_g1`` and ``msm_g2``
compute what ``ops/msm.msm_affine`` computes, which stays as their plain
version:

    px, py: (16, N) affine limbs (G1) or (16, 2, N) (G2), int64;
    scalars: (16, *L, N) 16-bit limbs, *L the proof lanes sharing the points;
    -> affine (x, y), each (16[, 2], *L); infinity -> zeros.

The MSM's value is unique, so its affine coordinates equal the plain
version's bit for bit whatever the order of the additions. A CPU tensor
takes the plain version; a CUDA tensor launches the kernels or raises.

The glue below moves indices only (csrc/msm.cuh describes the plan): a
window is c bits of the scalar (``window_bits``: c from the point count),
its digit signed with the carry taken into the next window
(``signed_digits``); the (lane, window, |digit|, point) items with a
non-zero digit are sorted by bucket with ``torch.sort``; rounds of affine
pair adds halve every bucket while they hold enough adds to fill the card,
runs of what is left go to one thread each, in passes until every bucket
has one; groups of each window's non-empty buckets are weighted by their
digits and joined by runs again; then the lanes' Horner chains. Every
group operation runs in a kernel. ``Schedule`` is the glue, computed from
the scalars alone; ``execute`` launches its kernels through a
``call(entry, *args)``, so that tests run the same glue over a host build
of the kernels' bodies.

``points`` converts a key's points to Montgomery words once
(``ProvingKey.to`` keeps only them on a card); ``msm_*(None, None,
scalars, mont=...)`` then skips the conversion.
"""

from __future__ import annotations

import math

import torch

from . import bignum as bn
from . import cuda_build
from . import g2 as _g2
from . import msm as _msm

# The plan's sizes, tried on an H100 with tools/msm_bench at the ECDSA p256
# prove's sizes (PERF.md): a round after the first pays an
# inversion's latency a thread, so it runs only while it holds 2^22 adds;
# what is left goes to runs of mixed adds.
C_MIN, C_MAX = 8, 16        # window bits, log2(points) - 3 clamped
ROUND_MIN_ADDS = 1 << 22    # the adds a round after the first must hold
ROUND_THREADS = 1 << 16     # threads a round aims at
PER_MIN, PER_MAX = 32, 256  # affine adds a thread of a round shares an inverse
RUN_THREADS = 1 << 15       # threads a pass of runs aims at
RUN_MIN, RUN_MAX = 4, 32    # points a thread of a pass adds
GROUP = 16                  # non-empty buckets a thread of the reduction
MAX_ITEMS = 1 << 29         # 4 items (the rounds' slots) fit an int32
_R_MOD_Q = (1 << 256) % _g2.Q


def coord_words(g2: bool) -> int:
    """32-bit words of one coordinate: Fq, or Fq2 for G2."""
    return 16 if g2 else 8


def _limbs_to_words(limbs):
    """(16, *S) 16-bit limbs -> (*S, 8) int32 words (two's complement)."""
    w = limbs[0::2] | (limbs[1::2] << 16)
    w = w - ((w >> 31) << 32)
    return w.movedim(0, -1).to(torch.int32)


def _mont(x):
    """x * 2^256 mod q on (16, ...) normal-form limbs, plain PyTorch."""
    fp = bn.StaticMod(_g2.Q, 16)
    return fp.mul(x, fp.const_like(_R_MOD_Q, x).expand(x.shape))


def points_plain(px, py, g2: bool):
    """Plain version of ``points``: (N, 2 * coord_words) int32, each point's
    x then y in Montgomery words (an Fq2 coordinate c0 then c1)."""
    n = px.shape[-1]
    out = []
    for c in (px, py):
        w = _limbs_to_words(_mont(c))                  # (N, 8) or (2, N, 8)
        out.append(w.movedim(0, 1).reshape(n, -1) if g2 else w)
    return torch.cat(out, 1).contiguous()


def _check_points(name, px, py, g2):
    if px is None or py is None:
        raise ValueError(f"{name}: px and py are needed (only a CUDA call "
                         "with mont may leave them out)")
    want = 3 if g2 else 2
    if px.shape != py.shape or px.dim() != want or px.shape[0] != 16 or (
            g2 and px.shape[1] != 2):
        raise ValueError(f"{name}: px, py must be (16{', 2' if g2 else ''}, "
                         f"N), got {tuple(px.shape)}, {tuple(py.shape)}")


def points(px, py, curve: str = "bn254_g1"):
    """A query's affine points in Montgomery words, (N, 2 * coord_words)
    int32, once a key. A CPU tensor takes the plain version."""
    g2 = curve == "bn254_g2"
    _check_points("points", px, py, g2)
    if not px.is_cuda:
        return points_plain(px, py, g2)
    px, py = px.contiguous(), py.contiguous()
    cuda_build.require_cuda_int64("points", px, py)
    n = px.shape[-1]
    out = torch.empty((n, 2 * coord_words(g2)), dtype=torch.int32,
                      device=px.device)
    cuda_build.launch("points", "pzk_msm_points", px, int(g2), px.data_ptr(),
                      py.data_ptr(), n, out.data_ptr())
    points.launches += 1
    return out


points.launches = 0


def window_bits(n: int) -> int:
    """c, the bits of a window of an MSM over n points: log2(n) - 3 (the
    bucket adds, about n a window, against the reduction's 2^c a window),
    clamped to C_MIN..C_MAX."""
    return max(C_MIN, min(C_MAX, n.bit_length() - 4))


def signed_digits(scalars, c: int):
    """(16, *L, N) 16-bit limbs of scalars below 2^254 -> (lanes, nwin, N)
    int32 digits in [-(2^(c-1) - 1), 2^(c-1)], nwin = ceil(255 / c): window
    w's c bits plus the carry from below, less 2^c (and a carry up) when
    that is above 2^(c-1). The top window takes the last carry."""
    dev = scalars.device
    flat = scalars.reshape(16, -1, scalars.shape[-1]).to(torch.int32)
    nwin = -(-255 // c)
    half, mask = 1 << (c - 1), (1 << c) - 1
    # every window's c bits at once, from the two limbs under it (the one
    # past the top is zero): (nwin, lanes, n)
    k = torch.tensor([w * c // 16 for w in range(nwin)], device=dev)
    off = torch.tensor([w * c % 16 for w in range(nwin)], dtype=torch.int32,
                       device=dev)[:, None, None]
    pad = torch.cat([flat, torch.zeros_like(flat[:1])])
    bits = (((pad.index_select(0, k) | (pad.index_select(0, k + 1) << 16))
             >> off) & mask)
    carry = torch.zeros_like(bits[0])
    for w in range(nwin):
        v = bits[w] + carry
        carry = (v > half).to(torch.int32)
        bits[w] = v - (carry << c)
    return bits.transpose(0, 1)


def segments(counts, first, run):
    """Cut each segment s (counts[s] consecutive elements from first[s])
    into runs of at most run (an int, or run[s] a segment): (the runs'
    starts, their ends, their segments, the runs of each segment), on
    counts' device."""
    nr = (counts + run - 1) // run
    like = dict(device=counts.device, dtype=torch.int32)
    seg = torch.repeat_interleave(torch.arange(len(counts), **like), nr,
                                  output_size=int(nr.sum()))
    k = torch.arange(len(seg), **like) - torch.repeat_interleave(
        torch.cumsum(nr, 0, dtype=torch.int32) - nr, nr, output_size=len(seg))
    if torch.is_tensor(run):
        run = run.index_select(0, seg)
    start = first.index_select(0, seg) + k * run
    stop = torch.minimum(start + run,
                         (first + counts).index_select(0, seg))
    return start, stop, seg, nr


def _clamp_div(n, by, lo, hi):
    return max(lo, min(hi, -(-n // by)))


MONT = object()                 # execute's points, in a step's arguments
_SYMBOLS = {"pzk_msm_round": "msm_round_kernel",
            "pzk_msm_sum": "msm_sum_kernel",
            "pzk_msm_reduce": "msm_reduce_kernel",
            "pzk_msm_horner": "msm_horner_kernel"}
HOST_PLAN = 1 << 12             # segments few enough to plan on the host


class Schedule:
    """An MSM's launches, from its scalars alone (16, *L, N): the window
    width, the sorted items' points (idx: 2 j + 1 for point j negated), the
    affine rounds' pairs, the runs of each pass, the reduction's groups and
    every buffer, as ``steps``, (C entry, arguments) in order, MONT where
    the points go. ``execute`` replays it on any points of the same count;
    the outputs are x and y. Index arrays are int32, the kernels' words:
    an MSM of more than MAX_ITEMS non-zero digits over its lanes, or of
    more than 2^31 buckets, raises ValueError (split its lanes)."""

    def __init__(self, scalars, g2: bool):
        self.dev = dev = scalars.device
        n = scalars.shape[-1]
        self.g2 = g2
        self.lshape = tuple(scalars.shape[1:-1])
        lanes = math.prod(self.lshape)
        self.c = c = window_bits(n)
        half = 1 << (c - 1)
        self.jw = 3 * coord_words(g2)
        i32 = dict(device=dev, dtype=torch.int32)
        d = signed_digits(scalars, c)
        self.nwin = nwin = d.shape[1]
        # items: digit d of window w of lane l at point j, d != 0: bucket
        # (l * nwin + w) * half + |d| - 1, idx 2 j + (d < 0); sorted by
        # bucket
        d = d.reshape(lanes * nwin, n)
        nz = torch.nonzero(d.reshape(-1)).squeeze(1)
        if len(nz) > MAX_ITEMS or lanes * nwin * half > 1 << 31:
            raise ValueError(
                f"msm: {len(nz)} non-zero digits in {lanes * nwin * half} "
                f"buckets over {lanes} lanes, more than the int32 plan holds "
                f"({MAX_ITEMS} digits, 2^31 buckets): split the lanes")
        lw = torch.arange(lanes * nwin, **i32)
        key, order = torch.sort(
            (lw[:, None] * half + d.abs() - 1).reshape(-1).index_select(0, nz))
        j2 = torch.arange(0, 2 * n, 2, **i32)
        idx = (j2[None, :] | (d < 0)).reshape(-1).index_select(
            0, nz.index_select(0, order))
        del d, nz, order
        self.items = len(key)
        ids, counts = torch.unique_consecutive(key, return_counts=True)
        del key
        self.nonempty = nb = len(ids)
        self.steps = []
        # rounds of affine pair adds: round 0 always (it gathers and negates
        # the items' points), a later one while it holds ROUND_MIN_ADDS.
        # Slot t of bucket b, i = t - out_first[b], sums elements a and a + 1
        # from a = first[b] + 2 i (src = 2 a + 1), but the last slot of a
        # bucket of odd count takes a alone (src = 2 a).
        m = counts.to(torch.int32)
        first, cur, bufs = torch.cumsum(m, 0, dtype=torch.int32) - m, None, []
        adds = int((m // 2).sum())
        while nb and (cur is None or adds >= ROUND_MIN_ADDS):
            mo = (m + 1) // 2
            nout, adds = torch.stack([mo.sum(), (mo // 2).sum()]).tolist()
            out_first = torch.cumsum(mo, 0, dtype=torch.int32) - mo
            src = torch.repeat_interleave(2 * first - 4 * out_first + 1, mo,
                                          output_size=nout)
            src += torch.arange(0, 4 * nout, 4, **i32)
            src.index_put_((out_first + mo - 1,), -(m & 1), accumulate=True)
            if len(bufs) < 2:
                bufs.append(torch.empty((nout, 2 * coord_words(g2)), **i32))
            out = bufs[len(self.steps) % 2][:nout]
            per = _clamp_div(nout, ROUND_THREADS, PER_MIN, PER_MAX)
            self.steps.append(("pzk_msm_round", [
                MONT if cur is None else None, idx if cur is None else None,
                cur, src, nout, per, out]))
            m, first, cur = mo, out_first, out
        self.rounds = len(self.steps)
        # runs of what is left of each bucket, until one a bucket
        self.buckets = torch.empty((nb, self.jw), **i32)
        if nb:
            self._passes(cur, 1, m, first, torch.arange(nb, **i32),
                         self.buckets)
        # groups of GROUP non-empty buckets of a lane-window that holds at
        # least half the digits up to its largest (the running sum's steps
        # then mostly one add), of one bucket in a sparser one (its digit's
        # double-and-add alone, every bucket in parallel), weighted by their
        # digits; the groups' sums joined a lane-window
        self.wsum = torch.zeros((lanes * nwin, self.jw), **i32)
        if nb:
            dig = ids % half + 1
            lw, per_lw = torch.unique_consecutive(ids // half,
                                                  return_counts=True)
            lw, per_lw, top = (t.to(torch.int32).cpu() for t in (
                lw, per_lw, dig.index_select(0, torch.cumsum(per_lw, 0) - 1)))
            start, _, seg, ng = segments(
                per_lw, torch.cumsum(per_lw, 0, dtype=torch.int32) - per_lw,
                torch.where(2 * per_lw >= top, GROUP, 1).to(torch.int32))
            self._passes(*self._step(
                "pzk_msm_reduce", [self.buckets, dig],
                [torch.cat([start, start.new_tensor([nb])])], lw, seg, ng,
                self.wsum), self.wsum)
        coord = (16, 2) if g2 else (16,)
        self.x = torch.empty(coord + (lanes,), dtype=torch.int64, device=dev)
        self.y = torch.empty_like(self.x)
        self.steps.append(("pzk_msm_horner", [self.wsum, nwin, c, lanes,
                                              self.x, self.y]))
        self.passes = sum(e == "pzk_msm_sum" for e, _ in self.steps)

    def _step(self, entry, head, cols, dest, seg, nr, last):
        """Append a pass's launch over the runs (or groups) of segments seg:
        its arguments head, then the index arrays cols (on the host when
        planned there: one upload with the dests), then the dests; those
        of a segment with one run write its point to last[dest] (dest[s]
        for segment s), the others their partial sums to a new buffer,
        returned with what ``_passes`` takes of the segments that need
        more."""
        one = nr.index_select(0, seg) == 1
        out = None if bool(one.all()) else torch.empty(
            (len(seg), self.jw), dtype=torch.int32, device=self.dev)
        cols = cols + [torch.where(one, dest.index_select(0, seg), -1)]
        if cols[0].device != self.dev:
            cols = list(torch.cat(cols).to(self.dev).split(
                [len(c) for c in cols]))
        self.steps.append((entry, head + cols + [len(seg), out, last]))
        more = torch.nonzero(nr > 1).squeeze(1)
        return (out, 0, nr.index_select(0, more), (torch.cumsum(
            nr, 0, dtype=torch.int32) - nr).index_select(0, more),
            dest.index_select(0, more))

    def _passes(self, cur, aff, counts, first, dest, last):
        """Passes of runs over cur (affine, aff, or Jacobian elements),
        segments of counts consecutive elements from first, until each
        segment's sum is at last[dest]; a segment leaves the passes once
        it is. Few segments are planned on the host."""
        while len(counts):
            if counts.is_cuda and len(counts) <= HOST_PLAN:
                counts, first, dest = torch.stack(
                    [counts, first, dest]).cpu()
            run = _clamp_div(int(counts.sum()), RUN_THREADS, RUN_MIN, RUN_MAX)
            start, stop, seg, nr = segments(counts, first, run)
            cur, aff, counts, first, dest = self._step(
                "pzk_msm_sum", [cur, aff], [start, stop], dest, seg, nr, last)

    def symbols(self):
        """The kernels one ``execute`` launches, in order."""
        return [_SYMBOLS[e] for e, _ in self.steps]


def execute(sched: Schedule, mont, call):
    """Launch sched's kernels over the points mont (``points``' words)
    through call(entry, *args) (a C entry of csrc/msm.cu and its
    arguments, tensors as they are); returns affine normal-form limbs (x,
    y), (16[, 2], *L). The window sums that no step writes stay infinity
    (the zeros of their allocation), so a schedule may run again."""
    for entry, args in sched.steps:
        call(entry, int(sched.g2), *(mont if a is MONT else a for a in args))
    coord = tuple(sched.x.shape[:-1])
    return (sched.x.reshape(coord + sched.lshape),
            sched.y.reshape(coord + sched.lshape))


def cuda_call(name, like):
    """``execute``'s call on the card: each C entry launched through
    ``cuda_build.launch`` on like's device and stream."""
    def call(entry, *args):
        cuda_build.launch(name, entry, like, *(
            a.data_ptr() if torch.is_tensor(a) else a for a in args))
    return call


def _run(name, px, py, scalars, curve, mont):
    g2 = curve == "bn254_g2"
    if px is None and py is None and mont is not None and scalars.is_cuda:
        n = mont.shape[0]               # a key's points, words only
    else:
        _check_points(name, px, py, g2)
        n = px.shape[-1]
    if scalars.shape[0] != 16 or scalars.shape[-1] != n:
        raise ValueError(f"{name}: scalars must be (16, *L, {n}), got "
                         f"{tuple(scalars.shape)}")
    if not scalars.is_cuda:
        return _msm.msm_affine(px, py, scalars, curve)
    for t in (px, py, scalars):
        if t is None:
            continue
        if not t.is_cuda or t.device != scalars.device:
            raise ValueError(f"{name}: all tensors must be on "
                             f"{scalars.device}")
        if t.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64, got {t.dtype}")
    if mont is None:
        mont = points(px, py, curve)
    if mont.shape != (n, 2 * coord_words(g2)) or \
            mont.dtype != torch.int32 or not mont.is_contiguous() or \
            mont.device != scalars.device:
        raise ValueError(f"{name}: mont must be points(px, py) on "
                         f"{scalars.device}, got {tuple(mont.shape)} "
                         f"{mont.dtype}")
    return execute(Schedule(scalars, g2), mont, cuda_call(name, scalars))


def msm_g1(px, py, scalars, mont=None):
    """sum_j scalars[..., j] (px[:, j], py[:, j]) over G1, affine (x, y),
    each (16, *L). mont: ``points(px, py)`` made beforehand (a key's); on
    a card px and py may then be None (a key keeps only mont there)."""
    out = _run("msm_g1", px, py, scalars, "bn254_g1", mont)
    if scalars.is_cuda:
        msm_g1.launches += 1
    return out


msm_g1.launches = 0


def msm_g2(px, py, scalars, mont=None):
    """The same over G2: px, py (16, 2, N); (x, y) each (16, 2, *L)."""
    out = _run("msm_g2", px, py, scalars, "bn254_g2", mont)
    if scalars.is_cuda:
        msm_g2.launches += 1
    return out


msm_g2.launches = 0


def msm_affine(px, py, scalars, curve: str = "bn254_g1", mont=None):
    """``msm_g1`` or ``msm_g2`` by curve, as ``ops/msm.msm_affine``."""
    fn = msm_g2 if curve == "bn254_g2" else msm_g1
    return fn(px, py, scalars, mont=mont)
