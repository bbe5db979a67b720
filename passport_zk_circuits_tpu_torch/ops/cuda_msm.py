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
window is one 16-bit limb of the scalar; the (lane, window, digit, point)
items with a non-zero digit are sorted by bucket with ``torch.sort``; runs
of at most ``RUN`` items of a bucket go to one thread each, and the pass
repeats over the partial sums until every bucket has one; then the
buckets' running sums, the windows and the lanes' Horner chains. Every
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

C = 16                      # window bits: a window's digit is a scalar limb
NWIN = 16
NBUCKET = 1 << C
RUN = 32                    # items a thread adds
SEG = 256                   # buckets a thread of the window pass sums
NSEG = NBUCKET // SEG
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


def runs(key):
    """One pass's runs over items sorted by bucket (key): each bucket's
    items cut into runs of at most RUN. Returns (start, len, the index in
    buckets of each run's bucket, the buckets)."""
    buckets, counts = torch.unique_consecutive(key, return_counts=True)
    nruns = (counts + RUN - 1) // RUN
    run_bucket = torch.repeat_interleave(
        torch.arange(len(buckets), device=key.device), nruns)
    first_run = torch.cumsum(nruns, 0) - nruns
    k = (torch.arange(len(run_bucket), device=key.device)
         - first_run[run_bucket])
    first_item = torch.cumsum(counts, 0) - counts
    start = first_item[run_bucket] + k * RUN
    length = torch.clamp(counts[run_bucket] - k * RUN, max=RUN)
    return start, length, run_bucket, buckets


class Schedule:
    """An MSM's launches, from its scalars alone: the sorted items' points
    (idx), each pass's runs (start, len, dest, out) and the buffers of the
    window, combine and Horner kernels. ``execute`` replays it on any
    points of the same count; the outputs are x and y."""

    def __init__(self, scalars, g2: bool):
        dev = scalars.device
        n = scalars.shape[-1]
        self.g2 = g2
        self.lshape = tuple(scalars.shape[1:-1])
        lanes = math.prod(self.lshape)
        jw = 3 * coord_words(g2)
        # items: digit d of window w of lane l at point j, d != 0; flat
        # index (l * NWIN + w) * n + j; bucket (l * NWIN + w) * NBUCKET + d
        flat = scalars.reshape(NWIN, lanes, n).transpose(0, 1).reshape(-1)
        nz = torch.nonzero(flat).squeeze(1)
        key, order = torch.sort(
            torch.div(nz, n, rounding_mode="floor") * NBUCKET + flat[nz])
        self.items = len(key)
        self.idx = nz[order] % n
        del flat, nz, order
        self.buckets = torch.zeros((lanes * NWIN * NBUCKET, jw),
                                   dtype=torch.int32, device=dev)
        self.passes = []
        while key.numel():
            start, length, run_bucket, ids = runs(key)
            final = len(run_bucket) == len(ids)
            out = self.buckets if final else torch.empty(
                (len(run_bucket), jw), dtype=torch.int32, device=dev)
            dest = ids if final else torch.arange(len(run_bucket), device=dev)
            self.passes.append((start, length, dest, out))
            if final:
                self.nonempty = len(ids)
                break
            key = ids[run_bucket]
        if not self.passes:
            self.nonempty = 0
        self.s = torch.empty((lanes * NWIN * NSEG, jw), dtype=torch.int32,
                             device=dev)
        self.t = torch.empty_like(self.s)
        self.wsum = torch.empty((lanes * NWIN, jw), dtype=torch.int32,
                                device=dev)
        coord = (16, 2) if g2 else (16,)
        self.x = torch.empty(coord + (lanes,), dtype=torch.int64, device=dev)
        self.y = torch.empty_like(self.x)

    def symbols(self):
        """The kernels one ``execute`` launches, in order."""
        return (["msm_sum_kernel"] * len(self.passes)
                + ["msm_window_kernel", "msm_combine_kernel",
                   "msm_horner_kernel"])


def execute(sched: Schedule, mont, call):
    """Launch sched's kernels over the points mont (``points``' words)
    through call(entry, *args) (a C entry of csrc/msm.cu and its
    arguments, tensors as they are); returns affine normal-form limbs (x,
    y), (16[, 2], *L). The buckets that no pass writes stay infinity (the
    zeros of their allocation), so a schedule may run again."""
    g2 = int(sched.g2)
    items, idx = mont, sched.idx
    for start, length, dest, out in sched.passes:
        call("pzk_msm_sum", g2, items, idx, start, length, dest, len(start),
             out)
        items, idx = out, None
    call("pzk_msm_window", g2, sched.buckets, len(sched.s), sched.s, sched.t)
    call("pzk_msm_combine", g2, sched.s, sched.t, len(sched.wsum), sched.wsum)
    call("pzk_msm_horner", g2, sched.wsum, sched.x.shape[-1], sched.x,
         sched.y)
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
