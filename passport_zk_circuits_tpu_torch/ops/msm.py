"""Multi-scalar multiplication over BN254 G1 and G2, plain PyTorch: the
Groth16 prover's core.

Counterpart of ``passport_zk_circuits_tpu/ops/msm.py`` (XLA code there: no
Pallas kernel reaches it), with the same decomposition into 4-bit windows,

    sum_j s_j P_j  =  sum_w 2^{4w} S_w,       S_w = sum_j T_j[d_{j,w}],

but ordered for a device that PyTorch drives one kernel launch at a time:

* per point, ONE 16-entry table T_j (7 doublings and 7 adds over the
  point axis), shared by every window and every proof lane;
* the table entries of a group of windows are picked at once with an
  integer ``index_select`` (no float matmul: a TF32 or bf16 pass would
  truncate 16-bit limbs), and the point axis of the whole group is summed
  by a pairwise tree; the groups' partial trees join once they are short
  enough, so the late, narrow levels run once for all 64 windows;
* ONE Horner chain of 4 doublings and an add a window (252 doublings in
  all) after every window sum is known; ``chain_affine`` takes window
  sums of several MSMs on the lane axis, so a prover runs one chain for
  all of its G1 MSMs. The chain works on a few points only, so each of
  its ~150,000 ops (G1; ~300,000 over G2) is a launch of a tiny kernel:
  on a card ``chain_affine`` captures the chain and the affine
  conversion once per (curve, shape, device) as a CUDA graph and replays
  it (the same ops, one launch from the host).

A group holds as many windows as keep the first tree level's operands
within ``BUDGET[curve]`` points (each point of a G1 unified add holds
about 32 KB of int64 temporaries at its peak, a G2 one about 96 KB), and
the table is built ``BUDGET[curve]`` points at a time. The
MSM's value is a unique point, so its affine coordinates equal the JAX
package's whatever the order of the additions. G2 runs the same code over
``ops/g2.G2Ctx``: the formulas touch the field only through the ctx.
"""

from __future__ import annotations

import functools
import math

import torch

from . import g2 as _g2
from . import weierstrass as wst

WINDOW = 4
BUDGET = {"bn254_g1": 1 << 19, "bn254_g2": 1 << 18}


def _ctx(curve: str):
    return _g2.ctx() if curve == "bn254_g2" else wst.ctx(curve)


def _table(c, px, py):
    """T[d] = [d]P for d = 0..15, Jacobian, batched over the trailing point
    axis: px, py (k[, 2], N) affine -> (16, k[, 2], 3, N). T[2i] doubles
    T[i], T[2i+1] adds P to T[2i]."""
    one = c.const_like(1, px).expand(px.shape)
    p1 = c.stack(px, py, one)
    tbl = [wst.infinity_like(c, px), p1]
    for d in range(2, 1 << WINDOW):
        tbl.append(wst.jac_double(c, tbl[d // 2]) if d % 2 == 0
                   else wst.jac_add(c, tbl[d - 1], p1))
    return torch.stack(tbl)


def _digits(scalars):
    """(kn, *L, N) 16-bit limbs -> (kn * 4, *L, N) 4-bit digits, MSB
    first."""
    sh = torch.tensor([12, 8, 4, 0], device=scalars.device).reshape(
        (1, 4) + (1,) * (scalars.dim() - 1))
    d = (scalars.flip(0).unsqueeze(1) >> sh) & 0xF
    return d.reshape((-1,) + tuple(scalars.shape[1:]))


def _halve(c, t):
    """One level of the pairwise tree over the last (point) axis: m points
    -> ceil(m / 2); an odd last point is carried up."""
    m = t.shape[-1]
    h = m // 2
    s = wst.jac_add(c, t[..., :h], t[..., h:2 * h])
    return s if m % 2 == 0 else torch.cat([s, t[..., 2 * h:]], -1)


def window_group(curve: str, nwin: int, lanes: int, n: int) -> int:
    """Windows a group of ``window_sums`` holds for an MSM of n points and
    `lanes` proof lanes: as many as keep the first tree level's operands
    within ``BUDGET[curve]`` points."""
    return max(1, min(nwin, BUDGET[curve] // (lanes * max(1, n // 2))))


def window_sums(px, py, scalars, curve: str = "bn254_g1"):
    """S_w = sum_j T_j[d_{j,w}] for every window w: px, py (k[, 2], N)
    affine limbs on a device, scalars (kn, *L, N) -> Jacobian points
    (k[, 2], 3, nwin, *L), windows MSB first."""
    c = _ctx(curve)
    budget = BUDGET[curve]
    n = px.shape[-1]
    lshape = tuple(scalars.shape[1:-1])
    lanes = math.prod(lshape)
    digs = _digits(scalars)                             # (nwin, *L, N)
    nwin = digs.shape[0]
    # the table's adds take at most `budget` points at a time, as the
    # tree's first level does
    tbl = torch.cat([_table(c, px[..., lo:lo + budget],
                            py[..., lo:lo + budget])
                     for lo in range(0, n, budget)], -1)  # (16, F.., N)
    coord = tuple(tbl.shape[1:-1])                      # (k[, 2], 3)
    flat = tbl.reshape(16, -1, n).transpose(0, 1).reshape(-1, 16 * n)
    del tbl
    col = torch.arange(n, device=px.device)
    group = window_group(curve, nwin, lanes, n)
    parts = []
    for w0 in range(0, nwin, group):
        d = digs[w0:w0 + group]
        t = flat.index_select(1, (d * n + col).reshape(-1))
        t = t.reshape(coord + tuple(d.shape))           # (F.., g, *L, N)
        # until every window's partial tree fits the budget at once
        while t.shape[-1] > 1 and nwin * lanes * (t.shape[-1] // 2) > budget:
            t = _halve(c, t)
        parts.append(t)
    t = torch.cat(parts, len(coord)) if len(parts) > 1 else parts[0]
    while t.shape[-1] > 1:
        t = _halve(c, t)
    return t[..., 0]


def horner(sums, curve: str = "bn254_g1"):
    """sum_w 2^{4 (nwin - 1 - w)} S_w for window sums (k[, 2], 3, nwin,
    *L) (MSB first) -> Jacobian points (k[, 2], 3, *L)."""
    c = _ctx(curve)
    wax = c.ax + 1
    acc = sums.select(wax, 0)
    for w in range(1, sums.shape[wax]):
        for _ in range(WINDOW):
            acc = wst.jac_double(c, acc)
        acc = wst.jac_add(c, acc, sums.select(wax, w))
    return acc


def _chain_affine(sums, curve):
    c = _ctx(curve)
    return torch.stack(wst.to_affine(c, horner(sums, curve)))


class _CapturedChain:
    """``_chain_affine`` on window sums of one shape, captured as a CUDA
    graph: the input is copied into a static buffer, the graph replayed,
    its static output copied out."""

    def __init__(self, curve: str, shape, device: torch.device):
        self.inp = torch.zeros(shape, dtype=torch.int64, device=device)
        # make the cached constants (host -> device copies, not allowed in
        # a capture) with a two-window chain of the same ranks
        _chain_affine(self.inp.narrow(_ctx(curve).ax + 1, 0, 2), curve)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _chain_affine(self.inp, curve)

    def __call__(self, sums):
        self.inp.copy_(sums)
        self.graph.replay()
        return self.out.clone()


@functools.lru_cache(maxsize=16)
def _captured(curve: str, shape, device: torch.device) -> _CapturedChain:
    return _CapturedChain(curve, shape, device)


def chain_affine(sums, curve: str = "bn254_g1"):
    """to_affine(horner(sums)): window sums (k[, 2], 3, nwin, *L) ->
    stacked affine (x, y), (2, k[, 2], *L), infinity -> zeros. On a CUDA
    device through the chain's CUDA graph (captured on the first call of a
    shape), elsewhere op by op."""
    if sums.device.type != "cuda":
        return _chain_affine(sums, curve)
    return _captured(curve, tuple(sums.shape), sums.device)(sums)


def msm(px, py, scalars, curve: str = "bn254_g1"):
    """sum_j scalars[..., j] * (px[..., j], py[..., j]), Jacobian out.

    px, py: (k, N) affine limbs (G1) or (k, 2, N) (G2, curve="bn254_g2"),
    int64 on a device; scalars: (kn, *L, N), where *L is an optional
    proof-lane axis sharing the one point table. Any N. Returns a Jacobian
    point (k[, 2], 3, *L)."""
    return horner(window_sums(px, py, scalars, curve), curve)


def msm_affine(px, py, scalars, curve: str = "bn254_g1"):
    """msm + to_affine: (x, y), each (k[, 2], *L); infinity -> zeros."""
    x, y = chain_affine(window_sums(px, py, scalars, curve), curve)
    return x, y
