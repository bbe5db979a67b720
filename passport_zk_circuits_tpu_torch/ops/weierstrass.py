"""Batched short-Weierstrass point arithmetic over the registry curves.

Counterpart of ``passport_zk_circuits_tpu/ops/weierstrass.py``, plain
PyTorch (the JAX module is XLA code: no Pallas kernel reaches it). The same
formulas, so every coordinate equals the JAX package's:

  * a point is one (k, 3, *B) tensor of Jacobian (X, Y, Z), infinity =
    (1, 1, 0); the unified addition computes the add and the double
    paths and selects per lane;
  * the formulas touch coordinates only through the ctx: its field ops,
    ``stack`` and ``ax`` (the coordinate axis) and ``is_zero_f`` (the zero
    test of a field element), so ``ops/g2.G2Ctx`` runs the same formulas
    over FQ2, whose elements carry a component axis after the limb axis;
  * the base field is ``bignum.StaticMod``: canonical residues, so the
    formulas' independent products share one call (stacked on the
    coordinate axis) and give the integers of one call each;
  * the per-instance scalar mult is 4-bit windowed: a 16-entry table built
    by 15 adds, then per window 4 doublings, a table select and an add;
  * the fixed-base generator mult reads the stride-8 tables
    ``utils/constants/fixed_base_<curve>.npz`` (256 entries a byte window)
    and does one mixed add per window.

``lax.scan`` becomes a Python loop and the one-hot table selects become
indexing, which yields the same integers.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from . import bignum as bn
from .curves import Curve, CURVES

CONST_DIR = pathlib.Path(__file__).parent.parent / "utils" / "constants"


class CurveCtx:
    """Static per-curve constants and the base-field helpers that the
    group formulas use: mul, sqr, add, sub, inv (mod p, ``self.fp``), the
    order's arithmetic (``self.fn``), const_like, the curve's a, and the
    layout hooks stack, ax and is_zero_f."""

    ax = 1          # a point is (k, 3, *B): its coordinate axis

    def __init__(self, curve: Curve):
        self.curve = curve
        self.a = curve.a
        self.k = bn.nlimbs_for_bits(curve.p.bit_length())
        self.kn = bn.nlimbs_for_bits(curve.n.bit_length())
        self.fp = bn.StaticMod(curve.p, self.k)
        self.fn = bn.StaticMod(curve.n, self.kn)

    def mul(self, x, y):
        return self.fp.mul(x, y)

    def sqr(self, x):
        return self.fp.mul(x, x)

    def add(self, x, y):
        return self.fp.add(x, y)

    def sub(self, x, y):
        return self.fp.sub(x, y)

    def inv(self, x):
        return self.fp.inv(x)

    def const_like(self, v: int, tmpl):
        """v mod p as (k, 1, ..) limbs broadcasting against tmpl (cached:
        never write to it)."""
        return self.fp.const_like(v, tmpl)

    def stack(self, *xs):
        """Stack (k, *B) field values on a new axis 1 (ax): one grouped
        operand, or a point."""
        return torch.stack(xs, 1)

    def is_zero_f(self, x):
        """x == 0 over the limb axis: (k, *R) -> bool (*R)."""
        return (x == 0).all(0)

    @property
    def name(self) -> str:
        return self.curve.name

    def n_limbs(self, like):
        return bn.cached_const(self.curve.n, self.kn, like.device,
                               like.dim())


@functools.lru_cache(maxsize=None)
def ctx(name: str) -> CurveCtx:
    return CurveCtx(CURVES[name])


def infinity_like(c: CurveCtx, tmpl):
    """(1, 1, 0) as a point shaped like the field value tmpl ((k, *B):
    a (k, 3, *B) point)."""
    one = c.const_like(1, tmpl).expand(tmpl.shape)
    return c.stack(one, one, torch.zeros_like(tmpl))


def is_inf(c: CurveCtx, P):
    return c.is_zero_f(P.select(c.ax, 2))


def jac_double(c: CurveCtx, P):
    """2P in Jacobian coordinates (general a)."""
    st, ax = c.stack, c.ax
    X, Y, Z = P.unbind(ax)
    XX, YY, ZZ = c.sqr(P).unbind(ax)
    YYYY, XYY, ZZZZ = c.mul(st(YY, X, ZZ), st(YY, YY, ZZ)).unbind(ax)
    aZ4 = c.mul(c.const_like(c.a, ZZZZ), ZZZZ)
    # 2XY^2, 2X^2, 2Y^4, 2Y; then 4XY^2 = S, 3X^2, 4Y^4; then M, 2S, 8Y^4
    S2, XX2, Y4x2, Yx2 = c.add(st(XYY, XX, YYYY, Y),
                               st(XYY, XX, YYYY, Y)).unbind(ax)
    S, M0, Y4x4 = c.add(st(S2, XX2, Y4x2), st(S2, XX, Y4x2)).unbind(ax)
    M, S8, Y8 = c.add(st(M0, S, Y4x4), st(aZ4, S, Y4x4)).unbind(ax)
    MM, Z3 = c.mul(st(M, Yx2), st(M, Z)).unbind(ax)       # M^2, 2Y Z
    X3 = c.sub(MM, S8)
    Y3 = c.sub(c.mul(M, c.sub(S, X3)), Y8)
    return st(X3, Y3, Z3)


def jac_add(c: CurveCtx, P, Q):
    """Unified P + Q handling P == Q, P == -Q and infinities via selects:
    the add and P's doubling are both computed on every lane, with no
    branch on the data, as in the JAX package. The doubling, inverse and
    infinity cases are told by the ctx's zero test."""
    st, ax = c.stack, c.ax
    X1, Y1, Z1 = P.unbind(ax)
    X2, Y2, Z2 = Q.unbind(ax)
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = c.mul(st(Z1, Z2, Y1, Y2),
                                   st(Z1, Z2, Z2, Z1)).unbind(ax)
    U1, U2, S1, S2 = c.mul(st(X1, X2, Y1Z2, Y2Z1),
                           st(Z2Z2, Z1Z1, Z2Z2, Z1Z1)).unbind(ax)
    HR = c.sub(st(U2, S2), st(U1, S1))
    H, R = HR.unbind(ax)
    HH, RR, Z1Z2 = c.mul(st(H, R, Z1), st(H, R, Z2)).unbind(ax)
    HHH, V, Z3 = c.mul(st(H, U1, Z1Z2), st(HH, HH, H)).unbind(ax)
    X3 = c.sub(c.sub(RR, HHH), c.add(V, V))
    RW, S1HHH = c.mul(st(R, S1), st(c.sub(V, X3), HHH)).unbind(ax)
    res = st(X3, c.sub(RW, S1HHH), Z3)

    x_eq, y_eq = c.is_zero_f(HR).unbind(0)
    res = torch.where(x_eq & y_eq, jac_double(c, P), res)
    res = torch.where(x_eq & ~y_eq, infinity_like(c, X1), res)
    res = torch.where(is_inf(c, P), Q, res)
    return torch.where(is_inf(c, Q), P, res)


def jac_add_affine(c: CurveCtx, P, qx, qy, q_is_inf):
    """Mixed addition with an affine point (Z2 = 1)."""
    one = c.const_like(1, qx).expand(qx.shape)
    return torch.where(q_is_inf, P, jac_add(c, P, c.stack(qx, qy, one)))


def to_affine(c: CurveCtx, P):
    """Jacobian -> affine (x, y) with one Fermat inversion; infinity ->
    (0, 0)."""
    X, Y, Z = P.unbind(c.ax)
    zi = c.inv(Z)
    zi2 = c.sqr(zi)
    x, zi3 = c.mul(c.stack(X, zi), c.stack(zi2, zi2)).unbind(c.ax)
    y = c.mul(Y, zi3)
    inf = is_inf(c, P)
    return (torch.where(inf, torch.zeros_like(x), x),
            torch.where(inf, torch.zeros_like(y), y))


def scalar_mul_window(c: CurveCtx, scalar_limbs, qx, qy):
    """Per-instance-point scalar mult, 4-bit windows MSB-first.
    scalar_limbs: (kn, *B) limbs of the scalar; (qx, qy): affine point
    (k, *B). Returns a Jacobian (k, 3, *B) point."""
    nwin = c.kn * 4
    one = c.const_like(1, qx).expand(qx.shape)
    base = c.stack(qx, qy, one)
    acc = infinity_like(c, qx)
    table = [acc]                                  # table[i] = i*Q
    for _ in range(15):
        acc = jac_add(c, acc, base)
        table.append(acc)
    table = torch.stack(table)                     # (16, k, 3, *B)

    # window values MSB-first: limb (kn-1-w//4), nibble (3 - w%4)
    sh = torch.tensor([12, 8, 4, 0], device=qx.device).reshape(
        (1, 4) + (1,) * (qx.dim() - 1))
    wins = ((scalar_limbs.flip(0).unsqueeze(1) >> sh) & 0xF).reshape(
        (nwin,) + tuple(qx.shape[1:]))

    acc = infinity_like(c, qx)
    for w in range(nwin):
        for _ in range(4):
            acc = jac_double(c, acc)
        idx = wins[w].reshape((1, 1, 1) + tuple(qx.shape[1:]))
        acc = jac_add(c, acc, torch.gather(
            table, 0, idx.expand((1,) + table.shape[1:]))[0])
    return acc


@functools.lru_cache(maxsize=None)
def fixed_base_table(name: str, device: torch.device):
    """Stride-8 fixed-base tables of the curve (or ``bn254_g2``) on
    `device`, loaded once: table[w, j] = (j * 2^(8w)) * G affine for
    j = 0..255 (j = 0 stored as (0, 0) with its infinity flag). Returns x
    and y as (nwin, k[, 2], 256) int64 and the flags as (nwin, 256) bool.
    A missing table file raises: the port reads the copies in
    ``utils/constants`` and writes none."""
    path = CONST_DIR / f"fixed_base_{name}.npz"
    if not path.exists():
        raise FileNotFoundError(f"no fixed-base table for {name}: {path}")
    with np.load(path) as d:
        xs, ys, infs = d["x"], d["y"], d["inf"]
    return (bn.to_tensor(np.moveaxis(xs, 1, -1), device),
            bn.to_tensor(np.moveaxis(ys, 1, -1), device),
            torch.as_tensor(infs, device=device))


def fixed_base_mul(c, scalar_limbs):
    """scalar * G through the stride-8 tables of the ctx's curve (G1 or,
    with ``g2.G2Ctx``, the twist), one mixed add a byte window, the table
    entries picked by integer indexing. scalar_limbs: (kn, B). Returns a
    Jacobian (k[, 2], 3, B) point."""
    xs, ys, infs = fixed_base_table(c.name, scalar_limbs.device)
    nwin = xs.shape[0]
    # byte w of the scalar (little-endian): limb w // 2, half w % 2
    bytes_ = torch.stack([scalar_limbs & 0xFF, scalar_limbs >> 8], 1)
    bytes_ = bytes_.reshape((-1,) + tuple(scalar_limbs.shape[1:]))[:nwin]
    acc = infinity_like(c, xs[0][..., bytes_[0]])
    for w in range(nwin):
        b = bytes_[w]
        acc = jac_add_affine(c, acc, xs[w][..., b], ys[w][..., b],
                             infs[w][b])
    return acc
