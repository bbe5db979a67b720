"""Batched short-Weierstrass point arithmetic over the registry curves.

Counterpart of ``passport_zk_circuits_tpu/ops/weierstrass.py``, plain
PyTorch (the JAX module is XLA code: no Pallas kernel reaches it). The same
formulas, so every coordinate equals the JAX package's:

  * a point is one (k, 3, *B) tensor of Jacobian (X, Y, Z), infinity =
    (1, 1, 0); the unified addition computes the add and the double
    paths and selects per lane;
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
    order's arithmetic (``self.fn``) and const_like."""

    def __init__(self, curve: Curve):
        self.curve = curve
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

    def n_limbs(self, like):
        return bn.cached_const(self.curve.n, self.kn, like.device,
                               like.dim())


@functools.lru_cache(maxsize=None)
def ctx(name: str) -> CurveCtx:
    return CurveCtx(CURVES[name])


def _st(*xs):
    """Stack (k, *B) field values on a new axis 1: one grouped operand."""
    return torch.stack(xs, 1)


def point(x, y, z):
    """(k, *B) coordinates -> a (k, 3, *B) point."""
    return _st(x, y, z)


def infinity_like(c: CurveCtx, tmpl):
    """(1, 1, 0) as a (k, 3, *B) point shaped like the (k, *B) tmpl."""
    one = c.const_like(1, tmpl).expand(tmpl.shape)
    return _st(one, one, torch.zeros_like(tmpl))


def is_inf(P):
    return bn.is_zero(P[:, 2])


def jac_double(c: CurveCtx, P):
    """2P in Jacobian coordinates (general a)."""
    X, Y, Z = P.unbind(1)
    XX, YY, ZZ = c.sqr(P).unbind(1)
    YYYY, XYY, ZZZZ = c.mul(_st(YY, X, ZZ), _st(YY, YY, ZZ)).unbind(1)
    aZ4 = c.mul(c.const_like(c.curve.a, ZZZZ), ZZZZ)
    # 2XY^2, 2X^2, 2Y^4, 2Y; then 4XY^2 = S, 3X^2, 4Y^4; then M, 2S, 8Y^4
    S2, XX2, Y4x2, Yx2 = c.add(_st(XYY, XX, YYYY, Y),
                               _st(XYY, XX, YYYY, Y)).unbind(1)
    S, M0, Y4x4 = c.add(_st(S2, XX2, Y4x2), _st(S2, XX, Y4x2)).unbind(1)
    M, S8, Y8 = c.add(_st(M0, S, Y4x4), _st(aZ4, S, Y4x4)).unbind(1)
    MM, Z3 = c.mul(_st(M, Yx2), _st(M, Z)).unbind(1)       # M^2, 2Y Z
    X3 = c.sub(MM, S8)
    Y3 = c.sub(c.mul(M, c.sub(S, X3)), Y8)
    return point(X3, Y3, Z3)


def jac_add(c: CurveCtx, P, Q):
    """Unified P + Q handling P == Q, P == -Q and infinities via selects:
    the add and P's doubling are both computed on every lane, with no
    branch on the data, as in the JAX package."""
    X1, Y1, Z1 = P.unbind(1)
    X2, Y2, Z2 = Q.unbind(1)
    Z1Z1, Z2Z2, Y1Z2, Y2Z1 = c.mul(_st(Z1, Z2, Y1, Y2),
                                   _st(Z1, Z2, Z2, Z1)).unbind(1)
    U1, U2, S1, S2 = c.mul(_st(X1, X2, Y1Z2, Y2Z1),
                           _st(Z2Z2, Z1Z1, Z2Z2, Z1Z1)).unbind(1)
    HR = c.sub(_st(U2, S2), _st(U1, S1))
    H, R = HR.unbind(1)
    HH, RR, Z1Z2 = c.mul(_st(H, R, Z1), _st(H, R, Z2)).unbind(1)
    HHH, V, Z3 = c.mul(_st(H, U1, Z1Z2), _st(HH, HH, H)).unbind(1)
    X3 = c.sub(c.sub(RR, HHH), c.add(V, V))
    RW, S1HHH = c.mul(_st(R, S1), _st(c.sub(V, X3), HHH)).unbind(1)
    res = point(X3, c.sub(RW, S1HHH), Z3)

    x_eq, y_eq = (HR == 0).all(0).unbind(0)
    res = torch.where(x_eq & y_eq, jac_double(c, P), res)
    res = torch.where(x_eq & ~y_eq, infinity_like(c, X1), res)
    res = torch.where(is_inf(P), Q, res)
    return torch.where(is_inf(Q), P, res)


def jac_add_affine(c: CurveCtx, P, qx, qy, q_is_inf):
    """Mixed addition with an affine point (Z2 = 1)."""
    one = c.const_like(1, qx).expand(qx.shape)
    return torch.where(q_is_inf, P, jac_add(c, P, point(qx, qy, one)))


def to_affine(c: CurveCtx, P):
    """Jacobian -> affine (x, y) with one Fermat inversion; infinity ->
    (0, 0)."""
    X, Y, Z = P.unbind(1)
    zi = c.inv(Z)
    zi2 = c.sqr(zi)
    x, zi3 = c.mul(_st(X, zi), _st(zi2, zi2)).unbind(1)
    y = c.mul(Y, zi3)
    inf = is_inf(P)
    return (torch.where(inf, torch.zeros_like(x), x),
            torch.where(inf, torch.zeros_like(y), y))


def scalar_mul_window(c: CurveCtx, scalar_limbs, qx, qy):
    """Per-instance-point scalar mult, 4-bit windows MSB-first.
    scalar_limbs: (kn, *B) limbs of the scalar; (qx, qy): affine point
    (k, *B). Returns a Jacobian (k, 3, *B) point."""
    nwin = c.kn * 4
    one = c.const_like(1, qx).expand(qx.shape)
    base = point(qx, qy, one)
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
    """Stride-8 fixed-base tables of the curve on `device`, loaded once:
    table[w, j] = (j * 2^(8w)) * G affine for j = 0..255 (j = 0 stored as
    (0, 0) with its infinity flag). Returns x and y as (nwin, k, 256) int64
    and the flags as (nwin, 256) bool. A missing table file raises: the
    port reads the copies in ``utils/constants`` and writes none."""
    path = CONST_DIR / f"fixed_base_{name}.npz"
    if not path.exists():
        raise FileNotFoundError(f"no fixed-base table for {name}: {path}")
    with np.load(path) as d:
        xs, ys, infs = d["x"], d["y"], d["inf"]
    return (bn.to_tensor(xs.transpose(0, 2, 1), device),
            bn.to_tensor(ys.transpose(0, 2, 1), device),
            torch.as_tensor(infs, device=device))


def fixed_base_mul(c: CurveCtx, scalar_limbs):
    """scalar * G through the stride-8 tables, one mixed add a byte window.
    scalar_limbs: (kn, B). Returns a Jacobian (k, 3, B) point."""
    xs, ys, infs = fixed_base_table(c.curve.name, scalar_limbs.device)
    nwin = xs.shape[0]
    # byte w of the scalar (little-endian): limb w // 2, half w % 2
    bytes_ = torch.stack([scalar_limbs & 0xFF, scalar_limbs >> 8], 1)
    bytes_ = bytes_.reshape((-1,) + tuple(scalar_limbs.shape[1:]))[:nwin]
    acc = infinity_like(c, xs[0][:, bytes_[0]])
    for w in range(nwin):
        b = bytes_[w]
        acc = jac_add_affine(c, acc, xs[w][:, b], ys[w][:, b], infs[w][b])
    return acc
