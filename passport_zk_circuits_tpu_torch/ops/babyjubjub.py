"""Batched BabyJubJub (twisted Edwards over BN254 Fr) point arithmetic.

Counterpart of ``passport_zk_circuits_tpu/ops/babyjubjub.py``: points in
extended twisted-Edwards coordinates (X:Y:Z:T), the complete unified
addition add-2008-hwcd, one Fermat inversion back to affine at the end
(``to_affine``, used by the plain versions; on the card K5's affine entry
does it).

Field tensors are (16, *B); the plain addition stacks its independent
products along the last batch axis, so one addition is three batched modmul
calls rather than eleven.
"""

from __future__ import annotations

import torch

from . import field as fr

# curve: a*x^2 + y^2 = 1 + d*x^2*y^2 over Fr
A = 168700
D = 168696

BASE8_X = 5299619240641551281634865583518297030282874472190772894086521144482721001553
BASE8_Y = 16950150798460657717958625567821834550301663161624707787222815936182638968203


def identity(batch_shape, device):
    """Identity in extended coordinates: (0, 1, 1, 0)."""
    zero = fr.const(0, batch_shape, device)
    one = fr.const(1, batch_shape, device)
    return (zero, one, one.clone(), zero.clone())


def to_extended(x, y):
    """Affine (x, y) -> extended (X, Y, Z, T) with Z = 1, T = x*y."""
    return (x, y, fr.const(1, x.shape[1:], x.device), fr.mul(x, y))


def to_affine(p):
    """Extended -> affine via one Fermat inversion of Z."""
    X, Y, Z, _ = p
    zinv = fr.inv(Z)
    return fr.mul(torch.cat([X, Y], -1), torch.cat([zinv, zinv], -1)).chunk(
        2, -1)


def add(p, q):
    """Complete unified addition (add-2008-hwcd): 9 products and 2 by the
    curve constants, as three batched modmuls."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    cat = lambda *xs: torch.cat(xs, -1)          # noqa: E731
    s1, s2 = fr.add(cat(X1, X2), cat(Y1, Y2)).chunk(2, -1)
    Aa, Bb, TT, Dd, S = fr.mul(cat(X1, Y1, T1, Z1, s1),
                               cat(X2, Y2, T2, Z2, s2)).chunk(5, -1)
    shape = Aa.shape[1:]
    Cc, aA = fr.mul(cat(TT, Aa), cat(fr.const(D, shape, Aa.device),
                                     fr.const(A, shape, Aa.device))).chunk(
        2, -1)
    E1, F, H = fr.sub(cat(S, Dd, Bb), cat(Aa, Cc, aA)).chunk(3, -1)
    E = fr.sub(E1, Bb)
    G = fr.add(Dd, Cc)
    return tuple(fr.mul(cat(E, G, F, E), cat(F, H, G, H)).chunk(4, -1))


def double(p):
    return add(p, p)


def select_point(cond, p, q):
    return tuple(fr.select(cond, a, b) for a, b in zip(p, q))


def scalar_mul(scalar, point, nbits: int = 254):
    """scalar: (16, B) Fr limbs, used as an integer (Num2Bits(254));
    point: affine (x, y). Returns affine (x, y). The LSB-first ladder and
    the affine inversion go through the kernel wrapper, which takes a CUDA
    tensor to the hand-written kernel and a CPU tensor to the plain
    version."""
    from . import cuda_babyjubjub
    x, y = point
    return cuda_babyjubjub.ladder_affine(fr.to_bits(scalar, nbits), x, y)


def base8_mul(scalar):
    """BabyPbk: pk = Base8 * scalar. scalar: (16, B) -> affine (x, y)."""
    bshape, dev = scalar.shape[1:], scalar.device
    return scalar_mul(scalar, (fr.const(BASE8_X, bshape, dev),
                               fr.const(BASE8_Y, bshape, dev)))


def on_curve(x, y):
    """a*x^2 + y^2 == 1 + d*x^2*y^2 -> bool (B,)."""
    x2 = fr.sqr(x)
    y2 = fr.sqr(y)
    bshape, dev = x.shape[1:], x.device
    lhs = fr.add(fr.mul(x2, fr.const(A, bshape, dev)), y2)
    rhs = fr.add(fr.const(1, bshape, dev),
                 fr.mul(fr.mul(x2, y2), fr.const(D, bshape, dev)))
    return fr.eq(lhs, rhs)
