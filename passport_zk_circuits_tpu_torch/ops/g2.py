"""Batched BN254 G2 (the twist over FQ2) point arithmetic, plain PyTorch.

Counterpart of ``passport_zk_circuits_tpu/ops/g2.py`` (XLA code there: no
Pallas kernel reaches it). The prover's pi_B is a G2 multi-scalar
multiplication over the proving key's [v_j(tau)]G2 query, and setup makes
that query with the fixed-base mult below.

An FQ2 element rides as a ``(k, 2, *batch)`` int64 limb tensor (the
component axis right after the limb axis). ``G2Ctx`` has the field and
layout interface of ``weierstrass.CurveCtx``, so the Jacobian formulas of
ops/weierstrass.py run unchanged over the twist: a point is
``(k, 2, 3, *batch)`` (``ax = 2``), and the zero test reduces over the
limbs and both components. FQ2 is Fq[u]/(u^2 + 1) (groth16/pairing.py
FQ2); a product is Karatsuba's three base products, taken in one call of
``bignum.StaticMod``. Every value is canonical, so every output equals the
JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bignum as bn
from . import weierstrass as wst

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

K = bn.nlimbs_for_bits(Q.bit_length())         # 16 limbs of 16 bits
KN = bn.nlimbs_for_bits(R.bit_length())


def _pair(x0, x1):
    return torch.stack([x0, x1], 1)


class G2Ctx:
    """Field and group-formula interface over FQ2 for ops/weierstrass."""

    ax = 2          # a point is (k, 2, 3, *B): its coordinate axis
    a = 0           # the twist y^2 = x^3 + 3 / (9 + u)
    name = "bn254_g2"   # its fixed-base table: fixed_base_bn254_g2.npz

    def __init__(self):
        self.k = K
        self.kn = KN
        self.fp = bn.StaticMod(Q, K)

    # -- FQ2 ops on (k, 2, *B) tensors --------------------------------

    def add(self, x, y):
        return self.fp.add(x, y)

    def sub(self, x, y):
        return self.fp.sub(x, y)

    def mul(self, x, y):
        """Karatsuba: x0 y0, x1 y1 and (x0 + x1)(y0 + y1) in one product
        call; re = m0 - m1 (u^2 = -1), im = t - m0 - m1."""
        x, y = torch.broadcast_tensors(x, y)
        (x0, x1), (y0, y1) = x.unbind(1), y.unbind(1)
        sx, sy = self.fp.add(_pair(x0, y0), _pair(x1, y1)).unbind(1)
        m0, m1, t = self.fp.mul(torch.stack([x0, x1, sx], 1),
                                torch.stack([y0, y1, sy], 1)).unbind(1)
        re, tm = self.fp.sub(_pair(m0, t), _pair(m1, m0)).unbind(1)
        return _pair(re, self.fp.sub(tm, m1))

    def sqr(self, x):
        """(x0 + x1 u)^2 = (x0 + x1)(x0 - x1) + 2 x0 x1 u: two products."""
        x0, x1 = x.unbind(1)
        re, m = self.fp.mul(_pair(self.fp.add(x0, x1), x0),
                            _pair(self.fp.sub(x0, x1), x1)).unbind(1)
        return _pair(re, self.fp.add(m, m))

    def inv(self, x):
        """1/(x0 + x1 u) = (x0 - x1 u) / (x0^2 + x1^2); inv(0) = 0."""
        n0, n1 = self.fp.mul(x, x).unbind(1)
        ninv = self.fp.inv(self.fp.add(n0, n1))
        x0, x1 = x.unbind(1)
        return self.fp.mul(_pair(x0, self.fp.sub(torch.zeros_like(x1), x1)),
                           ninv.unsqueeze(1))

    # -- group-formula hooks (the weierstrass.jac_* contract) ----------

    def const_like(self, v: int, tmpl):
        """The base-field int v as (v, 0) in FQ2, (k, 2, 1, ..) limbs that
        broadcast against tmpl (cached: never write to it)."""
        return _const(v % Q, tmpl.device, tmpl.dim())

    def stack(self, *xs):
        return torch.stack(xs, 2)

    def is_zero_f(self, x):
        """x == 0 over the limbs and both components: (k, 2, *R) ->
        bool (*R)."""
        return (x == 0).all(0).all(0)


@functools.lru_cache(maxsize=None)
def _const(v: int, device: torch.device, ndim: int):
    t = bn.to_tensor(np.stack([bn.int_to_limbs(v, K), np.zeros(K, np.uint32)],
                              axis=1), device)
    return t.reshape((K, 2) + (1,) * (ndim - 2))


@functools.lru_cache(maxsize=None)
def ctx() -> G2Ctx:
    return G2Ctx()


# -- host conversions (pairing.FQ2 affine points <-> limb arrays) ------------

def fq2_to_limbs(el) -> np.ndarray:
    """pairing.FQ2 -> (k, 2) uint32."""
    c0, c1 = (int(c) % Q for c in el.coeffs)
    return np.stack([bn.int_to_limbs(c0, K), bn.int_to_limbs(c1, K)], axis=1)


def limbs_to_fq2(a):
    from ..groth16 import pairing as pr
    a = bn._to_numpy(a)
    return pr.FQ2([bn.limbs_to_int(a[:, 0]), bn.limbs_to_int(a[:, 1])])


def points_to_limbs(points):
    """Affine pairing-G2 points (None = infinity) -> ((2, k, 2, N) limb
    array, (N,) infinity mask)."""
    n = len(points)
    out = np.zeros((2, K, 2, n), np.uint32)
    inf = np.zeros(n, bool)
    for i, pt in enumerate(points):
        if pt is None:
            inf[i] = True
        else:
            out[0, :, :, i] = fq2_to_limbs(pt[0])
            out[1, :, :, i] = fq2_to_limbs(pt[1])
    return out, inf


def limbs_to_point(x, y):
    """Affine (k, 2) coordinate limb pair -> pairing-G2 point (or None)."""
    x, y = bn._to_numpy(x), bn._to_numpy(y)
    if not (x.any() or y.any()):
        return None
    return (limbs_to_fq2(x), limbs_to_fq2(y))


# -- fixed-base [s]G2 (setup's b2_query) -------------------------------------

def fixed_base_mul(scalar_limbs):
    """scalar * G2 for batched Fr scalars (kn, *B) int64 -> a Jacobian FQ2
    point (k, 2, 3, *B), through the stride-8 tables of the port's copy of
    ``fixed_base_bn254_g2.npz`` (``weierstrass.fixed_base_mul``)."""
    return wst.fixed_base_mul(ctx(), scalar_limbs)


def to_affine(P):
    return wst.to_affine(ctx(), P)
