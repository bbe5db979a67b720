"""BN254 scalar field (Fr) arithmetic over (16, *batch) int64 limb tensors.

Counterpart of ``passport_zk_circuits_tpu/ops/field.py``: every value is
canonical (< P) at function boundaries, and reduction is Barrett with the
static BN254 mu, so results are bit-equal to the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bignum as bn

# BN254 (alt_bn128) scalar field modulus.
P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
NLIMBS = 16                      # 16 x 16-bit limbs = 256 bits >= 254

P_LIMBS = bn.int_to_limbs(P, NLIMBS)
MU_LIMBS = bn.barrett_mu(P, NLIMBS)
ONE_LIMBS = bn.int_to_limbs(1, NLIMBS)


# -- host conversions -------------------------------------------------------

def to_limbs(x: int) -> np.ndarray:
    return bn.int_to_limbs(x % P, NLIMBS)


def from_limbs(a) -> int:
    return bn.limbs_to_int(a)


def batch_to_limbs(xs) -> np.ndarray:
    return bn.ints_to_limbs_batch([x % P for x in xs], NLIMBS)


def batch_from_limbs(a) -> list:
    return bn.limbs_to_ints_batch(a)


# -- static constants as device tensors -------------------------------------

def _p(like):
    return bn.cached_const(P, NLIMBS, like.device, like.dim())


def _mu(like):
    return bn.cached_const((1 << (32 * NLIMBS)) // P, NLIMBS + 1,
                           like.device, like.dim())


# -- device ops -------------------------------------------------------------

def add(a, b):
    return bn.add_mod(a, b, _p(a))


def sub(a, b):
    return bn.sub_mod(a, b, _p(a))


def neg(a):
    return bn.sub_mod(torch.zeros_like(a), a, _p(a))


def mul(a, b):
    return bn.mod_mul(a, b, _p(a), _mu(a))


def sqr(a):
    return mul(a, a)


def pow_(a, exp: int):
    return bn.mod_pow(a, exp, _p(a), _mu(a), one=ONE_LIMBS)


def inv(a):
    """Inverse via Fermat (a^(p-2)); inv(0) = 0, circom's witness
    convention."""
    return bn.mod_pow(a, P - 2, _p(a), _mu(a))


def reduce_overflowed(t):
    """Reduce a (32, *B) overflowed limb tensor (limbs < 2^47) mod p: sum
    many products lazily, reduce once."""
    return bn.barrett_reduce(t, _p(t), _mu(t))


# -- predicates / bit ops ---------------------------------------------------

def is_zero(a):
    return bn.is_zero(a)


def eq(a, b):
    return bn.eq(a, b)


def lt(a, b):
    return bn.lt(a, b)


def select(cond, a, b):
    """cond ? a : b with cond shape (*batch,) broadcast over the limb axis."""
    return torch.where(cond.bool().unsqueeze(0), a, b)


def to_bits(a, nbits: int):
    """Little-endian bit decomposition -> (nbits, *batch) int64 in {0, 1}."""
    i = torch.arange(nbits, device=a.device)
    sh = (i % bn.W).reshape((nbits,) + (1,) * (a.dim() - 1))
    return (a[i // bn.W] >> sh) & 1


def from_bits(bits):
    """(nbits, *batch) {0, 1} -> (16, *batch) limbs."""
    nbits = bits.shape[0]
    full = bits.new_zeros((NLIMBS * bn.W,) + bits.shape[1:])
    full[:nbits] = bits
    full = full.reshape((NLIMBS, bn.W) + bits.shape[1:])
    sh = torch.arange(bn.W, device=bits.device).reshape(
        (1, bn.W) + (1,) * (bits.dim() - 1))
    return (full << sh).sum(1)


def const(x: int, batch_shape, device):
    """Broadcast a Python int constant to a (16, *batch_shape) tensor."""
    limbs = bn.to_tensor(to_limbs(x), device)
    return limbs.reshape((NLIMBS,) + (1,) * len(batch_shape)).expand(
        (NLIMBS,) + tuple(batch_shape)).clone()
