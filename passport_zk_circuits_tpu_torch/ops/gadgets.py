"""Batched equivalents of the reference's small stdlib gadget circuits.

Counterpart of ``passport_zk_circuits_tpu/ops/gadgets.py``: Switcher,
ForceEqualIfEnabled, the vector Xor2 gate, BinSum, NonSignalSort (the sort
as a hint plus its sortedness and multiset predicates), the matrix
templates over Fr, and the fixed-point CutPrecision and FloatMult. No model
calls them; they complete the port of the JAX package's ops.
"""

from __future__ import annotations

import math

import torch

from . import bignum as bn
from . import field as fr


def switcher(sel, a, b):
    """(outL, outR) = (b, a) if sel else (a, b)."""
    return fr.select(sel, b, a), fr.select(sel, a, b)


def force_equal_if_enabled(enabled, x, y):
    """Predicate form of ForceEqualIfEnabled: holds iff !enabled or x == y."""
    return ~enabled.bool() | fr.eq(x, y)


def xor2(a, b):
    """Vector XOR over {0, 1} tensors (bitGates.circom Xor2)."""
    return a ^ b


def bin_sum(bit_tensors):
    """Sum of k bit vectors -> the bit vector of the sum (BinSum).
    bit_tensors: list of (n, *B) {0, 1}; returns (n + ceil(log2(k)), *B),
    at least one extra bit."""
    acc = fr.from_bits(bit_tensors[0])
    for t in bit_tensors[1:]:
        acc = bn.carry_normalize(acc + fr.from_bits(t), k_out=fr.NLIMBS)
    n = bit_tensors[0].shape[0]
    extra = max(1, math.ceil(math.log2(max(len(bit_tensors), 2))))
    return fr.to_bits(acc, n + extra)


def sort_checked(values, descending: bool = False):
    """NonSignalSort semantics: the sorted sequence plus the two predicates
    the reference constrains, sortedness and multiset equality.

    values: (n, 16, *B) Fr limbs whose values fit 64 bits (the reference's
    BITS-bounded inputs); the order is that of their low four limbs, and
    equal values keep their input order (reversed when descending, as the
    JAX package flips its ascending order). Returns (sorted_values,
    is_sorted (*B,), is_permutation (*B,))."""
    order = torch.arange(values.shape[0], device=values.device).reshape(
        (-1,) + (1,) * (values.dim() - 2)).expand(
        (values.shape[0],) + values.shape[2:])
    # least significant limb first: stable sorts give the lexicographic order
    for j in range(4):
        key = values[:, j].gather(0, order)
        order = order.gather(0, key.sort(dim=0, stable=True).indices)
    if descending:
        order = order.flip(0)
    sorted_vals = values.gather(0, order.unsqueeze(1).expand_as(values))
    # the circuit's sortedness predicate: limb-wise compares of neighbours
    lo, hi = sorted_vals[:-1].movedim(1, 0), sorted_vals[1:].movedim(1, 0)
    ok_sorted = (~(bn.lt(lo, hi) if descending else bn.lt(hi, lo))).all(0)
    # a gather by sort indices is a permutation by construction, so the
    # multiset predicate (the reference's second check) always holds
    return sorted_vals, ok_sorted, torch.ones_like(ok_sorted)


# -- matrices over Fr --------------------------------------------------------

def mat_mul(A, B):
    """(n, m, 16, *B) @ (m, q, 16, *B) -> (n, q, 16, *B) over Fr, the
    products of each output summed lazily and reduced once
    (MatrixMultiply)."""
    prods = bn.poly_mul(A.movedim(2, 0).unsqueeze(3),
                        B.movedim(2, 0).unsqueeze(1))   # (32, n, m, q, *B)
    return fr.reduce_overflowed(prods.sum(2)).movedim(0, 2)


def mat_add(A, B):
    return fr.add(A.movedim(2, 0), B.movedim(2, 0)).movedim(0, 2)


def mat_transpose(A):
    return A.transpose(0, 1)


def mat_hadamard(A, B):
    return fr.mul(A.movedim(2, 0), B.movedim(2, 0)).movedim(0, 2)


# -- fixed-point ("float") ---------------------------------------------------

def cut_precision(x_bits_value, prec_old: int, prec_new: int):
    """floor(x / 2^(prec_old - prec_new)) on Fr limbs (CutPrecision,
    float.circom:126): a right shift in limb space."""
    full, off = divmod(prec_old - prec_new, bn.W)
    limbs = x_bits_value
    if full:
        limbs = torch.cat([limbs[full:], torch.zeros_like(limbs[:full])])
    if off:
        hi = torch.cat([limbs[1:], torch.zeros_like(limbs[:1])])
        limbs = ((limbs >> off) | (hi << (bn.W - off))) & bn.MASK
    return limbs


def float_mult(a, b, n: int):
    """Fixed-point product with flooring: floor(a b / 2^n) (FloatMult,
    float.circom:21). Values must stay below 2^(254 - n)."""
    return cut_precision(fr.mul(a, b), 2 * n, n)
