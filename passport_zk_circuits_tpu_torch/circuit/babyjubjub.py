"""BabyJubJub scalar multiplication as an R1CS gadget.

Constraint twin of BabyjubjubBase8Multiplication
(the reference's circuits/lib/circuits/babyjubjub/curve.circom:143-171) /
circomlib BabyPbk, matching the witness semantics of ops/babyjubjub.py
(LSB-first 254-bit double-and-add).

Unlike the reference's affine circuits (which special-case the (0,0)
identity with addZeroBabyjub muxes, curve.circom:19-69), additions here
use the *complete* twisted-Edwards affine formulas with the quotient as a
hint wire: x3·(1+d·t) === x1y2+y1x2 — the division IS the pairing
constraint, and completeness removes the identity special case entirely
(acc starts at the true identity (0,1)). 7 constraints per add, 16 per
ladder step, ~4.3k per scalar mult (vs ~3.9k+muxes in the reference).

The port's copy of ``passport_zk_circuits_tpu/circuit/babyjubjub.py``
(host code over Python ints), with the same relative imports, which here
name the port's modules; ``tests/test_torch_copies.py`` holds its code
equal to the original's.
"""

from __future__ import annotations

from typing import List, Tuple

from ..ops.babyjubjub import A, D, BASE8_X, BASE8_Y
from ..utils import babyjubjub_ref as bref
from .builder import Builder, Sig

Point = Tuple[Sig, Sig]


def add(b: Builder, p: Point, q: Point) -> Point:
    """Complete affine twisted-Edwards addition with hint quotients."""
    x1, y1 = p
    x2, y2 = q
    x1y2 = b.mul(x1, y2, "bjj")
    y1x2 = b.mul(y1, x2, "bjj")
    x1x2 = b.mul(x1, x2, "bjj")
    y1y2 = b.mul(y1, y2, "bjj")
    t = b.mul(x1x2, y1y2, "bjj_t")
    x3 = b.hint_map(
        lambda num, tt: num * pow(1 + D * tt, bref.P - 2, bref.P) % bref.P,
        x1y2 + y1x2, t, label="bjj_x3")
    y3 = b.hint_map(
        lambda num, tt: num * pow(1 - D * tt, bref.P - 2, bref.P) % bref.P,
        y1y2 - x1x2.scale(A), t, label="bjj_y3")
    b.enforce(x3, b.const(1) + t.scale(D), x1y2 + y1x2)
    b.enforce(y3, b.const(1) - t.scale(D), y1y2 - x1x2.scale(A))
    return x3, y3


def scalar_mul_bits(b: Builder, bits: List[Sig], base: Tuple[int, int]
                    ) -> Point:
    """sum(bits[i]*2^i) * base for a COMPILE-TIME base point: the doubled
    bases are precomputed host-side, so each step is one conditional add
    (9 constraints) — the constraint-level analog of the reference's
    fixed-base precomputed tables (curve.circom:680-740)."""
    acc: Point = (b.const(0), b.const(1))
    pw = base
    for bit in bits:
        added = add(b, acc, (b.const(pw[0]), b.const(pw[1])))
        acc = (b.select(bit, added[0], acc[0]),
               b.select(bit, added[1], acc[1]))
        pw = bref.add(pw, pw)
    return acc


def base8_mul(b: Builder, sk: Sig) -> Point:
    """pk = Base8 * sk (sk used as a 254-bit integer, identity.circom:
    112-120 / registerIdentityLight.circom:59-66)."""
    bits = b.num2bits(sk, 254, "bjj_bit")
    return scalar_mul_bits(b, bits, (BASE8_X, BASE8_Y))
