"""Passport-date gadgets ("YYMMDD" UTF-8 in 48 bits) as R1CS.

Constraint twin of the reference's circuits/dateUtilities/ (DateDecoder's
unconstrained nibble split + re-encode check, dateDecoder.circom:6-23;
DateIsLess lexicographic compare, dateComparison.circom:5-54; the
century-normalized variant, dateComparisonEncodedNormalized.circom:14-49),
matching the witness semantics of ops/dates.py. Dates arrive as full Fr
signals whose value is the 48-bit big-endian packing (limb0="DD",
limb1="MM", limb2="YY" in the 16-bit-limb view).

The port's copy of
``passport_zk_circuits_tpu/circuit/dates.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import Tuple

from .builder import Builder, Sig


def _lt_var(b: Builder, x: Sig, y: Sig, nbits: int) -> Sig:
    """x < y for values known < 2^nbits."""
    bits = b.num2bits(x - y + b.const(1 << nbits), nbits + 1, "date_lt")
    return b.not_(bits[nbits])


def _digits(b: Builder, limb: Sig) -> Sig:
    """One encoded two-digit byte pair 0x3T3O -> value 10*T + O, with the
    re-encode constraint (DateDecoder's `<--` + `===` discipline)."""
    tens = b.hint_map(lambda v: (v >> 8) & 15, limb, label="date_tens")
    ones = b.hint_map(lambda v: v & 15, limb, label="date_ones")
    for d in (tens, ones):
        b.num2bits(d, 4, "date_digit")
        b.enforce_eq(b.lt_const(d, 10, 4), 1)
    b.enforce_eq(tens.scale(256) + ones + b.const(0x3030), limb)
    return tens.scale(10) + ones


def decode(b: Builder, enc: Sig) -> Tuple[Sig, Sig, Sig]:
    """Encoded date signal -> (day, month, year) small values; enforces
    well-formedness (digit nibbles + nothing above 48 bits)."""
    vals = enc.val()
    limbs = []
    for i in range(3):
        l = b.hint([(int(v) >> (16 * i)) & 0xFFFF for v in vals],
                   f"date_l{i}")
        limbs.append(l)
    b.enforce_eq(limbs[0] + limbs[1].scale(1 << 16) +
                 limbs[2].scale(1 << 32), enc)     # nothing above 48 bits
    day = _digits(b, limbs[0])
    month = _digits(b, limbs[1])
    year = _digits(b, limbs[2])
    return day, month, year


def _date_lt(b: Builder, d1, m1, y1, d2, m2, y2, ybits: int = 8) -> Sig:
    """Lexicographic (y, m, d) strict compare."""
    y_lt = _lt_var(b, y1, y2, ybits)
    y_eq = b.is_zero(y1 - y2)
    m_lt = _lt_var(b, m1, m2, 7)
    m_eq = b.is_zero(m1 - m2)
    d_lt = _lt_var(b, d1, d2, 7)
    md = b.or_(m_lt, b.and_(m_eq, d_lt))
    return b.or_(y_lt, b.and_(y_eq, md))


def encoded_date_is_less(b: Builder, first: Sig, second: Sig) -> Sig:
    d1, m1, y1 = decode(b, first)
    d2, m2, y2 = decode(b, second)
    return _date_lt(b, d1, m1, y1, d2, m2, y2)


def encoded_date_is_less_normalized(b: Builder, first: Sig, second: Sig,
                                    current: Sig) -> Sig:
    """Century normalization: dates before `current` are 20xx (+100 years)
    (dateComparisonEncodedNormalized.circom:14-49)."""
    d1, m1, y1 = decode(b, first)
    d2, m2, y2 = decode(b, second)
    dc, mc, yc = decode(b, current)
    first_20th = _date_lt(b, d1, m1, y1, dc, mc, yc)
    second_20th = _date_lt(b, d2, m2, y2, dc, mc, yc)
    y1n = y1 + first_20th.scale(100)
    y2n = y2 + second_20th.scale(100)
    return _date_lt(b, d1, m1, y1n, d2, m2, y2n)
