"""Batched passport-date utilities ("YYMMDD" UTF-8 packed in 48 bits).

Counterpart of ``passport_zk_circuits_tpu/ops/dates.py`` (DateEncoder,
DateDecoder, DateIsLess, EncodedDateIsLess and the century-normalized
variant of the reference's dateUtilities). An encoded date is a (16, *B)
Fr limb tensor like every other signal; only its low three limbs carry
digits (little-endian limbs: limb 0 = "DD", limb 1 = "MM", limb 2 = "YY",
the tens digit in the high byte). Every op is elementwise on int64 tensors
holding small non-negative values: a decoded field is at most 165 (two
nibbles of 15), a century-normalized year at most 265, so nothing wraps.
"""

from __future__ import annotations

import torch


def _encode_two_digits(v):
    """v in 0..99 -> 0x3T3O: two UTF-8 digit bytes, tens in the high byte."""
    return ((0x30 + v // 10) << 8) | (0x30 + v % 10)


def decode(enc_limbs):
    """(16, *B) encoded date -> (day, month, year, well_formed), each (*B,).

    The nibble arithmetic is DateDecoder's witness; `well_formed` is its
    re-encoding constraint, which pins every high nibble to 0x3 and every
    digit to 0..9, and requires limbs 3.. to be zero."""
    d, m, y = enc_limbs[0], enc_limbs[1], enc_limbs[2]
    day = ((d >> 8) & 15) * 10 + (d & 15)
    month = ((m >> 8) & 15) * 10 + (m & 15)
    year = ((y >> 8) & 15) * 10 + (y & 15)
    ok = ((_encode_two_digits(day) == d) & (_encode_two_digits(month) == m)
          & (_encode_two_digits(year) == y) & (enc_limbs[3:] == 0).all(0))
    return day, month, year, ok


def encode(day, month, year):
    """(day, month, year), each (*B,) -> (3, *B) low limbs of the encoded
    date (DateEncoder)."""
    return torch.stack([_encode_two_digits(day), _encode_two_digits(month),
                        _encode_two_digits(year)])


def date_is_less(d1, m1, y1, d2, m2, y2):
    """Lexicographic (y, m, d) strict compare -> bool (*B,) (DateIsLess)."""
    return (y1 < y2) | ((y1 == y2) & ((m1 < m2) | ((m1 == m2) & (d1 < d2))))


def encoded_date_is_less(first, second):
    """EncodedDateIsLess: first < second on the decoded dates. Returns
    (is_less, well_formed)."""
    d1, m1, y1, ok1 = decode(first)
    d2, m2, y2, ok2 = decode(second)
    return date_is_less(d1, m1, y1, d2, m2, y2), ok1 & ok2


def encoded_date_is_less_normalized(first, second, current):
    """Century-normalized compare: a date earlier than `current` belongs to
    the 21st century (its year + 100), any other to the 20th. Returns
    (is_less, well_formed)."""
    d1, m1, y1, ok1 = decode(first)
    d2, m2, y2, ok2 = decode(second)
    dc, mc, yc, okc = decode(current)
    y1n = y1 + 100 * date_is_less(d1, m1, y1, dc, mc, yc).long()
    y2n = y2 + 100 * date_is_less(d2, m2, y2, dc, mc, yc).long()
    return date_is_less(d1, m1, y1n, d2, m2, y2n), ok1 & ok2 & okc
