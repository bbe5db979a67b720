"""The port's ops/dates against the JAX package's, bit for bit (tolerance
0), on seeded valid dates, malformed digits, a non-zero high limb and dates
on both sides of the current date for the century rule."""

import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import dates as jdates
from passport_zk_circuits_tpu.ops import field as jfr
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import dates

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

rng = random.Random(4242)
CURRENT = b"250817"


def _enc(date: bytes) -> int:
    return int.from_bytes(date, "big")


def _valid(n):
    return [f"{rng.randrange(100):02d}{rng.randrange(1, 13):02d}"
            f"{rng.randrange(1, 32):02d}".encode() for _ in range(n)]


def _malformed(n):
    """A digit byte replaced by a non-digit (":" and "A" next to the digit
    range, a digit's low nibble under another high nibble, or any other
    byte)."""
    out = []
    for d in _valid(n):
        b = bytearray(d)
        b[rng.randrange(6)] = rng.choice(
            [0x3A, 0x41, 0x20 | (b[0] & 15),
             rng.choice([v for v in range(256) if not 0x30 <= v <= 0x39])])
        out.append(bytes(b))
    return out


def _case(n=48):
    """(16, n) uint32 limbs: valid dates, malformed ones, one with a
    non-zero limb 3, the current date itself and its neighbours."""
    vals = [_enc(d) for d in _valid(n // 2) + _malformed(n // 4)]
    vals += [_enc(b"900115") | (1 << 48), _enc(CURRENT), _enc(b"250816"),
             _enc(b"250818"), _enc(b"991231"), _enc(b"000101")]
    vals += [rng.randrange(1 << 48) for _ in range(n - len(vals))]
    return jfr.batch_to_limbs(vals)


def _t(a):
    return bn.to_tensor(a, "cpu")


def _eq(mine, theirs):
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_decode_matches_jax():
    enc = _case()
    got = dates.decode(_t(enc))
    want = jdates.decode(enc)
    for g, w in zip(got, want):
        _eq(g, w)
    ok = got[3].numpy()
    # the valid dates pass and a non-zero limb 3 fails; a malformed date
    # need not fail: ":" (0x3A) as a tens digit decodes to 10 and
    # re-encodes to itself, in the JAX package as in the reference
    assert ok[:24].all() and not ok[36]


def test_encode_matches_jax_and_inverts_decode():
    enc = _case()
    day, month, year, ok = dates.decode(_t(enc))
    _eq(dates.encode(day, month, year),
        jdates.encode(*(np.asarray(x) for x in jdates.decode(enc)[:3])))
    assert torch.equal(dates.encode(day, month, year)[:, ok],
                       _t(enc)[:3][:, ok])


@pytest.mark.parametrize("normalized", [False, True])
def test_compares_match_jax(normalized):
    first, second = _case(), _case()
    # every ordered pair of a few fixed dates around CURRENT, on both sides
    # of the century split, beside the seeded ones
    fixed = [b"991231", b"000101", b"250816", b"250817", b"250818",
             b"300101", b"240101"]
    pairs = [(a, b) for a in fixed for b in fixed]
    first = np.concatenate(
        [first, jfr.batch_to_limbs([_enc(a) for a, _ in pairs])], 1)
    second = np.concatenate(
        [second, jfr.batch_to_limbs([_enc(b) for _, b in pairs])], 1)
    if normalized:
        cur = jfr.batch_to_limbs([_enc(CURRENT)] * first.shape[1])
        got = dates.encoded_date_is_less_normalized(_t(first), _t(second),
                                                    _t(cur))
        want = jdates.encoded_date_is_less_normalized(first, second, cur)
    else:
        got = dates.encoded_date_is_less(_t(first), _t(second))
        want = jdates.encoded_date_is_less(first, second)
    for g, w in zip(got, want):
        _eq(g, w)
    less = got[0].numpy()[-len(pairs):]
    i = fixed.index
    # "991231" < "000101" only once 00 is read as 2000 (before CURRENT)
    assert less[i(b"991231") * len(fixed) + i(b"000101")] == normalized
    # and "250816" (before CURRENT: 2025) is no longer below "250818" (1925)
    assert less[i(b"250816") * len(fixed) + i(b"250818")] != normalized
