"""The port's limb arithmetic (bignum, field, bitops) against the JAX package.

The same inputs, made from a fixed seed, go through the JAX function (its XLA
path, as the JAX package's fast tests run it on the CPU) and the port's
plain PyTorch version; results must be equal exactly (integer arithmetic,
tolerance 0) and equal to the Python-int oracle.
"""

import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import bignum as jbn
from passport_zk_circuits_tpu.ops import bitops as jbit
from passport_zk_circuits_tpu.ops import field as jfr
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import bitops
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(1101)
P = fr.P
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 253) + 7]


def _t(a):
    return bn.to_tensor(a, "cpu")


def _eq(port, jax_out):
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out))


def test_host_helpers_match_jax():
    xs = EDGES + [rng.randrange(P) for _ in range(4)]
    np.testing.assert_array_equal(bn.ints_to_limbs_batch(xs, 16),
                                  jbn.ints_to_limbs_batch(xs, 16))
    np.testing.assert_array_equal(fr.batch_to_limbs(xs),
                                  jfr.batch_to_limbs(xs))
    assert fr.batch_from_limbs(_t(fr.batch_to_limbs(xs))) == xs
    mods = [rng.getrandbits(2047) | (1 << 2047) | 1 for _ in range(3)]
    np.testing.assert_array_equal(bn.barrett_mu_batch(mods, 128),
                                  jbn.barrett_mu_batch(mods, 128))
    np.testing.assert_array_equal(fr.MU_LIMBS, jfr.MU_LIMBS)
    with pytest.raises(ValueError):
        bn.barrett_mu(3, 16)


def test_field_ops_match_jax():
    xs = EDGES + [rng.randrange(P) for _ in range(4)]
    ys = list(reversed(EDGES)) + [rng.randrange(P) for _ in range(4)]
    a_np, b_np = fr.batch_to_limbs(xs), fr.batch_to_limbs(ys)
    a, b = _t(a_np), _t(b_np)
    cases = [
        (fr.add, jfr.add, lambda x, y: (x + y) % P),
        (fr.sub, jfr.sub, lambda x, y: (x - y) % P),
        (fr.mul, jfr.mul, lambda x, y: x * y % P),
    ]
    for port, ref, oracle in cases:
        got = port(a, b)
        _eq(got, ref(a_np, b_np))
        assert fr.batch_from_limbs(got) == [oracle(x, y)
                                            for x, y in zip(xs, ys)]
    _eq(fr.neg(a), jfr.neg(a_np))
    _eq(fr.sqr(a), jfr.sqr(a_np))
    np.testing.assert_array_equal(fr.eq(a, b).numpy(),
                                  np.asarray(jfr.eq(a_np, b_np)))
    np.testing.assert_array_equal(fr.lt(a, b).numpy(),
                                  np.asarray(jfr.lt(a_np, b_np)))
    np.testing.assert_array_equal(fr.is_zero(a).numpy(),
                                  np.asarray(jfr.is_zero(a_np)))


def test_pow_inv_match_jax():
    xs = [0, 1, P - 1] + [rng.randrange(P) for _ in range(3)]
    a_np = fr.batch_to_limbs(xs)
    a = _t(a_np)
    _eq(fr.pow_(a, 5), jfr.pow_(a_np, 5))
    inv = fr.inv(a)
    _eq(inv, jfr.inv(a_np))
    assert fr.batch_from_limbs(inv) == [pow(x, P - 2, P) for x in xs]
    assert fr.batch_from_limbs(fr.pow_(a, 0)) == [1] * len(xs)


def test_bignum_per_lane_modulus_k16_matches_jax():
    k, B = 16, 6
    mods = [rng.getrandbits(255) | (1 << 255) | 1 for _ in range(B)]
    xs = [rng.randrange(m) for m in mods]
    ys = [m - 1 if i == 0 else rng.randrange(m) for i, m in enumerate(mods)]
    m_np = jbn.ints_to_limbs_batch(mods, k)
    mu_np = jbn.barrett_mu_batch(mods, k)
    x_np, y_np = jbn.ints_to_limbs_batch(xs, k), jbn.ints_to_limbs_batch(ys, k)
    m, mu, x, y = _t(m_np), _t(mu_np), _t(x_np), _t(y_np)
    prod = bn.poly_mul(x, y)
    assert bn.limbs_to_ints_batch(prod) == [a * b for a, b in zip(xs, ys)]
    _eq(bn.carry_normalize(prod, 2 * k),
        jbn.carry_normalize(jbn.poly_mul(x_np, y_np), 2 * k))
    _eq(bn.mod_mul(x, y, m, mu), jbn.mod_mul(x_np, y_np, m_np, mu_np))
    _eq(bn.add_mod(x, y, m), jbn.add_mod(x_np, y_np, m_np))
    _eq(bn.sub_mod(x, y, m), jbn.sub_mod(x_np, y_np, m_np))
    d, borrow = bn.sub_limbs(x, y)
    jd, jborrow = jbn.sub_limbs(x_np, y_np)
    _eq(d, jd)
    _eq(borrow, jborrow)
    assert bn.limbs_to_ints_batch(bn.mod_mul(x, y, m, mu)) == \
        [a * b % n for a, b, n in zip(xs, ys, mods)]


def test_carry_normalize_overflowed_limbs_match_jax():
    # limbs up to 2^32 - 1 (the JAX package's uint32 range), with runs of
    # 0xFFFF that make a carry ripple across many limbs
    t_np = np.array([[rng.randrange(1 << 32) for _ in range(4)]
                     for _ in range(40)], dtype=np.uint32)
    t_np[5:30, 1] = 0xFFFF
    t_np[4, 1] = 0x1FFFF
    t = _t(t_np)
    for k_out in (40, 20, 45):
        _eq(bn.carry_normalize(t, k_out), jbn.carry_normalize(t_np, k_out))


def test_bits_select_const():
    xs = [0, P - 1, rng.randrange(P)]
    a = _t(fr.batch_to_limbs(xs))
    _eq(fr.to_bits(a, 254), jfr.to_bits(fr.batch_to_limbs(xs), 254))
    _eq(fr.from_bits(fr.to_bits(a, 254)), fr.batch_to_limbs(xs))
    cond = torch.tensor([True, False, True])
    b = _t(fr.batch_to_limbs([5, 6, 7]))
    assert fr.batch_from_limbs(fr.select(cond, a, b)) == [xs[0], 6, xs[2]]
    assert fr.batch_from_limbs(fr.const(12345, (2,), "cpu")) == [12345] * 2


def test_bitops_match_jax():
    w_np = np.array([[rng.randrange(1 << 32) for _ in range(4)]
                     for _ in range(32)], dtype=np.uint32)
    w_np[0, :] = 0xFFFFFFFF
    w = _t(w_np)
    assert (w >= 1 << 31).any()
    _eq(bitops.get_byte(w, 37), jbit.get_byte(w_np, 37))
    _eq(bitops.get_bytes(w, 3, 33), jbit.get_bytes(w_np, 3, 33))
    _eq(bitops.get_bit(w, 77), jbit.get_bit(w_np, 77))
    _eq(bitops.get_bits(w, 5, 300), jbit.get_bits(w_np, 5, 300))
    for msb in (True, False):
        _eq(bitops.word_slice_to_fr(w, 256, 200, msb),
            jbit.word_slice_to_fr(w_np, 256, 200, msb))
        _eq(bitops.word_slice_to_fr(w, 0, 186, msb),
            jbit.word_slice_to_fr(w_np, 0, 186, msb))
    _eq(bitops.digest32_bytes(w[:8]), jbit.digest32_bytes(w_np[:8]))
    _eq(bitops.words32_to_words64(w), jbit.words32_to_words64(w_np))
    _eq(bitops.digest64_bytes(bitops.words32_to_words64(w[:16])),
        jbit.digest64_bytes(jbit.words32_to_words64(w_np[:16])))
    limbs = w & 0xFFFF
    _eq(bitops.u64_limbs_from_fr16(limbs, 2),
        jbit.u64_limbs_from_fr16(w_np & 0xFFFF, 2))
