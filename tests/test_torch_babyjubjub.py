"""The port's BabyJubJub against the JAX package and the affine oracle."""

import random

import numpy as np
import torch

from passport_zk_circuits_tpu.ops import babyjubjub as jbjj
from passport_zk_circuits_tpu.ops import field as jfr
from passport_zk_circuits_tpu.utils import babyjubjub_ref as bref
from passport_zk_circuits_tpu_torch.ops import babyjubjub as bjj
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_babyjubjub
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(6606)


def _t(a):
    return bn.to_tensor(a, "cpu")


def test_base8_mul_matches_jax_and_oracle():
    sks = [0, 1, fr.P - 1, rng.randrange(fr.P)]
    sk_np = jfr.batch_to_limbs(sks)
    px, py = bjj.base8_mul(_t(sk_np))
    jx, jy = jbjj.base8_mul(sk_np, (len(sks),))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    got = list(zip(fr.batch_from_limbs(px), fr.batch_from_limbs(py)))
    assert got == [bref.base8_mul(s % (1 << 254)) for s in sks]
    assert got[0] == (0, 1) and got[1] == bref.BASE8
    assert bjj.on_curve(px, py).all()


def test_extended_add_matches_jax():
    pts = [bref.base8_mul(rng.randrange(1, 1 << 64)) for _ in range(3)]
    qts = [bref.base8_mul(rng.randrange(1, 1 << 64)) for _ in range(3)]
    p_np = [jfr.batch_to_limbs([pt[i] for pt in pts]) for i in range(2)]
    q_np = [jfr.batch_to_limbs([pt[i] for pt in qts]) for i in range(2)]
    # a point with Z != 1 on one side, the affine embedding on the other
    p_ext = bjj.double(bjj.to_extended(_t(p_np[0]), _t(p_np[1])))
    j_ext = jbjj.double(jbjj.to_extended(*p_np))
    q_ext = bjj.to_extended(_t(q_np[0]), _t(q_np[1]))
    jq_ext = jbjj.to_extended(*q_np)
    for mine, ref in zip(bjj.add(p_ext, q_ext), jbjj.add(j_ext, jq_ext)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def test_ladder_wrapper_on_cpu_is_the_plain_version():
    sk = _t(fr.batch_to_limbs([5, 1 << 200]))
    bits = fr.to_bits(sk, 254)
    bx = fr.const(bjj.BASE8_X, (2,), "cpu")
    by = fr.const(bjj.BASE8_Y, (2,), "cpu")
    before = cuda_babyjubjub.ladder.launches
    ext = cuda_babyjubjub.ladder(bits, bx, by)
    assert cuda_babyjubjub.ladder.launches == before
    x, y = bjj.to_affine(ext)
    assert list(zip(fr.batch_from_limbs(x), fr.batch_from_limbs(y))) == \
        [bref.base8_mul(5), bref.base8_mul(1 << 200)]


def test_ladder_affine_on_cpu_matches_jax_scalar_mul_and_oracle():
    """The affine entry, on a CPU tensor its plain version, against the
    JAX package's scalar_mul on a base other than Base8 and the oracle, for
    scalars 0, 1, P-1 and a seeded one (B = 4); base8_mul goes through the
    same entry (test_base8_mul_matches_jax_and_oracle)."""
    sks = [0, 1, fr.P - 1, rng.randrange(fr.P)]
    sk_np = jfr.batch_to_limbs(sks)
    pt = bref.base8_mul(rng.randrange(1, 1 << 64))
    px_np = jfr.batch_to_limbs([pt[0]] * 4)
    py_np = jfr.batch_to_limbs([pt[1]] * 4)
    bits = fr.to_bits(_t(sk_np), 254)
    before = cuda_babyjubjub.ladder_affine.launches
    x, y = cuda_babyjubjub.ladder_affine(bits, _t(px_np), _t(py_np))
    assert cuda_babyjubjub.ladder_affine.launches == before
    jx, jy = jbjj.scalar_mul(sk_np, (px_np, py_np))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert list(zip(fr.batch_from_limbs(x), fr.batch_from_limbs(y))) == \
        [bref.scalar_mul(s % (1 << 254), pt) for s in sks]
