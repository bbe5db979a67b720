"""The port's own copies of the JAX package's pure-Python modules
(models/params, utils/poseidon_ref, babyjubjub_ref, rsa_keygen) and of
utils/constants/poseidon_bn254.npz equal the originals: the registry field
by field, the constants array by array, the oracles on seeded inputs."""

import dataclasses
import pathlib
import random

import numpy as np
import pytest

from passport_zk_circuits_tpu.models import params as jparams
from passport_zk_circuits_tpu.utils import babyjubjub_ref as jbref
from passport_zk_circuits_tpu.utils import poseidon_ref as jpref
from passport_zk_circuits_tpu.utils import rsa_keygen as jkeygen
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.ops import poseidon as pos
from passport_zk_circuits_tpu_torch.utils import babyjubjub_ref as bref
from passport_zk_circuits_tpu_torch.utils import poseidon_ref as pref
from passport_zk_circuits_tpu_torch.utils import rsa_keygen

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_NPZ = (ROOT / "passport_zk_circuits_tpu" / "utils" / "constants"
           / "poseidon_bn254.npz")


def test_sig_algo_registry_field_by_field():
    assert sorted(params.SIG_ALGOS) == sorted(jparams.SIG_ALGOS)
    for i, algo in params.SIG_ALGOS.items():
        assert dataclasses.asdict(algo) == \
            dataclasses.asdict(jparams.SIG_ALGOS[i])


@pytest.mark.parametrize("sig", sorted(jparams.SIG_ALGOS))
def test_circuit_params_field_by_field(sig):
    name = f"registerIdentity_{sig}_256_3_4_600_248_1_1496_3_256"
    p, jp = (m.CircuitParams.from_name(name) for m in (params, jparams))
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.name == jp.name == name
    assert dataclasses.asdict(p.sig) == dataclasses.asdict(jp.sig)
    assert (p.dg_hash_block_size, p.sig_hash_block_size) == \
        (jp.dg_hash_block_size, jp.sig_hash_block_size)


def test_poseidon_npz_equal_array_by_array():
    assert pos.NPZ.read_bytes() == JAX_NPZ.read_bytes()
    with np.load(pos.NPZ) as mine, np.load(JAX_NPZ) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for k in theirs.files:
            assert np.array_equal(mine[k], theirs[k]), k


def test_poseidon_oracle_equal():
    rng = random.Random(31)
    for t in (2, 3, 6, 17):
        xs = [rng.randrange(pref.P) for _ in range(t - 1)]
        init = rng.randrange(pref.P)
        assert pref.poseidon(xs) == jpref.poseidon(xs)
        assert pref.poseidon_ex(xs, 2, init) == jpref.poseidon_ex(xs, 2, init)


def test_babyjubjub_oracle_equal():
    rng = random.Random(32)
    for _ in range(3):
        s = rng.randrange(1 << 254)
        assert bref.base8_mul(s) == jbref.base8_mul(s)
    p = bref.base8_mul(5)
    assert bref.add(p, p) == jbref.add(p, p)


def test_rsa_keygen_equal():
    assert rsa_keygen.gen_rsa_key(512, random.Random(33)) == \
        jkeygen.gen_rsa_key(512, random.Random(33))
