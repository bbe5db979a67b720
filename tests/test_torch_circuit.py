"""The port's circuit lowering (``circuit/*``, host code over Python ints)
against the JAX package's, tolerance 0.

RegisterIdentityLight built by both packages at batch 2 (about 6 s for the
JAX package's build): the same wire and constraint counts (55,438 and
55,805, domain 65,536), triplets, labels, witness matrix and public
values, which also equal the port's Light forward on the same inputs. The
1,766-wire gadget circuit (BabyJubJub identity key + Poseidon) against
``tests/fixtures/torch_port_prove_b2.npz``, and the SHA padding the
lowering reads against the JAX package's ``ingest.native``.
"""

import pathlib
import random
import sys

import numpy as np
import pytest

from passport_zk_circuits_tpu.circuit import register_light as jrl
from passport_zk_circuits_tpu.ingest import native as jnative
from passport_zk_circuits_tpu_torch.circuit import register_light as rl
from passport_zk_circuits_tpu_torch.ingest import identity
from passport_zk_circuits_tpu_torch.ingest import native
from passport_zk_circuits_tpu_torch.models import register_identity_light as ril
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import make_torch_port_fixtures as fx  # noqa: E402

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_port_prove_b2.npz")
OUTS = ("dg1_commitment", "pk_identity_hash", "dg1_hash")


@pytest.fixture(scope="module")
def light():
    """(dg1s, sks, port builder and public values, JAX's) at batch 2."""
    rng = random.Random(61)
    dg1s = [identity.make_dg1(rng, 3) for _ in range(2)]
    sks = [rng.randrange(1, fr.P) for _ in range(2)]
    built = []
    for mod in (rl, jrl):
        b, outs = mod.build(dg1s, sks)
        built.append((b, b.finalize([outs[k] for k in OUTS])))
    return dg1s, sks, built


def test_light_circuit_equals_jax_at_batch_2(light):
    _, _, ((b, pub), (jb, jpub)) = light
    assert (b.cs.n_vars, b.cs.n_constraints) == (55438, 55805)
    assert 1 << (b.cs.n_constraints - 1).bit_length() == 65536
    assert (b.cs.n_vars, b.cs.n_constraints, b.n_public) == \
        (jb.cs.n_vars, jb.cs.n_constraints, jb.n_public) == (55438, 55805, 3)
    assert b.cs.a == jb.cs.a and b.cs.b == jb.cs.b and b.cs.c == jb.cs.c
    assert b.cs.labels == jb.cs.labels
    w = b.witness_matrix()
    assert w.dtype == np.uint32 and np.array_equal(w, jb.witness_matrix())
    assert pub == jpub


def test_light_public_values_equal_the_port_forward(light):
    dg1s, sks, ((_, pub), _) = light
    out = ril.forward(identity.light_inputs(dg1s, sks, 256, "cpu"), 256, 3)
    assert [fr.batch_from_limbs(out[k]) for k in OUTS] == pub


def test_gadget_circuit_equals_the_fixture():
    with np.load(FIXTURE) as d:
        w = d["gadget_witness"]
        sks = bn.limbs_to_ints_batch(w[2])          # the sk input wire
        b, pub = fx.gadget_circuit("passport_zk_circuits_tpu_torch.circuit",
                                   sks)
        assert (b.cs.n_vars, b.cs.n_constraints) == (1766, 1765)
        assert b.cs.n_vars == int(d["gadget_n_vars"])
        assert b.cs.n_constraints == int(d["gadget_n_constraints"])
        assert np.array_equal(b.witness_matrix(), w)
        for m in ("a", "b", "c"):
            mat = getattr(b.cs, m)
            assert np.array_equal(np.array([(r, c) for r, c, _ in mat]),
                                  d[f"gadget_{m}_rc"])
            assert np.array_equal(
                bn.ints_to_limbs_batch([v for _, _, v in mat], 16).T,
                d[f"gadget_{m}_coeff"])
        assert [bn.limbs_to_ints_batch(p.T) for p in d["gadget_public"]] \
            == pub


@pytest.mark.parametrize("lens", [(0, 55), (56, 90, 119), (9,), (10, 70)])
def test_sha_padding_equals_jax(lens):
    rng = random.Random(sum(lens))
    blobs = [bytes(rng.randrange(256) for _ in range(n)) for n in lens]
    n_blocks = max(-(-(n + 9) // 64) for n in lens)
    if all(-(-(n + 9) // 64) == n_blocks for n in lens):
        got = native.pad_words32_batch(blobs, 512, n_blocks)
        assert got.dtype == np.uint32
        assert np.array_equal(got, jnative.pad_words32_batch(blobs, 512,
                                                             n_blocks))
    else:
        with pytest.raises(ValueError):
            native.pad_words32_batch(blobs, 512, n_blocks)
