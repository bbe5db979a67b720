"""The port's RegisterIdentityLight against the JAX package's and the
Python-int oracles.

The JAX forward's XLA compile on the CPU takes minutes, so the fast tests
hold the port against its outputs saved in the committed fixture
``tests/fixtures/torch_port_query_b2.npz`` (``tools/make_torch_port_fixtures.py
query``: TD3/SHA-256, TD3/SHA-384 and TD1/SHA-256 at batch 2, MRZ-layout
dg1), bit for bit, and against the oracles on the same inputs
(``ingest/identity.expected_light_outputs``: Poseidon and BabyJubJub in
Python ints, hashlib). A slow-tier test runs the JAX forward live.
"""

import pathlib

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.models import register_identity_light as jril
from passport_zk_circuits_tpu_torch.ingest import identity
from passport_zk_circuits_tpu_torch.models import register_identity_light as ril
from passport_zk_circuits_tpu_torch.ops import cuda_babyjubjub
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import cuda_sha2
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_port_query_b2.npz")
CONFIGS = [(3, 256), (3, 384), (1, 256)]
OUTPUTS = ("dg1_commitment", "pk_identity_hash", "dg1_hash")


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as d:
        return {k: d[k] for k in d.files}


def _case(fixture, doc, hash_type):
    tag = f"light_td{doc}_{hash_type}_"
    inp = ril.LightInputs(*(torch.as_tensor(
        fixture[f"{tag}in_{f}"].astype(np.int64))
        for f in ril.LightInputs._fields))
    want = {k: fixture[f"{tag}out_{k}"] for k in OUTPUTS}
    return inp, want


def _dg1s(inp, doc):
    """The dg1 bytes of each lane: the padded words' first 93/95 bytes."""
    cols = inp.dg1_words.T.tolist()
    return [b"".join(int(w).to_bytes(4, "big") for w in col)
            [:identity.DG1_BYTES[doc]] for col in cols]


@pytest.mark.parametrize("doc,hash_type", CONFIGS)
def test_forward_matches_jax_fixture_and_oracles(fixture, doc, hash_type):
    inp, want = _case(fixture, doc, hash_type)
    launches = [f.launches for f in (cuda_sha2.sha2_32_chunks,
                                     cuda_poseidon.poseidon_ex,
                                     cuda_babyjubjub.ladder_affine)]
    out = ril.forward(inp, hash_type, doc)
    # CPU tensors take the plain versions, which count no launch
    assert launches == [f.launches for f in (cuda_sha2.sha2_32_chunks,
                                             cuda_poseidon.poseidon_ex,
                                             cuda_babyjubjub.ladder_affine)]
    assert sorted(out) == sorted(OUTPUTS)
    for k in OUTPUTS:
        np.testing.assert_array_equal(out[k].numpy(),
                                      want[k].astype(np.int64), err_msg=k)
    sks = fr.batch_from_limbs(inp.sk_identity)
    for j, dg1 in enumerate(_dg1s(inp, doc)):
        oracle = identity.expected_light_outputs(dg1, sks[j], doc, hash_type)
        assert {k: fr.batch_from_limbs(out[k])[j] for k in OUTPUTS} == oracle


def test_fixture_inputs_are_mrz_dg1_padded_for_the_hash(fixture):
    for doc, hash_type in CONFIGS:
        inp, _ = _case(fixture, doc, hash_type)
        sks = fr.batch_from_limbs(inp.sk_identity)
        dg1s = _dg1s(inp, doc)
        again = identity.light_inputs(dg1s, sks, hash_type, "cpu")
        assert torch.equal(again.dg1_words, inp.dg1_words)
        for dg1 in dg1s:
            assert identity.field_value(dg1, 56, 24) == \
                int.from_bytes(b"UKR", "big")


def test_light_inputs_refuse_a_dg1_that_pads_past_1024_bits():
    with pytest.raises(ValueError):
        identity.light_inputs([bytes(120)], [1], 256, "cpu")


@pytest.mark.slow
@pytest.mark.parametrize("doc,hash_type", CONFIGS)
def test_fixture_matches_the_live_jax_forward(fixture, doc, hash_type):
    import jax
    inp, want = _case(fixture, doc, hash_type)
    jinp = jril.LightInputs(*(t.numpy().astype(np.uint32) for t in inp))
    got = jax.jit(lambda i: jril.forward(i, hash_type, doc))(jinp)
    for k in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
