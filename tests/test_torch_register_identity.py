"""The port's flagship RegisterIdentity witness step against the JAX package.

The JAX flagship forward is slow-tier on the CPU (minutes of XLA compile),
so the fast tests hold the port against tests/fixtures/
torch_port_flagship_b2.npz, which tools/make_torch_port_fixtures.py wrote
from the JAX package (its synthetic generator, builder and forward at batch
2, seed fixed), and against the pure-Python oracles. A slow-tier test runs
the live JAX forward on the same seeded inputs. Exact equality throughout.
"""

import pathlib
import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.models.params import CircuitParams
from passport_zk_circuits_tpu_torch.ingest import builder, convert, synthetic
from passport_zk_circuits_tpu_torch.models import register_identity as ri
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / \
    "torch_port_flagship_b2.npz"
FLAGSHIP = CircuitParams.from_name(
    "registerIdentity_1_256_3_4_600_248_1_1496_3_256")
NO_AA = CircuitParams(signature_type=1, dg_hash_type=256, document_type=3,
                      ec_block_number=4, ec_shift=600, dg1_shift=248,
                      aa_signature_algo=0, dg15_shift=0,
                      dg15_block_number=1, aa_shift=0)
PUBLIC = ("passport_hash", "dg1_commitment", "pk_identity_hash",
          "dg15_pubkey_hash")


def _passports(p, seed, batch=2):
    """Synthetic passports sharing the signer and AA keys, drawn as the
    fixture tool draws them."""
    rng = random.Random(seed)
    signer = aa = None
    pps = []
    for _ in range(batch):
        pp = synthetic.make_synthetic_passport(p, rng, signer_key=signer,
                                               aa_key=aa)
        signer, aa = pp["signer_key"], pp["aa_key"]
        pps.append(pp)
    return pps


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def flagship_run(fixture):
    pps = _passports(FLAGSHIP, int(fixture["seed"]))
    np_inp = builder.build_register_inputs_numpy(FLAGSHIP, pps)
    out = ri.forward(FLAGSHIP, convert.inputs_from_numpy(np_inp, "cpu"))
    return pps, np_inp, out


def test_ingest_matches_jax_builder(fixture, flagship_run):
    _, np_inp, _ = flagship_run
    for f in np_inp.passport._fields:
        np.testing.assert_array_equal(getattr(np_inp.passport, f),
                                      fixture[f"in_{f}"], err_msg=f)
    np.testing.assert_array_equal(np_inp.sk_identity,
                                  fixture["in_sk_identity"])


def test_forward_matches_jax_fixture(fixture, flagship_run):
    _, _, out = flagship_run
    got = convert.outputs_to_numpy(out)
    keys = sorted(k[4:] for k in fixture if k.startswith("out_"))
    assert set(keys) == {k for k, v in got.items() if v is not None}
    for k in keys:
        np.testing.assert_array_equal(got[k], fixture[f"out_{k}"],
                                      err_msg=k)


def test_forward_matches_oracles(flagship_run):
    pps, _, out = flagship_run
    for name in PUBLIC:
        assert fr.batch_from_limbs(out[name]) == \
            [synthetic.expected_outputs(FLAGSHIP, pp)[name] for pp in pps]
    for verdict in ("flow_ok", "sig_ok", "smt_ok"):
        assert out[verdict].all(), verdict


def test_convert_takes_the_jax_builders_inputs(fixture, flagship_run):
    # the JAX builder's numpy inputs, as the fixture holds them, convert to
    # the same tensors as the port's own builder makes
    _, np_inp, _ = flagship_run
    jax_like = np_inp._replace(
        passport=np_inp.passport._replace(**{
            f: fixture[f"in_{f}"] for f in np_inp.passport._fields}),
        sk_identity=fixture["in_sk_identity"])
    a = convert.inputs_from_numpy(jax_like, "cpu")
    b = convert.inputs_from_numpy(np_inp, "cpu")
    for x, y in zip(a.passport, b.passport):
        assert x.dtype == torch.int64 and torch.equal(x, y)


def test_tampered_lanes_fail_and_neighbours_pass():
    pps = _passports(NO_AA, 77)
    pps[0] = dict(pps[0], dg1=bytes([pps[0]["dg1"][0] ^ 1]) +
                  pps[0]["dg1"][1:])
    pps[1] = dict(pps[1], signature=pps[1]["signature"] ^ 1)
    out = ri.forward(NO_AA, builder.build_register_inputs(NO_AA, pps, "cpu"))
    assert out["flow_ok"].tolist() == [False, True]
    assert out["sig_ok"].tolist() == [True, False]
    assert fr.batch_from_limbs(out["dg15_pubkey_hash"]) == [0, 0]
    for name in PUBLIC:
        assert fr.batch_from_limbs(out[name]) == \
            [synthetic.expected_outputs(NO_AA, pp)[name] for pp in pps]


@pytest.mark.slow
def test_forward_matches_live_jax():
    import jax
    from passport_zk_circuits_tpu.ingest.builder import \
        build_register_inputs as jax_build
    from passport_zk_circuits_tpu.models import register_identity as jri
    pps = _passports(FLAGSHIP, 909)
    jout = jax.jit(lambda i: jri.forward(FLAGSHIP, i))(
        jax_build(FLAGSHIP, pps))
    out = convert.outputs_to_numpy(ri.forward(
        FLAGSHIP, builder.build_register_inputs(FLAGSHIP, pps, "cpu")))
    for k, v in out.items():
        if v is not None:
            np.testing.assert_array_equal(v, np.asarray(jout[k]), err_msg=k)
