"""The port's RegisterIdentity over the other SIG_ALGO families against the
JAX package and the oracles.

tests/fixtures/torch_port_algos_b2.npz holds the JAX package's inputs and
outputs at batch 2 (tools/make_torch_port_fixtures.py: its synthetic
generator, builder and forward, seeds fixed) for seven configs: ECDSA over
brainpoolP256r1 with ECDSA active auth and RSA-PSS with RSA active auth
(the two paths chip_smoke.py drives on the card), RSA and RSA-PSS with
ECDSA active-auth keys over brainpoolP320r1 and secp192r1 (fast tier),
SHA-1 RSA, RSA-PSS with SHA-384 and ECDSA over brainpoolP384r1 (slow
tier). The port's
forward on the fixture's inputs must equal every output bit for bit; its
own synthetic generator and builder, at the fixture's seed, must make the
JAX package's inputs; the public outputs must equal the Python oracles.
"""

import pathlib
import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu_torch.ingest import builder, convert, synthetic
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.models import passport_verification as pv
from passport_zk_circuits_tpu_torch.models import register_identity as ri
from passport_zk_circuits_tpu_torch.ops import field as fr

torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / \
    "torch_port_algos_b2.npz"
ECDSA = "registerIdentity_21_256_3_4_600_248_20_1496_3_256"
PSS = "registerIdentity_11_256_3_4_600_248_1_1496_3_256"
SHA1 = "registerIdentity_3_160_3_4_600_248_0_0_1_0"
PSS384 = "registerIdentity_13_256_3_4_200_248_0_0_1_0"
BP384 = "registerIdentity_25_256_3_4_200_248_0_0_1_0"
AA320 = "registerIdentity_1_256_3_4_600_248_22_1496_3_256"
AA192 = "registerIdentity_10_256_3_4_600_248_23_1496_3_256"
FAST = (ECDSA, PSS, AA320, AA192)
SLOW = (SHA1, PSS384, BP384)
PUBLIC = ("passport_hash", "dg1_commitment", "pk_identity_hash",
          "dg15_pubkey_hash")


def _tiers(names):
    return [n if n in FAST else pytest.param(n, marks=pytest.mark.slow)
            for n in names]


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as d:
        return {k: d[k] for k in d.files}


def _arrays(fixture, name):
    tag = f"c{name.split('_')[1]}_"
    return {k[len(tag):]: v for k, v in fixture.items() if k.startswith(tag)}


def _inputs(arrays):
    passport = pv.PassportInputs(**{
        f: torch.as_tensor(arrays[f"in_{f}"].astype(np.int64))
        for f in pv.PassportInputs._fields})
    return ri.RegisterIdentityInputs(
        passport=passport,
        sk_identity=torch.as_tensor(arrays["in_sk_identity"].astype(
            np.int64)))


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


def test_fixture_holds_the_five_configs(fixture):
    assert [str(c) for c in fixture["configs"]][:5] == \
        [ECDSA, PSS] + list(SLOW)


def test_fixture_holds_the_ecdsa_active_auth_configs(fixture):
    """Active-auth keys over brainpoolP320r1 (320-bit field, 248 bits
    kept) and secp192r1 (kept whole), after the first five configs."""
    assert [str(c) for c in fixture["configs"]][5:] == [AA320, AA192]


@pytest.mark.parametrize("name", _tiers(FAST + SLOW))
def test_forward_matches_jax_fixture(fixture, name):
    arrays = _arrays(fixture, name)
    p = params.CircuitParams.from_name(name)
    got = convert.outputs_to_numpy(ri.forward(p, _inputs(arrays)))
    keys = sorted(k[4:] for k in arrays if k.startswith("out_"))
    assert set(keys) == {k for k, v in got.items() if v is not None}
    for k in keys:
        np.testing.assert_array_equal(got[k], arrays[f"out_{k}"], err_msg=k)
    for verdict in ("flow_ok", "sig_ok", "smt_ok"):
        assert got[verdict].all(), verdict


# the ECDSA config draws no RSA key (seconds of Python each), so its
# synthetic passports are cheap enough for the fast tier
@pytest.mark.parametrize("name", _tiers((ECDSA,)) + [
    pytest.param(n, marks=pytest.mark.slow)
    for n in (PSS, AA320, AA192) + SLOW])
def test_synthetic_ingest_and_oracles_match(fixture, name):
    """The port's synthetic generator and builder at the fixture's seed
    make the JAX package's inputs, and the fixture's public outputs equal
    the port's Python oracles on those passports."""
    arrays = _arrays(fixture, name)
    p = params.CircuitParams.from_name(name)
    pps = _passports(p, int(arrays["seed"]))
    np_inp = builder.build_register_inputs_numpy(p, pps)
    for f in np_inp.passport._fields:
        np.testing.assert_array_equal(getattr(np_inp.passport, f),
                                      arrays[f"in_{f}"], err_msg=f)
    np.testing.assert_array_equal(np_inp.sk_identity,
                                  arrays["in_sk_identity"])
    for out in PUBLIC:
        assert fr.batch_from_limbs(arrays[f"out_{out}"]) == \
            [synthetic.expected_outputs(p, pp)[out] for pp in pps], out


def test_ecdsa_flipped_signature_fails_its_lane_only():
    """ECDSA forward on the port's own passports (the JAX package's
    registerIdentity_20 p256 case of tests/test_register_variants.py, its
    dg15 without active auth): a flipped s fails sig_ok on its lane only,
    and the public outputs still equal the oracles."""
    p = params.CircuitParams.from_name(
        "registerIdentity_20_256_3_4_600_248_0_0_1_0")
    pps = _passports(p, 31)
    r, s = pps[1]["signature"]
    pps[1] = dict(pps[1], signature=(r, s ^ 1))
    out = ri.forward(p, builder.build_register_inputs(p, pps, "cpu"))
    assert out["sig_ok"].tolist() == [True, False]
    assert out["flow_ok"].all() and out["smt_ok"].all()
    for name in PUBLIC:
        assert fr.batch_from_limbs(out[name]) == \
            [synthetic.expected_outputs(p, pp)[name] for pp in pps], name


def test_dg_hash_wider_than_ec_hash_rejected():
    """SHA-256 DG hashes under a SHA-1 signature: the reference does not
    compile it, and the port's forward raises, as the JAX package's does."""
    p = params.CircuitParams.from_name(
        "registerIdentity_23_256_3_4_600_248_0_0_1_0")
    z = torch.zeros((16, 1), dtype=torch.int64)
    inp = pv.PassportInputs(
        dg1_words=torch.zeros((32, 1), dtype=torch.int64),
        dg15_words=z, ec_words=torch.zeros((64, 1), dtype=torch.int64),
        sa_words=torch.zeros((32, 1), dtype=torch.int64), signature=z,
        pubkey=torch.zeros((24, 1), dtype=torch.int64), pubkey_mu=z,
        slave_root=z, slave_branches=torch.zeros((16, 80, 1),
                                                 dtype=torch.int64))
    with pytest.raises(ValueError, match="DG hash"):
        pv.forward(p, inp)
