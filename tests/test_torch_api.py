"""The port's public entry point on the CPU: ``api.ingest`` ->
``api.compile(params, torch.device("cpu"))`` -> ``api.generate_witness``
at batch 2 for SIG_ALGO 1 (RSA-2048 PKCS#1 v1.5, SHA-256, RSA-1024 active
auth) against a 4-leaf master list, its four outputs against
``ingest/synthetic``'s oracles and all three verdicts true; a flipped
signature bit fails ``sig_ok`` alone; ``api.compile`` with no device needs
a card; ``api.check`` on a small R1CS.

The port only: no JAX here (``test_torch_ingest.py`` holds ingest equal to
the JAX package's).
"""

import random

import pytest
import torch

from passport_zk_circuits_tpu_torch import api
from passport_zk_circuits_tpu_torch.circuit.builder import Builder
from passport_zk_circuits_tpu_torch.ingest import masterlist, passport
from passport_zk_circuits_tpu_torch.ingest import synthetic, x509
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops.curves import CURVES
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref
from passport_zk_circuits_tpu_torch.utils.rsa_keygen import gen_rsa_key

CPU = torch.device("cpu")
PUBLIC = ("passport_hash", "dg1_commitment", "pk_identity_hash",
          "dg15_pubkey_hash")


@pytest.fixture(scope="module")
def ingested():
    """Two passports of one signer, ingested against a master list of the
    signer's certificate and three ECDSA ones; lane 1's SOD has one bit of
    its signature flipped."""
    rng = random.Random(2718)
    signer = gen_rsa_key(2048, rng)
    aa = gen_rsa_key(1024, rng)
    certs = [x509.build_certificate(x509.rsa_spki(signer[0], signer[1]),
                                    "DS", "CSCA", signer)]
    for name in ("p256", "brainpoolP256r1", "p256"):
        _, (qx, qy) = ecdsa_ref.keygen(CURVES[name], rng)
        certs.append(x509.build_certificate(x509.ec_spki(name, qx, qy), "DS",
                                            "CSCA", signer))
    tree = masterlist.build_master_list(certs)
    dg15 = passport.build_dg15_rsa(aa[0])
    out = []
    for lane in range(2):
        dg1 = bytes(rng.randrange(256) for _ in range(93))
        sod, _ = passport.build_sod(dg1, dg15, 1, 256, rng,
                                    signer_key=signer)
        if lane == 1:
            sig = passport.parse_sod(sod)["signature"].to_bytes(256, "big")
            at = sod.index(sig) + 255
            sod = sod[:at] + bytes([sod[at] ^ 1]) + sod[at + 1:]
        out.append(api.ingest(dg1, dg15, sod, master_list=tree))
    return out, tree


def test_ingest_compile_generate_witness(ingested):
    (p, w0), (p1, w1) = ingested[0]
    tree = ingested[1]
    assert p == p1 and p.name.startswith("registerIdentity_1_256_3_")
    assert w0["slave_root"] == w1["slave_root"] == tree.root()
    assert any(w0["slave_branches"])
    circuit = api.compile(p, CPU)
    assert circuit.device == CPU and circuit.params == p
    out = api.generate_witness(circuit, [w0, w1])
    assert out["flow_ok"].tolist() == [True, True]
    assert out["smt_ok"].tolist() == [True, True]
    assert out["sig_ok"].tolist() == [True, False]
    for name in PUBLIC:
        assert fr.batch_from_limbs(out[name]) == [
            synthetic.expected_outputs(p, w)[name] for w in (w0, w1)], name


def test_compile_without_a_device_needs_a_card(ingested):
    p = ingested[0][0][0]
    if torch.cuda.is_available():
        assert api.compile(p).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            api.compile(p)


def test_ingest_raises_for_a_signer_not_in_the_list(ingested):
    sod, _ = passport.build_sod(bytes(93), None, 20, 256,
                                random.Random(2719), with_certificate=False)
    with pytest.raises(KeyError):
        api.ingest(bytes(93), None, sod, aa_algo=0,
                   master_list=ingested[1])


def test_check_a_small_r1cs():
    b = Builder(2)
    x = b.input([3, 4])
    b.finalize([x * x])
    w = torch.as_tensor(b.witness_matrix().astype("int64"))
    ok, _ = api.check(b.cs, w)
    assert ok.tolist() == [True, True]
    w[-1, 0, 0] += 1
    ok, _ = api.check(b.cs, w)
    assert ok.tolist() == [False, True]
