"""The port's host ingestion (``ingest/asn1``, ``x509``, ``passport``,
``masterlist``) against the JAX package's on the same bytes: DER round
trips, SOD parsing and SIG_ALGO detection for SIG_ALGO 1 (RSA PKCS#1
v1.5), 11 (RSA-PSS), 20 (ECDSA P-256) and 21 (ECDSA brainpoolP256r1),
certificates over RSA and EC keys, ``process_passport``'s parameters and
witness with and without a master list, and an 8-certificate master list
whose root and proofs equal the JAX package's and pass the port's
``ops/smt.verify`` on the CPU.

Both packages' SODs are built from the same seeds; where a builder draws
a key, both draw the same one. The RSA keys are drawn once for the module
(an RSA-2048 key takes seconds in Python).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ingest import asn1 as jasn1
from passport_zk_circuits_tpu.ingest import masterlist as jml
from passport_zk_circuits_tpu.ingest import passport as jpassport
from passport_zk_circuits_tpu.ingest import x509 as jx509
from passport_zk_circuits_tpu_torch.ingest import asn1, masterlist, passport
from passport_zk_circuits_tpu_torch.ingest import x509
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import smt
from passport_zk_circuits_tpu_torch.ops.curves import CURVES
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref
from passport_zk_circuits_tpu_torch.utils.rsa_keygen import gen_rsa_key

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def keys():
    """(RSA-2048 signer, which also signs the certificates; RSA-1024 AA)."""
    rng = random.Random(4101)
    return gen_rsa_key(2048, rng), gen_rsa_key(1024, rng)


def _dg1(seed):
    rng = random.Random(seed)
    return bytes(rng.randrange(256) for _ in range(93))


def test_asn1_round_trip_equals_the_jax_encoder():
    parts = [(m.integer(1234567890123456789), m.oid("1.2.840.113549.1.1.11"),
              m.der_set(m.octet_string(b"hello")), m.bit_string(b"\xff\x01"),
              m.octet_string(b"x" * 300), m.null())
             for m in (asn1, jasn1)]
    blob, jblob = asn1.seq(*parts[0]), jasn1.seq(*parts[1])
    assert blob == jblob
    node = asn1.parse(blob)
    assert node.tag == asn1.SEQUENCE
    assert node.child(0).as_int() == 1234567890123456789
    assert node.child(1).as_oid() == "1.2.840.113549.1.1.11"
    assert node.child(2).child(0).content == b"hello"
    assert node.child(3).content == b"\x00\xff\x01"
    assert node.child(4).content == b"x" * 300          # long-form length
    assert node.raw == blob


def test_x509_round_trip_rsa_and_ec(keys):
    (n, e, d), _ = keys
    ca = (n, e, d)
    cert = x509.build_certificate(x509.rsa_spki(n, e), "DS", "CSCA", ca)
    assert cert == jx509.build_certificate(jx509.rsa_spki(n, e), "DS",
                                           "CSCA", ca)
    assert x509.parse_certificate_pubkey(cert) == ("rsa", n, e)
    dk, (qx, qy) = ecdsa_ref.keygen(CURVES["brainpoolP256r1"],
                                    random.Random(4102))
    for explicit in (False, True):
        spki = x509.ec_spki("brainpoolP256r1", qx, qy, explicit)
        assert spki == jx509.ec_spki("brainpoolP256r1", qx, qy, explicit)
        cert = x509.build_certificate(spki, "DS", "CSCA", ca)
        assert x509.parse_certificate_pubkey(cert) == \
            jx509.parse_certificate_pubkey(cert) == \
            ("ecdsa", "brainpoolP256r1", (qx, qy))


def _sod(sig, keys, cert=True, port=True):
    """A SOD of SIG_ALGO sig over a fixed dg1 (and DG15 for SIG_ALGO 1),
    built by the port's or the JAX package's build_sod from one seed."""
    (signer, aa) = keys
    mod = passport if port else jpassport
    dg15 = mod.build_dg15_rsa(aa[0]) if sig == 1 else None
    key = signer if sig in (1, 11) else None
    sod, used = mod.build_sod(_dg1(sig), dg15, sig, 256,
                              random.Random(4200 + sig), signer_key=key,
                              with_certificate=cert)
    return dg15, sod, used


@pytest.mark.parametrize("sig,cert", [(1, True), (11, True), (20, True),
                                      (21, False)])
def test_parse_sod_and_detect_sig_algo(sig, keys, cert):
    dg15, sod, used = _sod(sig, keys, cert, port=False)
    parsed, jparsed = passport.parse_sod(sod), jpassport.parse_sod(sod)
    assert parsed == jparsed
    assert passport.detect_sig_algo(parsed) == \
        jpassport.detect_sig_algo(jparsed) == sig
    assert parsed["dg_hash_bits"] == parsed["sa_hash_bits"] == 256
    if sig in (20, 21):
        assert parsed["family"] == "ecdsa" and parsed["pubkey_q"] == used[1]
    else:
        assert parsed["pubkey_n"] == used[0]
        assert parsed["family"] == ("rsapss" if sig == 11 else "rsa")
    assert (parsed["cert_der"] is not None) == cert


@pytest.mark.parametrize("sig,cert", [(1, True), (11, True), (21, False)])
def test_build_sod_bytes_equal_the_jax_package(sig, keys, cert):
    assert _sod(sig, keys, cert)[1] == _sod(sig, keys, cert, port=False)[1]


def _certs(keys, n_ec):
    """The signer's RSA certificate and n_ec ECDSA ones (P-256 and
    brainpoolP256r1 in turns), all signed with the signer's key."""
    (signer, _) = keys
    rng = random.Random(4300)
    certs = [x509.build_certificate(x509.rsa_spki(signer[0], signer[1]),
                                    "DS", "CSCA", signer)]
    for i in range(n_ec):
        cv = CURVES["p256" if i % 2 else "brainpoolP256r1"]
        _, (qx, qy) = ecdsa_ref.keygen(cv, rng)
        certs.append(x509.build_certificate(x509.ec_spki(cv.name, qx, qy),
                                            "DS", "CSCA", signer))
    return certs


@pytest.mark.parametrize("sig,with_list", [
    (1, False), (11, False), (20, False), (21, False), (1, True),
    (11, True)])
def test_process_passport_equals_the_jax_package(sig, keys, with_list):
    """The master list holds the RSA signer's certificate: SIG_ALGO 1 and
    11 are ingested against it."""
    dg15, sod, _ = _sod(sig, keys, cert=sig != 21, port=False)
    aa = 1 if dg15 else 0
    kw, jkw = {"aa_algo": aa}, {"aa_algo": aa}
    if with_list:
        certs = _certs(keys, 3)
        kw["master_list"] = masterlist.build_master_list(certs)
        jkw["master_list"] = jml.build_master_list(certs)
    p, w = passport.process_passport(_dg1(sig), dg15, sod, **kw)
    jp, jw = jpassport.process_passport(_dg1(sig), dg15, sod, **jkw)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert p.name == jp.name and p.signature_type == sig
    assert w == jw
    if with_list:
        assert w["slave_root"] == kw["master_list"].root()
        assert any(w["slave_branches"])


def test_master_list_root_proofs_and_smt_verify(keys):
    certs = _certs(keys, 7)
    tree = masterlist.build_master_list(certs)
    jtree = jml.build_master_list(certs)
    hashes = [masterlist.pubkey_hash_of_cert(c) for c in certs]
    assert hashes == [jml.pubkey_hash_of_cert(c) for c in certs]
    assert len(set(hashes)) == 8 and tree.leaves == jtree.leaves
    assert tree.root() == jtree.root()
    proofs = [tree.prove(h) for h in hashes]
    assert proofs == [jtree.prove(h) for h in hashes]
    assert {r for r, _ in proofs} == {tree.root()}
    lim = lambda xs: bn.to_tensor(fr.batch_to_limbs(xs), CPU)  # noqa: E731
    sibs = bn.to_tensor(np.stack([fr.batch_to_limbs(s) for s in
                                  zip(*[b for _, b in proofs])], 1), CPU)
    ok, root = smt.verify(lim([tree.root()] * 8), lim(hashes), lim(hashes),
                          sibs)
    assert ok.tolist() == [True] * 8
    assert fr.batch_from_limbs(root) == [tree.root()] * 8
    # a wrong value fails
    ok, _ = smt.verify(lim([tree.root()] * 8), lim(hashes),
                       lim([h ^ 1 for h in hashes]), sibs)
    assert not ok.any()
    absent = max(hashes) + 1
    with pytest.raises(KeyError):
        tree.prove(absent)
    with pytest.raises(KeyError):
        jtree.prove(absent)
