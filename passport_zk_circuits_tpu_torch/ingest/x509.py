"""Minimal X.509 certificate building and parsing for the SOD pipeline.

The port's own copy of ``passport_zk_circuits_tpu/ingest/x509.py`` (the
same code, its imports pointed at the port's ``ops/curves`` and
``ops/rsa``). The reference pulls the document-signer public key out of
the SOD's ``[0] certificates`` branch (``test/process_passport.js``
extract_rsa_pubkey / extract_ecdsa_pubkey) and detects the ECDSA curve by
its prime. This module does both directions:

  * build: DS certificates (RSA / RSA-PSS / ECDSA), signed with an RSA
    key, good enough for the parser and for master-list construction;
  * parse: SPKI extraction returning ("rsa", n, e) or ("ecdsa",
    curve_name, (qx, qy)), with named-curve OIDs and explicit-parameter
    curves (matched against the registry by prime).
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

from . import asn1
from ..ops.curves import CURVES

# named-curve OIDs <-> registry names (subset the reference supports,
# signatureVerification.circom:177-261 catalog)
CURVE_OIDS = {
    "1.2.840.10045.3.1.7": "p256",
    "1.3.36.3.3.2.8.1.1.7": "brainpoolP256r1",
    "1.3.36.3.3.2.8.1.1.9": "brainpoolP320r1",
    "1.3.36.3.3.2.8.1.1.11": "brainpoolP384r1",
    "1.3.36.3.3.2.8.1.1.13": "brainpoolP512r1",
    "1.2.840.10045.3.1.1": "secp192r1",
    "1.3.132.0.33": "secp224r1",
    "1.3.132.0.34": "p384",
    "1.3.132.0.35": "p521",
    "1.3.132.0.10": "secp256k1",
}
OID_BY_CURVE = {v: k for k, v in CURVE_OIDS.items()}
_CURVE_BY_PRIME = {c.p: c.name for c in CURVES.values()}

OID_RSA_PSS = "1.2.840.113549.1.1.10"
OID_MGF1 = "1.2.840.113549.1.1.8"


# ---------------------------------------------------------------------------
# SPKI build / parse
# ---------------------------------------------------------------------------

def rsa_spki(n: int, e: int) -> bytes:
    return asn1.seq(
        asn1.seq(asn1.oid(asn1.OID_RSA_ENC), asn1.null()),
        asn1.bit_string(asn1.seq(asn1.integer(n), asn1.integer(e))))


def ec_spki(curve_name: str, qx: int, qy: int,
            explicit_params: bool = False) -> bytes:
    c = CURVES[curve_name]
    fb = (c.p.bit_length() + 7) // 8
    point = b"\x04" + qx.to_bytes(fb, "big") + qy.to_bytes(fb, "big")
    if explicit_params:
        # RFC 3279 ECParameters: version, fieldID(prime-field, p), curve
        # (a, b), base point, order, cofactor — the form the reference's
        # detect-by-prime handles.
        params = asn1.seq(
            asn1.integer(1),
            asn1.seq(asn1.oid("1.2.840.10045.1.1"), asn1.integer(c.p)),
            asn1.seq(asn1.octet_string(c.a.to_bytes(fb, "big")),
                     asn1.octet_string(c.b.to_bytes(fb, "big"))),
            asn1.octet_string(b"\x04" + c.gx.to_bytes(fb, "big")
                              + c.gy.to_bytes(fb, "big")),
            asn1.integer(c.n),
            asn1.integer(1))
    else:
        params = asn1.oid(OID_BY_CURVE[curve_name])
    return asn1.seq(
        asn1.seq(asn1.oid(asn1.OID_EC_PUBKEY), params),
        asn1.bit_string(point))


def parse_spki(spki: asn1.Node):
    """SPKI node -> ("rsa", n, e) | ("ecdsa", curve_name, (qx, qy))."""
    alg = spki.child(0)
    alg_oid = alg.child(0).as_oid()
    if alg_oid == asn1.OID_RSA_ENC:
        rsa_seq = asn1.parse(spki.child(1).content[1:])
        return ("rsa", rsa_seq.child(0).as_int(), rsa_seq.child(1).as_int())
    if alg_oid == asn1.OID_EC_PUBKEY:
        params = alg.child(1)
        if params.tag == asn1.OID:
            name = CURVE_OIDS[params.as_oid()]
        else:
            # explicit parameters: match the prime against the registry
            # (the reference's curve-detection trick)
            prime = params.child(1).child(1).as_int()
            name = _CURVE_BY_PRIME[prime]
        point = spki.child(1).content[1:]       # strip unused-bits byte
        assert point[0] == 0x04, "only uncompressed EC points"
        fb = (len(point) - 1) // 2
        qx = int.from_bytes(point[1:1 + fb], "big")
        qy = int.from_bytes(point[1 + fb:], "big")
        return ("ecdsa", name, (qx, qy))
    raise ValueError(f"unsupported SPKI algorithm {alg_oid}")


def pss_algorithm_identifier(hash_bits: int, salt_len: int) -> bytes:
    """RSASSA-PSS AlgorithmIdentifier with explicit hash/MGF1/salt params."""
    h = asn1.seq(asn1.oid(asn1.HASH_OID_BY_BITS[hash_bits]), asn1.null())
    return asn1.seq(asn1.oid(OID_RSA_PSS), asn1.seq(
        asn1.ctx(0, h),
        asn1.ctx(1, asn1.seq(asn1.oid(OID_MGF1), h)),
        asn1.ctx(2, asn1.integer(salt_len))))


def parse_pss_params(alg: asn1.Node) -> Tuple[int, int]:
    """PSS AlgorithmIdentifier -> (hash_bits, salt_len)."""
    hash_bits, salt_len = 160, 20                    # RFC 4055 defaults
    if len(alg.children) > 1:
        for blk in alg.child(1).children:
            if blk.tag == 0xA0:
                hash_bits = asn1.HASH_OIDS[blk.child(0).child(0).as_oid()]
            elif blk.tag == 0xA2:
                salt_len = blk.child(0).as_int()
    return hash_bits, salt_len


# ---------------------------------------------------------------------------
# Certificates
# ---------------------------------------------------------------------------

def _name(common_name: str) -> bytes:
    return asn1.seq(asn1.der_set(asn1.seq(
        asn1.oid("2.5.4.3"), asn1.tlv(0x0C, common_name.encode()))))


def _validity() -> bytes:
    return asn1.seq(asn1.tlv(0x17, b"250101000000Z"),
                    asn1.tlv(0x17, b"350101000000Z"))


def build_certificate(spki_der: bytes, subject: str, issuer: str,
                      signer, sig_hash_bits: int = 256,
                      serial: int = 1) -> bytes:
    """Self-contained X.509 v3 cert. `signer` is (n, e, d) RSA (the tbs
    signature is RSA PKCS#1 v1.5 — enough for parser/master-list fidelity)."""
    import hashlib
    from ..ops import rsa as rsa_ops
    n, e, d = signer
    sig_oid = {160: "1.2.840.113549.1.1.5", 256: "1.2.840.113549.1.1.11",
               384: "1.2.840.113549.1.1.12",
               512: "1.2.840.113549.1.1.13"}[sig_hash_bits]
    sig_alg = asn1.seq(asn1.oid(sig_oid), asn1.null())
    tbs = asn1.seq(
        asn1.ctx(0, asn1.integer(2)),                # v3
        asn1.integer(serial),
        sig_alg,
        _name(issuer),
        _validity(),
        _name(subject),
        spki_der)
    hname = {160: "sha1", 256: "sha256", 384: "sha384", 512: "sha512"}
    digest = hashlib.new(hname[sig_hash_bits], tbs).digest()
    key_bits = ((n.bit_length() + 7) // 8) * 8
    sig_int = rsa_ops.sign_pkcs1v15(digest, d, n, key_bits)
    return asn1.seq(tbs, sig_alg,
                    asn1.bit_string(sig_int.to_bytes(key_bits // 8, "big")))


def extract_spki(cert_der: bytes) -> asn1.Node:
    """DS certificate -> SPKI node (the [0] certificates walk of
    process_passport.js:439-452)."""
    cert = asn1.parse(cert_der)
    tbs = cert.child(0)
    # SPKI is the field after subject: skip optional [0] version
    idx = 5 if tbs.child(0).tag == 0xA0 else 4
    spki = tbs.child(idx + 1)
    # sanity: must look like AlgorithmIdentifier + BIT STRING
    assert spki.child(1).tag == asn1.BIT_STRING
    return spki


def parse_certificate_pubkey(cert_der: bytes):
    """DS certificate -> parse_spki result."""
    return parse_spki(extract_spki(cert_der))
