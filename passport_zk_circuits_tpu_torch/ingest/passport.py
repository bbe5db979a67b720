"""Passport ingestion: SOD parsing, algorithm detection, shift discovery.

The port's own copy of ``passport_zk_circuits_tpu/ingest/passport.py``
(the same code, its imports pointed at the port: ``models/params``,
``ops/rsa``, ``ops/rsapss``, ``ops/curves``, ``utils/poseidon_ref``,
``utils/rsa_keygen``, ``utils/ecdsa_ref`` and ``ingest/synthetic``'s
pubkey-hash oracles). The counterpart of the reference's
``processPassport`` (``test/process_passport.js``): decode the SOD, extract
the encapsulated content, signed attributes, signature and signer public
key, classify the SIG_ALGO (getSigType), find the digest shifts, and emit
the circuit parameters and the witness inputs. ``build_sod`` makes a
synthetic SOD so the pipeline runs without real passports.
"""

from __future__ import annotations

import hashlib
import random
from typing import Optional, Tuple

from . import asn1
from . import x509
from .synthetic import rsa_pubkey_hash_oracle, ecdsa_pubkey_hash_oracle
from ..models.params import CircuitParams, SIG_ALGOS
from ..utils import poseidon_ref as pref
from ..utils.rsa_keygen import gen_rsa_key
from ..ops import rsa as rsa_ops

_HASH_NAME = {160: "sha1", 224: "sha224", 256: "sha256",
              384: "sha384", 512: "sha512"}


def _hash(data: bytes, bits: int) -> bytes:
    return hashlib.new(_HASH_NAME[bits], data).digest()


def _block_bits(hash_bits: int) -> int:
    return 1024 if hash_bits in (384, 512) else 512


def _padded_blocks(data_len_bytes: int, block_bits: int) -> int:
    bb = block_bits // 8
    lenfield = 8 if block_bits == 512 else 16
    total = data_len_bytes + 1 + lenfield
    return -(-total // bb)


# ---------------------------------------------------------------------------
# Synthetic SOD builder (DER) — the test stand-in for real passports
# ---------------------------------------------------------------------------

def build_sod(dg1: bytes, dg15: Optional[bytes], sig_algo_id: int,
              dg_hash_type: int, rng: random.Random,
              signer_key=None, with_certificate: bool = True
              ) -> Tuple[bytes, tuple]:
    """Builds a minimal CMS SignedData SOD over the data groups, with the
    document-signer key carried in a real `[0] certificates` X.509 block
    (with_certificate=True, the reference's layout) or a bare `[1]` SPKI
    stash. Supports RSA, RSA-PSS, and ECDSA SIG_ALGOs.

    Returns (sod_der, signer_key)."""
    algo = SIG_ALGOS[sig_algo_id]
    if algo.family == "ecdsa":
        from ..ops.curves import CURVES
        from ..utils import ecdsa_ref
        curve = CURVES[algo.curve]
        if signer_key is None:
            signer_key = ecdsa_ref.keygen(curve, rng)
        d_ec, (qx, qy) = signer_key
    else:
        if signer_key is None:
            signer_key = gen_rsa_key(algo.key_bits, rng, algo.exp)
        n, e, d = signer_key

    dg_hashes = [asn1.seq(asn1.integer(1),
                          asn1.octet_string(_hash(dg1, dg_hash_type)))]
    if dg15 is not None:
        dg_hashes.append(asn1.seq(asn1.integer(15),
                                  asn1.octet_string(_hash(dg15, dg_hash_type))))
    lds_so = asn1.seq(
        asn1.integer(0),
        asn1.seq(asn1.oid(asn1.HASH_OID_BY_BITS[dg_hash_type]), asn1.null()),
        asn1.seq(*dg_hashes))

    sa_hash_bits = algo.hash_len
    # algo 24 (secp224r1/SHA-224 signature) hashes the EC with SHA-256
    # (signatureVerification.circom:96-101 quirk)
    ec_digest = _hash(lds_so, 256 if sig_algo_id == 24 else sa_hash_bits)
    signed_attrs_content = b"".join([
        asn1.seq(asn1.oid(asn1.OID_CONTENT_TYPE),
                 asn1.der_set(asn1.oid(asn1.OID_ICAO_LDS_SOD))),
        asn1.seq(asn1.oid(asn1.OID_MESSAGE_DIGEST),
                 asn1.der_set(asn1.octet_string(ec_digest))),
    ])
    # signed form uses the SET tag; embedded form uses [0] IMPLICIT
    sa_set = asn1.tlv(asn1.SET, signed_attrs_content)
    sa_impl = asn1.tlv(0xA0, signed_attrs_content)

    sa_digest = _hash(sa_set, sa_hash_bits)
    if algo.family == "rsa":
        sig_int = rsa_ops.sign_pkcs1v15(sa_digest, d, n, algo.key_bits)
        signature = sig_int.to_bytes(algo.key_bits // 8, "big")
        sig_oid = {160: "1.2.840.113549.1.1.5",
                   256: "1.2.840.113549.1.1.11",
                   384: "1.2.840.113549.1.1.12",
                   512: "1.2.840.113549.1.1.13"}[sa_hash_bits]
        sig_alg = asn1.seq(asn1.oid(sig_oid), asn1.null())
        spki = x509.rsa_spki(n, e)
    elif algo.family == "rsapss":
        from ..ops import rsapss
        sig_int = rsapss.sign_pss(sa_digest, d, n, algo.key_bits,
                                  algo.salt_len, rng)
        signature = sig_int.to_bytes(algo.key_bits // 8, "big")
        sig_alg = x509.pss_algorithm_identifier(sa_hash_bits, algo.salt_len)
        spki = x509.rsa_spki(n, e)
    else:
        from ..utils import ecdsa_ref
        r_val, s_val = ecdsa_ref.sign(curve, d_ec, sa_digest, rng)
        signature = asn1.seq(asn1.integer(r_val), asn1.integer(s_val))
        sig_oid = {160: "1.2.840.10045.4.1", 224: "1.2.840.10045.4.3.1",
                   256: "1.2.840.10045.4.3.2",
                   384: "1.2.840.10045.4.3.3"}[sa_hash_bits]
        sig_alg = asn1.seq(asn1.oid(sig_oid))
        spki = x509.ec_spki(algo.curve, qx, qy)

    digest_alg = asn1.seq(asn1.oid(asn1.HASH_OID_BY_BITS[sa_hash_bits]),
                          asn1.null())
    signer_info = asn1.seq(
        asn1.integer(1),
        asn1.seq(asn1.octet_string(b"synthetic-issuer"), asn1.integer(1)),
        digest_alg,
        sa_impl,
        sig_alg,
        asn1.octet_string(signature))
    blocks = [
        asn1.integer(3),
        asn1.der_set(digest_alg),
        asn1.seq(asn1.oid(asn1.OID_ICAO_LDS_SOD),
                 asn1.ctx(0, asn1.octet_string(lds_so))),
    ]
    if with_certificate:
        # real layout: [0] certificates holding the DS certificate
        cert_signer = signer_key if algo.family != "ecdsa" else \
            gen_rsa_key(2048, rng)
        cert = x509.build_certificate(spki, "synthetic-DS",
                                      "synthetic-CSCA", cert_signer)
        blocks.append(asn1.ctx(0, cert))
    else:
        blocks.append(asn1.ctx(1, spki))
    blocks.append(asn1.der_set(signer_info))
    sod = asn1.seq(asn1.oid(asn1.OID_SIGNED_DATA),
                   asn1.ctx(0, asn1.seq(*blocks)))
    return sod, signer_key


# ---------------------------------------------------------------------------
# Parsing + detection
# ---------------------------------------------------------------------------

def parse_sod(sod: bytes) -> dict:
    """Extracts the witness-relevant pieces of a SOD (parse_sod analog of
    extract_encapsulated_content / extract_signed_atributes /
    extract_signature / extract_*_pubkey, process_passport.js:286-490)."""
    root = asn1.parse(sod)
    assert root.child(0).as_oid() == asn1.OID_SIGNED_DATA
    sd = root.child(1).child(0)                      # SignedData

    encap = sd.child(2)
    ec = asn1.parse(encap.child(1).content).content  # [0] { OCTET STRING }
    # dg hash algorithm from the LDSSecurityObject
    lds = asn1.parse(ec)
    dg_hash_bits = asn1.HASH_OIDS[lds.child(1).child(0).as_oid()]

    # [0] certificates (real X.509, extract SPKI from the DS cert) or the
    # bare [1] SPKI stash used by certificate-less synthetic SODs
    pubkey = None                   # ("rsa", n, e) | ("ecdsa", name, (x,y))
    cert_der = None
    idx = 3
    while sd.child(idx).tag in (0xA0, 0xA1):
        blk = sd.child(idx)
        if blk.tag == 0xA0:
            cert_node = (blk.children[0] if blk.children
                         else asn1.parse(blk.content))
            cert_der = cert_node.raw
            pubkey = x509.parse_spki(x509.extract_spki(cert_der))
        else:
            spki = blk.children[0] if blk.children else asn1.parse(blk.content)
            pubkey = x509.parse_spki(spki)
        idx += 1
    signer_info = sd.child(idx).child(0)

    sa_hash_bits = asn1.HASH_OIDS[signer_info.child(2).child(0).as_oid()]
    sa_node = signer_info.child(3)                   # [0] IMPLICIT
    assert sa_node.tag == 0xA0
    sa = asn1.tlv(asn1.SET, sa_node.content)         # signed form
    sig_alg = signer_info.child(4)
    sig_alg_oid = sig_alg.child(0).as_oid()
    family, _ = asn1.SIG_OIDS.get(sig_alg_oid, ("rsa", None))
    salt_len = None
    if sig_alg_oid == x509.OID_RSA_PSS:
        sa_hash_bits, salt_len = x509.parse_pss_params(sig_alg)
    if family == "ecdsa":
        rs = asn1.parse(signer_info.child(5).content)
        signature = (rs.child(0).as_int(), rs.child(1).as_int())
    else:
        signature = signer_info.child(5).as_int()

    out = {
        "ec": ec, "sa": sa, "signature": signature,
        "dg_hash_bits": dg_hash_bits, "sa_hash_bits": sa_hash_bits,
        "family": family, "salt_len": salt_len, "cert_der": cert_der,
        "pubkey_n": None, "pubkey_e": None, "curve": None, "pubkey_q": None,
    }
    if pubkey is not None:
        if pubkey[0] == "rsa":
            out["pubkey_n"], out["pubkey_e"] = pubkey[1], pubkey[2]
        else:
            out["curve"], out["pubkey_q"] = pubkey[1], pubkey[2]
    return out


def detect_sig_algo(parsed: dict) -> int:
    """getSigType analog (process_passport.js:157-244), all families."""
    fam = parsed["family"]
    if fam == "ecdsa":
        for algo in SIG_ALGOS.values():
            if algo.family == "ecdsa" and algo.curve == parsed["curve"]:
                return algo.id
        raise ValueError(f"unsupported ECDSA curve {parsed['curve']}")
    n_bits = parsed["pubkey_n"].bit_length()
    key_bits = (3072 if n_bits in (3071, 3072)
                else 1 << (n_bits - 1).bit_length())
    for algo in SIG_ALGOS.values():
        if (algo.family == fam
                and algo.key_bits == key_bits
                and algo.hash_len == parsed["sa_hash_bits"]
                and algo.exp == parsed["pubkey_e"]
                and (fam != "rsapss" or algo.salt_len == parsed["salt_len"])):
            return algo.id
    raise ValueError("unsupported signature algorithm combination")


def find_shift(container: bytes, digest: bytes) -> int:
    """Bit offset of `digest` inside `container` (getDg1Shift analog,
    process_passport.js:294-301)."""
    idx = container.find(digest)
    if idx < 0:
        raise ValueError("digest not found in container")
    return idx * 8


def process_passport(dg1: bytes, dg15: Optional[bytes], sod: bytes,
                     sk_identity: Optional[int] = None,
                     aa_algo: int = 1,
                     master_list=None) -> Tuple[CircuitParams, dict]:
    """Full processPassport analog: returns (CircuitParams, witness dict
    compatible with ingest.builder.build_register_inputs).

    master_list: optional ingest.masterlist.SparseMerkleTree holding DS
    pubkey hashes — when given, the witness carries a REAL inclusion proof
    against it instead of the fabricated 1-leaf anchors."""
    parsed = parse_sod(sod)
    dg_hash = parsed["dg_hash_bits"]
    sig_id = detect_sig_algo(parsed)
    algo = SIG_ALGOS[sig_id]

    ec, sa = parsed["ec"], parsed["sa"]
    dg1_shift = find_shift(ec, _hash(dg1, dg_hash))
    dg15_shift = find_shift(ec, _hash(dg15, dg_hash)) if dg15 else 0
    ec_shift = find_shift(sa, _hash(ec, 256 if sig_id == 24
                                    else algo.hash_len))

    sig_block = _block_bits(algo.hash_len)
    dg_block = _block_bits(dg_hash)
    params = CircuitParams(
        signature_type=sig_id,
        dg_hash_type=dg_hash,
        document_type=3 if len(dg1) == 93 else 1,
        ec_block_number=_padded_blocks(len(ec), sig_block),
        ec_shift=ec_shift,
        dg1_shift=dg1_shift,
        aa_signature_algo=aa_algo if dg15 else 0,
        dg15_shift=dg15_shift,
        dg15_block_number=_padded_blocks(len(dg15), dg_block) if dg15 else 1,
        aa_shift=_find_aa_shift(dg15) if dg15 else 0,
    )

    # trust anchors: either a real master-list proof, or the fabricated
    # 1-leaf SMT mirroring getFakeIdenData (process_passport.js:628-657,
    # skIdentity from SHA-256(ec))
    if sk_identity is None:
        sk_identity = int.from_bytes(hashlib.sha256(ec).digest(),
                                     "big") % pref.P
    if algo.family == "ecdsa":
        from ..ops.curves import CURVES
        qx, qy = parsed["pubkey_q"]
        pubkey_hash = ecdsa_pubkey_hash_oracle(
            qx, qy, CURVES[parsed["curve"]].p.bit_length())
        pubkey = parsed["pubkey_q"]
    else:
        pubkey_hash = rsa_pubkey_hash_oracle(parsed["pubkey_n"])
        pubkey = parsed["pubkey_n"]
    if master_list is not None:
        slave_root, slave_branches = master_list.prove(pubkey_hash)
    else:
        slave_root = pref.poseidon([pubkey_hash, pubkey_hash, 1])
        slave_branches = [0] * 80

    witness = {
        "dg1": dg1, "dg15": dg15 or b"", "ec": ec, "sa": sa,
        "signature": parsed["signature"], "pubkey": pubkey,
        "sk_identity": sk_identity,
        "slave_root": slave_root, "slave_branches": slave_branches,
    }
    return params, witness


def _find_aa_shift(dg15: bytes) -> int:
    """Locate the RSA-1024 AA modulus inside DG15 (extractFromDg15 analog,
    process_passport.js:492-571): the INTEGER payload of the embedded SPKI."""
    node = asn1.parse(dg15)
    # walk: DG15 application tag wraps an SPKI; find the BIT STRING
    def find_bitstring(n):
        if n.tag == asn1.BIT_STRING:
            return n
        for c in n.children:
            r = find_bitstring(c)
            if r is not None:
                return r
        return None
    bs = find_bitstring(node)
    rsa_seq = asn1.parse(bs.content[1:])
    modulus = rsa_seq.child(0)
    body = modulus.content.lstrip(b"\x00")
    off = dg15.find(body)
    return off * 8


def build_dg15_rsa(aa_n: int, aa_e: int = 65537) -> bytes:
    """DG15 blob: application tag 0x6F wrapping an RSA SPKI."""
    spki = asn1.seq(
        asn1.seq(asn1.oid(asn1.OID_RSA_ENC), asn1.null()),
        asn1.bit_string(asn1.seq(asn1.integer(aa_n), asn1.integer(aa_e))))
    return asn1.tlv(0x6F, spki)
