"""Synthetic passports + pure-Python output oracles, free of JAX.

Counterpart of ``passport_zk_circuits_tpu/ingest/synthetic.py`` for every
signature family (RSA PKCS#1 v1.5, RSA-PSS, ECDSA) and active-auth key (RSA
or ECDSA). Given the same ``random.Random`` state it draws the same numbers
in the same order, so it makes the same passports as the JAX package. It
uses the port's own copies of the parameter registry, the curve registry and
the Poseidon, BabyJubJub, ECDSA and RSA oracles (``models/params``,
``ops/curves``, ``utils/*``) and the port's RSA-PSS host oracle.
"""

from __future__ import annotations

import hashlib
import random

from ..ops import rsa as rsa_ops
from ..ops import rsapss
from ..ops.curves import CURVES
from ..models import params
from ..utils import babyjubjub_ref as bref
from ..utils import ecdsa_ref
from ..utils import poseidon_ref as pref
from ..utils import rsa_keygen

_HASH_NAME = {160: "sha1", 224: "sha224", 256: "sha256",
              384: "sha384", 512: "sha512"}


def _hash(data: bytes, algo: int) -> bytes:
    return hashlib.new(_HASH_NAME[algo], data).digest()


def _ec_hash_algo(p: params.CircuitParams) -> int:
    return 256 if p.signature_type == 24 else p.sig.hash_len


def _rand_bytes(rng: random.Random, n: int) -> bytes:
    return bytes(rng.randrange(256) for _ in range(n))


# ECDSA active-auth algo -> (curve, coordinate bytes)
AA_CURVES = {20: ("p256", 32), 21: ("brainpoolP256r1", 32),
             22: ("brainpoolP320r1", 40), 23: ("secp192r1", 24)}


def make_synthetic_passport(p: params.CircuitParams, rng: random.Random,
                            signer_key=None, aa_key=None) -> dict:
    """One synthetic passport consistent with `p`'s shifts: raw blobs (dg1,
    dg15, ec, sa), the signer's public key (RSA modulus, or ECDSA (X, Y))
    and signature (an int, or ECDSA (r, s)), sk_identity and the slave-SMT
    anchors (a one-leaf tree, all siblings zero)."""
    sig = p.sig
    if sig.family == "ecdsa":
        curve = CURVES[sig.curve]
        if signer_key is None:
            signer_key = ecdsa_ref.keygen(curve, rng)
        d_ec, q_ec = signer_key
    else:
        if signer_key is None:
            signer_key = rsa_keygen.gen_rsa_key(sig.key_bits, rng, sig.exp)
        n, _, d = signer_key

    dg_hb = p.dg_hash_block_size
    sig_hb = p.sig_hash_block_size
    dgh_bytes = p.dg_hash_type // 8

    # DG1: TD3 = 93 bytes MRZ, TD1 = 95 bytes
    dg1 = _rand_bytes(rng, 93 if p.document_type == 3 else 95)

    # DG15: active-auth public-key blob, at aa_shift the RSA-1024 modulus or
    # the ECDSA key's X then Y
    dg15 = b""
    if p.aa_signature_algo != 0:
        cap = p.dg15_block_number * dg_hb // 8 - (9 if dg_hb == 512 else 17)
        body = bytearray(_rand_bytes(rng, cap))
        off = p.aa_shift // 8
        if p.aa_signature_algo < 20:
            if aa_key is None:
                aa_key = rsa_keygen.gen_rsa_key(1024, rng)
            body[off:off + 128] = aa_key[0].to_bytes(128, "big")
        else:
            aa_curve, fb = AA_CURVES[p.aa_signature_algo]
            if aa_key is None:
                aa_key = ecdsa_ref.keygen(CURVES[aa_curve], rng)
            qx, qy = aa_key[1]
            body[off:off + fb] = qx.to_bytes(fb, "big")
            body[off + fb:off + 2 * fb] = qy.to_bytes(fb, "big")
        dg15 = bytes(body)

    # encapsulated content: digests of dg1/dg15 at the compile-time shifts
    ec_algo = _ec_hash_algo(p)
    ec_cap = p.ec_block_number * sig_hb // 8 - (9 if sig_hb == 512 else 17)
    ec_min = p.dg1_shift // 8 + dgh_bytes
    if p.aa_signature_algo != 0:
        ec_min = max(ec_min, p.dg15_shift // 8 + dgh_bytes)
    if ec_min > ec_cap:
        raise ValueError(f"shifts {p.dg1_shift}/{p.dg15_shift} don't fit "
                         f"{p.ec_block_number} blocks")
    ec = bytearray(_rand_bytes(rng, ec_cap))
    ec[p.dg1_shift // 8:p.dg1_shift // 8 + dgh_bytes] = _hash(dg1, p.dg_hash_type)
    if p.aa_signature_algo != 0:
        ec[p.dg15_shift // 8:p.dg15_shift // 8 + dgh_bytes] = \
            _hash(dg15, p.dg_hash_type)
        ec[p.dg15_shift // 8 - 3] = 0x0F
    ec = bytes(ec)

    # signed attributes: digest of encapsulated content at ec_shift
    ech_bytes = ec_algo // 8
    sa_cap = 1024 // 8 - (9 if sig_hb == 512 else 17)
    if p.ec_shift // 8 + ech_bytes > sa_cap:
        raise ValueError(f"ec_shift {p.ec_shift} does not fit the SA blob")
    sa = bytearray(_rand_bytes(rng, sa_cap))
    sa[p.ec_shift // 8:p.ec_shift // 8 + ech_bytes] = _hash(ec, ec_algo)
    sa = bytes(sa)

    sa_digest = _hash(sa, sig.hash_len)
    if sig.family == "rsa":
        signature = rsa_ops.sign_pkcs1v15(sa_digest, d, n, sig.key_bits)
        pubkey = n
        pubkey_hash = rsa_pubkey_hash_oracle(n)
    elif sig.family == "rsapss":
        signature = rsapss.sign_pss(sa_digest, d, n, sig.key_bits,
                                    sig.salt_len, rng)
        pubkey = n
        pubkey_hash = rsa_pubkey_hash_oracle(n)
    else:
        signature = ecdsa_ref.sign(curve, d_ec, sa_digest, rng)  # (r, s)
        pubkey = q_ec                                            # (X, Y)
        pubkey_hash = ecdsa_pubkey_hash_oracle(q_ec[0], q_ec[1],
                                               sig.key_bits // 2)
    sk_identity = rng.randrange(1, pref.P)

    return {
        "dg1": dg1, "dg15": dg15, "ec": ec, "sa": sa,
        "signature": signature, "pubkey": pubkey,
        "sk_identity": sk_identity,
        "slave_root": pref.poseidon([pubkey_hash, pubkey_hash, 1]),
        "slave_branches": [0] * 80,
        "signer_key": signer_key, "aa_key": aa_key,
    }


# ---------------------------------------------------------------------------
# Pure-Python output oracles (bit-exact expected values of the 4 outputs)
# ---------------------------------------------------------------------------

def _bits_list(data: bytes):
    return [(byte >> i) & 1 for byte in data for i in range(7, -1, -1)]


def reversed_bits_value(bits, start: int, n: int) -> int:
    """sum bits[start+j] << j (the reference's LSB-first Bits2Num wiring)."""
    return sum(bits[start + j] << j for j in range(n))


def be_bits_value(bits, start: int, n: int) -> int:
    """Big-endian recompose."""
    v = 0
    for j in range(n):
        v = (v << 1) | bits[start + j]
    return v


def passport_hash_oracle(sa: bytes, hash_len: int) -> int:
    bits = _bits_list(_hash(sa, hash_len))
    if hash_len >= 252:
        v = reversed_bits_value(bits, 0, 252)
    else:
        v = reversed_bits_value(bits, 0, hash_len) << (252 - hash_len)
    return pref.poseidon([v])


def rsa_pubkey_hash_oracle(n: int) -> int:
    """Poseidon5 of 5 x 192-bit little-endian-64 chunks."""
    l64 = [(n >> (64 * i)) & ((1 << 64) - 1)
           for i in range(n.bit_length() // 64 + 1)]
    l64 += [0] * (15 - len(l64))
    chunks = [(l64[3 * i] << 128) + (l64[3 * i + 1] << 64) + l64[3 * i + 2]
              for i in range(5)]
    return pref.poseidon(chunks)


def ecdsa_pubkey_hash_oracle(x: int, y: int, field_bits: int) -> int:
    """Poseidon2(X, Y), each cut to its low min(field, 248) bits."""
    mask = (1 << min(field_bits, 248)) - 1
    return pref.poseidon([x & mask, y & mask])


def dg1_commitment_oracle(dg1: bytes, document_type: int,
                          sk_identity: int) -> int:
    bits = _bits_list(dg1)
    cs = 186 if document_type == 3 else 190
    chunks = [reversed_bits_value(bits, i * cs, cs) for i in range(4)]
    return pref.poseidon(chunks + [pref.poseidon([sk_identity])])


def pk_identity_hash_oracle(sk_identity: int) -> int:
    x, y = bref.base8_mul(sk_identity % (1 << 254))
    return pref.poseidon([x, y])


def dg15_pubkey_hash_oracle(p: params.CircuitParams, dg15: bytes) -> int:
    aa = p.aa_signature_algo
    if aa == 0:
        return 0
    bits = _bits_list(dg15)
    if aa < 20:
        chunks = [be_bits_value(bits, p.aa_shift + j * 200, 200)
                  for j in range(4)]
        chunks.append(be_bits_value(bits, p.aa_shift + 800, 224))
        return pref.poseidon(chunks)
    field_size, keep = 256, 248
    if aa == 22:
        field_size = 320
    if aa == 23:
        field_size, keep = 192, 192
    xy = field_size - keep
    return pref.poseidon([be_bits_value(bits, p.aa_shift + xy, keep),
                          be_bits_value(bits, p.aa_shift + field_size + xy,
                                        keep)])


def expected_outputs(p: params.CircuitParams, pp: dict) -> dict:
    return {
        "passport_hash": passport_hash_oracle(pp["sa"], p.sig.hash_len),
        "dg1_commitment": dg1_commitment_oracle(
            pp["dg1"], p.document_type, pp["sk_identity"]),
        "pk_identity_hash": pk_identity_hash_oracle(pp["sk_identity"]),
        "dg15_pubkey_hash": dg15_pubkey_hash_oracle(p, pp["dg15"]),
    }
