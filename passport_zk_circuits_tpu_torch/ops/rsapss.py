"""Batched RSA-PSS signature verification (EMSA-PSS, MGF1) over 16-bit limbs.

Counterpart of ``passport_zk_circuits_tpu/ops/rsapss.py``: the modexp, then
the EM bytes, the 0xBC check, the MGF1 mask over H, the XOR, the salt and
H' = hash(0^64 || mHash || salt). As in the JAX package, DB's padding bytes
must be zero and the 0x01 separator present (RFC 8017 §9.1.2 steps 10-11),
which is stricter than the reference circuit.

On the card the modexp is K2 (``ops/cuda_rsa``) and every SHA-224/256 of
MGF1 and of M' is K1's per-message entry, through ``sha2.sha_hash_byte_rows``;
SHA-1/384/512 are plain PyTorch.
"""

from __future__ import annotations

import hashlib
import struct

import torch

from . import rsa
from . import sha2

_HASH_NAME = {160: "sha1", 256: "sha256", 384: "sha384", 512: "sha512"}


def em_bytes(em_limbs, n_bytes: int):
    """Big-endian bytes (n_bytes, *B) of a little-endian 16-bit limb tensor."""
    le = torch.stack([em_limbs & 0xFF, em_limbs >> 8], 1)   # (k, 2, *B)
    return le.reshape((n_bytes,) + em_limbs.shape[1:]).flip(0)


def mgf1(seed_bytes, out_len: int, algo: int, bshape):
    """MGF1 mask: the concatenation of hash(seed || counter) blocks, cut to
    out_len bytes. seed_bytes: per-byte rows ((*B,) tensors). Returns an
    (out_len, *B) byte tensor."""
    h_bytes = algo // 8
    seed = list(seed_bytes)
    out = [sha2.sha_hash_byte_rows(seed + list(struct.pack(">I", c)), algo,
                                   bshape)
           for c in range(-(-out_len // h_bytes))]
    return torch.cat(out)[:out_len]


def verify_pss(signature, pubkey, mu, digest_words, hash_len: int,
               key_bits: int, salt_len: int, exp: int = 65537):
    """Batched VerifyRsaPssSig. digest_words = mHash (the SA digest), 32-bit
    words or SHA-384/512 hi/lo pairs. Returns bool (*B,)."""
    em = rsa._mod_pow(signature, exp, pubkey, mu)
    n_bytes = key_bits // 8
    h_bytes = hash_len // 8
    bshape = em.shape[1:]

    eb = em_bytes(em, n_bytes)
    ok = eb[-1] == 0xBC

    db_len = n_bytes - h_bytes - 1
    H = eb[db_len:db_len + h_bytes]
    db = eb[:db_len] ^ mgf1(list(H), db_len, hash_len, bshape)
    # clear the top (8*emLen - emBits) = 1 bit (key_bits a multiple of 8)
    db[0] &= 0x7F

    # PS zeros + 0x01 separator (RFC 8017 §9.1.2; stricter than the reference)
    sep = db_len - salt_len - 1
    ok = ok & (db[:sep] == 0).all(0) & (db[sep] == 0x01)
    salt = db[sep + 1:]

    flat = rsa.flat_digest_words(digest_words, hash_len)
    j = torch.arange(h_bytes, device=flat.device)
    sh = (8 * (3 - j % 4)).reshape((h_bytes,) + (1,) * len(bshape))
    mhash = (flat[j // 4] >> sh) & 0xFF

    m_prime = [0] * 8 + list(mhash) + list(salt)
    h_prime = sha2.sha_hash_byte_rows(m_prime, hash_len, bshape)
    return ok & (H == h_prime).all(0)


# -- host-side oracles -------------------------------------------------------

def emsa_pss_encode(mhash: bytes, key_bits: int, salt: bytes) -> int:
    """Host oracle: the EMSA-PSS encoded message as an integer."""
    name = _HASH_NAME[len(mhash) * 8]
    n_bytes = key_bits // 8
    db_len = n_bytes - len(mhash) - 1
    H = hashlib.new(name, b"\x00" * 8 + mhash + salt).digest()
    db = b"\x00" * (db_len - len(salt) - 1) + b"\x01" + salt
    masked = bytes(a ^ b for a, b in zip(db, _mgf1_host(H, db_len, name)))
    masked = bytes([masked[0] & 0x7F]) + masked[1:]
    return int.from_bytes(masked + H + b"\xbc", "big")


def _mgf1_host(seed: bytes, out_len: int, name: str) -> bytes:
    out = b""
    c = 0
    while len(out) < out_len:
        out += hashlib.new(name, seed + struct.pack(">I", c)).digest()
        c += 1
    return out[:out_len]


def sign_pss(mhash: bytes, d: int, n: int, key_bits: int, salt_len: int,
             rng) -> int:
    """Host oracle: a valid signature, the salt drawn from `rng` as the JAX
    package draws it."""
    salt = bytes(rng.randrange(256) for _ in range(salt_len))
    return pow(emsa_pss_encode(mhash, key_bits, salt), d, n)
