"""Batched RSA signature verification (PKCS#1 v1.5) over 16-bit limbs.

Counterpart of ``passport_zk_circuits_tpu/ops/rsa.py``: modexp, then the
encoded message EMSA-PKCS1-v1_5 is built from the in-graph digest and the
static DER prefix and compared limb for limb (the full EM, as the JAX
package checks it).
"""

from __future__ import annotations

import torch

from . import bignum as bn

# DER DigestInfo prefixes (EMSA-PKCS1-v1_5, RFC 8017 §9.2 notes)
DIGEST_INFO = {
    160: bytes.fromhex("3021300906052b0e03021a05000414"),
    224: bytes.fromhex("302d300d06096086480165030402040500041c"),
    256: bytes.fromhex("3031300d060960864801650304020105000420"),
    384: bytes.fromhex("3041300d060960864801650304020205000430"),
    512: bytes.fromhex("3051300d060960864801650304020305000440"),
}


def expected_em_limbs(digest_words, hash_len: int, key_bits: int):
    """EMSA-PKCS1-v1_5 encoded message as (k, *B) 16-bit limbs:
    0x00 0x01 FF..FF 0x00 || DigestInfo || H. digest_words: big-endian
    digest words, (w, *B) 32-bit words for any hash, or for SHA-384/512
    also (w, 2, *B) hi/lo pairs as ``sha2.sha384_chunks`` returns them."""
    digest_words = flat_digest_words(digest_words, hash_len)
    n_bytes = key_bits // 8
    h_bytes = hash_len // 8
    prefix = DIGEST_INFO[hash_len]
    ps_len = n_bytes - 3 - len(prefix) - h_bytes
    if ps_len < 8:
        raise ValueError("key too small for digest")
    bshape = digest_words.shape[1:]
    head = [0x00, 0x01] + [0xFF] * ps_len + [0x00] + list(prefix)
    const = torch.tensor(head, dtype=torch.int64, device=digest_words.device)
    const = const.reshape((len(head),) + (1,) * len(bshape)).expand(
        (len(head),) + tuple(bshape))
    idx = torch.arange(h_bytes, device=digest_words.device)
    sh = (8 * (3 - idx % 4)).reshape((h_bytes,) + (1,) * len(bshape))
    digest = (digest_words[idx // 4] >> sh) & 0xFF
    em = torch.cat([const, digest])                    # big-endian bytes
    be16 = (em[0::2] << 8) | em[1::2]                  # big-endian limbs
    return be16.flip(0)


def flat_digest_words(digest_words, hash_len: int):
    """(w, 2, *B) hi/lo digest pairs of SHA-384/512 -> (2w, *B) 32-bit
    words; 32-bit word tensors pass through."""
    if digest_words.shape[0] * 64 == hash_len:
        return digest_words.reshape((digest_words.shape[0] * 2,)
                                    + digest_words.shape[2:])
    return digest_words


def verify_pkcs1v15(signature, pubkey, mu, digest_words, hash_len: int,
                    key_bits: int, exp: int = 65537):
    """Batched RsaVerifyPkcs1v15. signature, pubkey: (k, *B) 16-bit limbs
    (k = key_bits / 16); mu: (k+1, *B) Barrett constant of the modulus;
    digest_words: big-endian hash words. Returns bool (*B,)."""
    em = _mod_pow(signature, exp, pubkey, mu)
    return bn.eq(em, expected_em_limbs(digest_words, hash_len, key_bits))


def _mod_pow(signature, exp, pubkey, mu):
    """Verification modexp. Dispatch: the kernel wrapper takes a CUDA
    tensor to the hand-written kernel (any exponent) and a CPU tensor to
    the plain version."""
    from . import cuda_rsa
    return cuda_rsa.pow_mod(signature, pubkey, mu, exp)


# -- host-side helpers for fixtures/tests -----------------------------------

def emsa_pkcs1_v15_encode(digest: bytes, key_bits: int) -> int:
    """Host oracle: EM as an integer."""
    prefix = DIGEST_INFO[len(digest) * 8]
    n_bytes = key_bits // 8
    ps = b"\xff" * (n_bytes - 3 - len(prefix) - len(digest))
    em = b"\x00\x01" + ps + b"\x00" + prefix + digest
    return int.from_bytes(em, "big")


def sign_pkcs1v15(digest: bytes, d: int, n: int, key_bits: int) -> int:
    """Host oracle: a valid signature made with the private exponent."""
    return pow(emsa_pkcs1_v15_encode(digest, key_bits), d, n)
