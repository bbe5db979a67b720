"""Batched PassportVerification: hash flow + signature + SMT inclusion.

Counterpart of ``passport_zk_circuits_tpu/models/passport_verification.py``
for every signature family: RSA PKCS#1 v1.5, RSA-PSS and ECDSA. The
faithfulness notes of the JAX module hold here too: only DG_HASH_TYPE bits
of each digest are compared at the byte-aligned shifts, `passportHash` is
the reversed-bit Bits2Num(252) recompose, and the slave-certificate SMT
verdict is returned, not enforced. The SHA-224/256 blobs are hashed in one
K1 launch; SHA-1/384/512 blobs take the plain hashes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bitops
from ..ops import field as fr
from ..ops import ecdsa
from ..ops import poseidon as pos
from ..ops import rsa
from ..ops import rsapss
from ..ops import sha2
from ..ops import smt
from . import params


class PassportInputs(NamedTuple):
    """Batched circuit inputs, int64 tensors: blobs are SHA-padded 32-bit
    word tensors (n_words, B); bignums are 16-bit limb tensors (k, B)."""
    dg1_words: torch.Tensor           # (32, B): 1024 bits padded
    dg15_words: torch.Tensor          # (dg15_blocks * 16, B)
    ec_words: torch.Tensor            # (ec_blocks * 16, B)
    sa_words: torch.Tensor            # (32, B): 1024 bits padded
    signature: torch.Tensor           # (k, B)
    pubkey: torch.Tensor              # (k, B) RSA modulus, or X || Y
    pubkey_mu: torch.Tensor           # (k+1, B) Barrett constant
    slave_root: torch.Tensor          # (16, B)
    slave_branches: torch.Tensor      # (16, 80, B)


def ec_hash_type(p: params.CircuitParams) -> int:
    """EC hash = signature hash except SIG_ALGO 24 (SHA-224 SA, SHA-256 EC)."""
    return 256 if p.signature_type == 24 else p.sig.hash_len


def passport_hash_from_sa_bits(sa_bits, hash_len: int):
    """Poseidon1 of the reversed-first-252-bits recompose."""
    if hash_len >= 252:
        lsb = sa_bits[:252]
    else:
        lsb = torch.cat([torch.zeros_like(sa_bits[:252 - hash_len]),
                         sa_bits[:hash_len]])
    return pos.poseidon([bitops.bits_to_fr(lsb, msb_first=False)])


def rsa_pubkey_hash(pubkey_l16):
    """Poseidon5 of 5 x 192-bit chunks of the low 15 64-bit limbs
    (little-endian): chunk i = l64[3i] 2^128 + l64[3i+1] 2^64 + l64[3i+2]."""
    chunks = []
    for i in range(5):
        limbs = torch.zeros_like(pubkey_l16[:fr.NLIMBS])
        limbs[8:12] = pubkey_l16[12 * i:12 * i + 4]
        limbs[4:8] = pubkey_l16[12 * i + 4:12 * i + 8]
        limbs[0:4] = pubkey_l16[12 * i + 8:12 * i + 12]
        chunks.append(limbs)
    return pos.poseidon(chunks)


def ecdsa_pubkey_hash(x_l16, y_l16, field_bits: int):
    """Poseidon2(X, Y), each coordinate cut to its low min(field, 248)
    bits."""
    keep = min(field_bits, 248)
    coords = []
    for coord in (x_l16, y_l16):
        limbs = coord.new_zeros((fr.NLIMBS,) + coord.shape[1:])
        full = keep // 16
        limbs[:full] = coord[:full]
        if keep % 16:
            limbs[full] = coord[full] & ((1 << (keep % 16)) - 1)
        coords.append(limbs)
    return pos.poseidon(coords)


def hash_blobs(blobs):
    """[(padded words (n_words, *B), algo)] -> [digest as (w, *B) 32-bit
    words]. The SHA-224/256 blobs go to K1 together, in one launch; the
    others to their plain hash, SHA-384/512 in hi/lo word pairs."""
    many = [i for i, (_, algo) in enumerate(blobs) if algo in (224, 256)]
    out = [None] * len(blobs)
    if many:
        digests = sha2.sha_hash_chunks_many([blobs[i][0] for i in many],
                                            [blobs[i][1] for i in many])
        for i, d in zip(many, digests):
            out[i] = d
    for i, (words, algo) in enumerate(blobs):
        if algo in (384, 512):
            dw = sha2.sha_hash_chunks(bitops.words32_to_words64(words), algo)
            out[i] = dw.reshape((dw.shape[0] * 2,) + dw.shape[2:])
        elif algo == 160:
            out[i] = sha2.sha_hash_chunks(words, algo)
    return out


def forward(p: params.CircuitParams, inp: PassportInputs):
    """Returns a dict with passport_hash, pubkey_hash, dg1_hash_words,
    dg15_hash_words, sa_hash_words, flow_ok, sig_ok, smt_ok."""
    dg_algo = p.dg_hash_type
    sa_algo = p.sig.hash_len
    ec_algo = ec_hash_type(p)
    if dg_algo > ec_algo:
        raise ValueError(
            f"invalid config: DG hash ({dg_algo}) wider than EC hash "
            f"({ec_algo}) — rejected by the reference at compile time")

    # the four blobs are independent inputs (each digest is only compared
    # with bytes of the next blob), so the SHA-224/256 ones share a launch
    blobs = [(inp.dg1_words, dg_algo)]
    if p.aa_signature_algo != 0:
        blobs.append((inp.dg15_words, dg_algo))
    blobs += [(inp.ec_words, ec_algo), (inp.sa_words, sa_algo)]
    digests = hash_blobs(blobs)
    dg1_flat, ec_flat, sa_flat = digests[0], digests[-2], digests[-1]
    dg15_flat = digests[1] if p.aa_signature_algo != 0 else None
    sa_bits = bitops.get_bits(sa_flat, 0, min(252, sa_algo))

    for s in (p.dg1_shift, p.ec_shift, p.dg15_shift):
        if s % 8:
            raise ValueError("shifts must be byte-aligned")
    n_cmp = dg_algo // 8  # HASH_SIZE in the flow: the DG hash width in bytes

    def same(digest, words, shift):
        return (bitops.get_bytes(digest, 0, n_cmp) ==
                bitops.get_bytes(words, shift // 8, n_cmp)).all(0)

    flow_ok = same(dg1_flat, inp.ec_words, p.dg1_shift)
    if p.aa_signature_algo != 0:
        flow_ok = flow_ok & same(dg15_flat, inp.ec_words, p.dg15_shift)
        flow_ok = flow_ok & (
            bitops.get_byte(inp.ec_words, p.dg15_shift // 8 - 3) == 0x0F)
    flow_ok = flow_ok & same(ec_flat, inp.sa_words, p.ec_shift)

    sig = p.sig
    if sig.family == "rsa":
        sig_ok = rsa.verify_pkcs1v15(inp.signature, inp.pubkey,
                                     inp.pubkey_mu, sa_flat, sig.hash_len,
                                     sig.key_bits, sig.exp)
        pubkey_hash = rsa_pubkey_hash(inp.pubkey)
    elif sig.family == "rsapss":
        sig_ok = rsapss.verify_pss(inp.signature, inp.pubkey, inp.pubkey_mu,
                                   sa_flat, sig.hash_len, sig.key_bits,
                                   sig.salt_len, sig.exp)
        pubkey_hash = rsa_pubkey_hash(inp.pubkey)
    else:
        half = inp.pubkey.shape[0] // 2
        x, y = inp.pubkey[:half], inp.pubkey[half:]
        sig_ok = ecdsa.verify(sig.curve, x, y, inp.signature,
                              bitops.get_bits(sa_flat, 0, sa_algo))
        pubkey_hash = ecdsa_pubkey_hash(x, y, sig.key_bits // 2)

    smt_ok, _ = smt.verify(inp.slave_root, pubkey_hash, pubkey_hash,
                           inp.slave_branches)

    return {
        "passport_hash": passport_hash_from_sa_bits(sa_bits, sa_algo),
        "pubkey_hash": pubkey_hash,
        "dg1_hash_words": dg1_flat,
        "dg15_hash_words": dg15_flat,
        "sa_hash_words": sa_flat,
        "flow_ok": flow_ok,
        "sig_ok": sig_ok,
        "smt_ok": smt_ok,
    }
