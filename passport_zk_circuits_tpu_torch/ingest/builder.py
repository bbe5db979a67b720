"""Host-side input builder: raw passport blobs -> batched tensors for the
RegisterIdentity forward.

Counterpart of ``passport_zk_circuits_tpu/ingest/builder.py``: SHA padding
of every blob (512- or 1024-bit blocks), bignum chunking into 16-bit limbs
(an RSA modulus and signature; an ECDSA key as X || Y and signature as
r || s, with an unused zero mu), and the Barrett precompute, in numpy, then
one conversion to int64 tensors.
"""

from __future__ import annotations

import numpy as np

from ..models.register_identity import RegisterIdentityInputs
from ..models.passport_verification import PassportInputs
from ..ops import bignum as bn
from ..ops import field as fr
from ..ops import sha2
from . import convert
from ..models import params


def _padded_words(blobs, block_bits: int, n_blocks: int) -> np.ndarray:
    """B raw blobs -> (n_words, B) padded big-endian uint32 words."""
    cols = []
    for b in blobs:
        padded = sha2.pad_message(b, block_bits)
        if len(padded) * 8 != n_blocks * block_bits:
            raise ValueError(f"blob of {len(b)}B does not pad to exactly "
                             f"{n_blocks} x {block_bits}-bit blocks")
        cols.append(sha2.bytes_to_words32(padded))
    return np.stack(cols, axis=-1)


def build_register_inputs_numpy(p: params.CircuitParams, passports):
    """passports: list of dicts from ingest.synthetic. Returns the port's
    RegisterIdentityInputs with numpy uint32 fields, laid out exactly as
    the JAX package's builder lays them out."""
    k = p.sig.key_bits // 16
    B = len(passports)
    dg1_w = _padded_words([pp["dg1"] for pp in passports],
                          p.dg_hash_block_size, 1024 // p.dg_hash_block_size)
    ec_w = _padded_words([pp["ec"] for pp in passports],
                         p.sig_hash_block_size, p.ec_block_number)
    sa_w = _padded_words([pp["sa"] for pp in passports],
                         p.sig_hash_block_size, 1024 // p.sig_hash_block_size)
    if p.aa_signature_algo != 0:
        dg15_w = _padded_words([pp["dg15"] for pp in passports],
                               p.dg_hash_block_size, p.dg15_block_number)
    else:
        dg15_w = np.zeros((p.dg15_block_number * p.dg_hash_block_size // 32,
                           B), dtype=np.uint32)
    if p.sig.family == "ecdsa":
        kf = p.sig.key_bits // 32           # key_bits = 2 x field bits

        def pair(key):
            return np.concatenate([
                bn.ints_to_limbs_batch([pp[key][i] for pp in passports], kf)
                for i in (0, 1)])
        pubkey, signature = pair("pubkey"), pair("signature")
        mu = np.zeros((k + 1, B), dtype=np.uint32)          # unused
    else:
        mods = [pp["pubkey"] for pp in passports]
        pubkey = bn.ints_to_limbs_batch(mods, k)
        signature = bn.ints_to_limbs_batch(
            [pp["signature"] for pp in passports], k)
        mu = bn.barrett_mu_batch(mods, k)
    passport = PassportInputs(
        dg1_words=dg1_w,
        dg15_words=dg15_w,
        ec_words=ec_w,
        sa_words=sa_w,
        signature=signature,
        pubkey=pubkey,
        pubkey_mu=mu,
        slave_root=fr.batch_to_limbs([pp["slave_root"] for pp in passports]),
        slave_branches=np.stack(
            [fr.batch_to_limbs([pp["slave_branches"][i] for pp in passports])
             for i in range(80)], axis=1),
    )
    return RegisterIdentityInputs(
        passport=passport,
        sk_identity=fr.batch_to_limbs([pp["sk_identity"] for pp in passports]))


def build_register_inputs(p: params.CircuitParams, passports, device):
    """passports -> the port's RegisterIdentityInputs of int64 tensors on
    `device`."""
    return convert.inputs_from_numpy(build_register_inputs_numpy(p, passports),
                                     device)
