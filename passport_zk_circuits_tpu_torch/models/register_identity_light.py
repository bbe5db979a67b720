"""Batched RegisterIdentityLight: registration without SOD verification.

Counterpart of ``passport_zk_circuits_tpu/models/register_identity_light.py``
(the reference's registerIdentityLight.circom): the dg1 commitment
(reversed-bit chunks and Poseidon1(sk)), the BabyJubJub identity key hash,
and dg1Hash, the DG hash of dg1 cut to its low 248 bits.

On CUDA tensors the Poseidon hashes launch K3, the key K5's affine entry and
SHA-224/256 K1's per-message entry; SHA-384/512 are plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bitops
from ..ops import poseidon as pos
from ..ops import sha2
from . import register_identity as ri


class LightInputs(NamedTuple):
    dg1_words: torch.Tensor        # (32, B): dg1 padded to 1024 bits
    sk_identity: torch.Tensor      # (16, B)


def forward(inp: LightInputs, dg_hash_type: int = 256,
            document_type: int = 3):
    """dg_hash_type in {224, 256, 384, 512}; document_type 3 (TD3) or 1
    (TD1). Returns the three public outputs as (16, B) Fr limbs."""
    sk_hash = pos.poseidon([inp.sk_identity])
    dg1_commitment = pos.poseidon(
        ri.dg1_chunks(inp.dg1_words, document_type) + [sk_hash])
    pk_identity_hash = ri.pk_identity_hash(inp.sk_identity)

    if dg_hash_type in (384, 512):
        dw = sha2.sha_hash_chunks(
            bitops.words32_to_words64(inp.dg1_words), dg_hash_type)
        flat = dw.reshape((dw.shape[0] * 2,) + dw.shape[2:])
    else:
        flat = sha2.sha_hash_chunks(inp.dg1_words, dg_hash_type)
    # dg1Hash = digest mod 2^248 (big-endian value of the trailing bits)
    keep = min(248, dg_hash_type)
    bits = bitops.get_bits(flat, dg_hash_type - keep, keep)
    dg1_hash = bitops.bits_to_fr(bits, msb_first=True)

    return {"dg1_commitment": dg1_commitment,
            "pk_identity_hash": pk_identity_hash,
            "dg1_hash": dg1_hash}
