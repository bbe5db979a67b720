"""Batched RegisterIdentity: the flagship registration circuit family.

Counterpart of ``passport_zk_circuits_tpu/models/register_identity.py``.
Outputs (batched Fr limbs): dg15_pubkey_hash, passport_hash, dg1_commitment,
pk_identity_hash — the four public outputs of the reference builder — plus
the flow / signature / SMT verdicts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import babyjubjub as bjj
from ..ops import bitops
from ..ops import field as fr
from ..ops import poseidon as pos
from . import passport_verification as pv
from . import params


class RegisterIdentityInputs(NamedTuple):
    passport: pv.PassportInputs
    sk_identity: torch.Tensor         # (16, B) Fr limbs


def ecdsa_aa_bits(aa: int):
    """(field bits, low bits kept of each coordinate) of an ECDSA active-auth
    key: P-256 and brainpoolP256r1 (20, 21), brainpoolP320r1 (22),
    secp192r1 (23, kept whole)."""
    return {22: (320, 248), 23: (192, 192)}.get(aa, (256, 248))


def dg15_pubkey_hash(p: params.CircuitParams, dg15_words):
    """Active-auth public key hash; 0 without AA. An RSA-1024 AA key
    (algo < 20): Poseidon5 of the modulus in big-endian chunks of
    200+200+200+200+224 bits. An ECDSA AA key: Poseidon2 of X and Y, each
    cut to its low 248 bits (256- and 320-bit fields) or kept whole
    (192-bit field, algo 23)."""
    aa = p.aa_signature_algo
    if aa == 0:
        return fr.const(0, dg15_words.shape[1:], dg15_words.device)
    if aa < 20:
        chunks = [bitops.word_slice_to_fr(dg15_words, p.aa_shift + j * 200,
                                          200, msb_first=True)
                  for j in range(4)]
        chunks.append(bitops.word_slice_to_fr(dg15_words, p.aa_shift + 800,
                                              224, msb_first=True))
        return pos.poseidon(chunks)
    field_size, keep = ecdsa_aa_bits(aa)
    xy_shift = field_size - keep
    x = bitops.word_slice_to_fr(dg15_words, p.aa_shift + xy_shift, keep,
                                msb_first=True)
    y = bitops.word_slice_to_fr(dg15_words, p.aa_shift + field_size
                                + xy_shift, keep, msb_first=True)
    return pos.poseidon([x, y])


def dg1_chunks(dg1_words, document_type: int):
    """The four reversed-bit dg1 chunks of the commitment: 186 bits each for
    TD3, 190 for TD1."""
    chunk_size = 186 if document_type == 3 else 190
    return [bitops.word_slice_to_fr(dg1_words, i * chunk_size, chunk_size,
                                    msb_first=False) for i in range(4)]


def dg1_commitment(p: params.CircuitParams, dg1_words, sk_identity):
    """Poseidon5 of 4 reversed-bit dg1 chunks + Poseidon1(skIdentity)."""
    return pos.poseidon(dg1_chunks(dg1_words, p.document_type)
                        + [pos.poseidon([sk_identity])])


def pk_identity_hash(sk_identity):
    """Poseidon2 of the BabyJubJub public key Base8 * sk."""
    return pos.poseidon(list(bjj.base8_mul(sk_identity)))


def forward(p: params.CircuitParams, inp: RegisterIdentityInputs):
    """Full RegisterIdentityBuilder forward: a dict of the four public
    outputs plus the verdicts."""
    out = pv.forward(p, inp.passport)
    out["dg15_pubkey_hash"] = dg15_pubkey_hash(p, inp.passport.dg15_words)
    out["dg1_commitment"] = dg1_commitment(p, inp.passport.dg1_words,
                                           inp.sk_identity)
    out["pk_identity_hash"] = pk_identity_hash(inp.sk_identity)
    return out
