"""Batched QueryIdentity (TD3 and TD1): selective disclosure over a
registered passport against the on-chain identity-state SMT.

Counterpart of ``passport_zk_circuits_tpu/models/query_identity.py`` (the
reference's queryIdentity.circom, queryIdentityTD1.circom, the dg1 data
extractors, identityStateVerifier.circom and citizenshipCheck.circom).
The reference enforces its range and membership checks as constraints; the
batched witness program returns the same predicates as booleans in
`checks`, and a witness is valid iff they all hold.

On CUDA tensors the Poseidon hashes launch K3, the identity key K5's affine
entry, and the identity-state proof K3 (its leaf) and K4 (the climb).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import babyjubjub as bjj
from ..ops import bignum as bn
from ..ops import bitops
from ..ops import dates
from ..ops import field as fr
from ..ops import poseidon as pos
from ..ops import smt
from ..utils.constants.countries import COUNTRIES
from . import register_identity as ri

# selector bits (queryIdentity.circom:12-31)
SEL_NULLIFIER = 0
SEL_BIRTH_DATE = 1
SEL_EXPIRATION_DATE = 2
SEL_NAME = 3
SEL_NATIONALITY = 4
SEL_CITIZENSHIP = 5
SEL_SEX = 6
SEL_DOCUMENT_NUMBER = 7
SEL_TS_LOWER = 8
SEL_TS_UPPER = 9
SEL_IDC_LOWER = 10
SEL_IDC_UPPER = 11
SEL_EXP_LOWER = 12
SEL_EXP_UPPER = 13
SEL_BIRTH_LOWER = 14
SEL_BIRTH_UPPER = 15
SEL_PERSONAL_NUMBER = 16   # TD1 only (TD3: whitelist bit, unimplemented)
SEL_DOCUMENT_TYPE = 17     # TD1 only

# DG1 field layout: (shift_bits, size_bits) per document type
_TD3_FIELDS = {
    "birth_date": (496, 48), "expiration_date": (560, 48),
    "name": (80, 248), "name_residual": (328, 64),
    "nationality": (472, 24), "citizenship": (56, 24),
    "sex": (552, 8), "document_number": (392, 72),
}
_TD1_FIELDS = {
    "birth_date": (280, 48), "expiration_date": (344, 48),
    "name": (520, 240),
    "nationality": (400, 24), "citizenship": (56, 24),
    "sex": (336, 8), "document_number": (80, 72),
    "personal_number": (160, 88), "document_type": (40, 16),
}


class QueryInputs(NamedTuple):
    dg1_words: torch.Tensor          # (24, B): 744/760 dg1 bits, zero-padded
    sk_identity: torch.Tensor        # (16, B)
    pk_passport_hash: torch.Tensor   # (16, B)
    event_id: torch.Tensor           # (16, B)
    event_data: torch.Tensor         # (16, B)
    id_state_root: torch.Tensor      # (16, B)
    id_state_siblings: torch.Tensor  # (16, depth, B)
    selector: torch.Tensor           # (B,) int64 (18 bits)
    current_date: torch.Tensor       # (16, B) encoded date
    timestamp: torch.Tensor          # (16, B)
    timestamp_lower: torch.Tensor    # (16, B)
    timestamp_upper: torch.Tensor    # (16, B)
    identity_counter: torch.Tensor   # (16, B)
    identity_counter_lower: torch.Tensor
    identity_counter_upper: torch.Tensor
    birth_date_lower: torch.Tensor   # (16, B) encoded dates
    birth_date_upper: torch.Tensor
    expiration_date_lower: torch.Tensor
    expiration_date_upper: torch.Tensor
    citizenship_mask: torch.Tensor   # (16, B): 240-bit mask


def extract_dg1_fields(dg1_words, document_type: int):
    fields = _TD3_FIELDS if document_type == 3 else _TD1_FIELDS
    return {name: bitops.word_slice_to_fr(dg1_words, off, size,
                                          msb_first=True)
            for name, (off, size) in fields.items()}


def _sel_bit(selector, i: int):
    return ((selector >> i) & 1).bool()


def _gate(value, bit):
    return fr.select(bit, value, torch.zeros_like(value))


def identity_state_verify(sk_identity, pk_pass_hash, dg_commit,
                          identity_counter, timestamp, root, siblings):
    """IdentityStateVerifier: key = Poseidon2(pkPassHash,
    Poseidon2(BabyPbk(sk))), value = Poseidon3(dgCommit, identityCounter,
    timestamp); the SMT inclusion of (key, value) under root -> bool (B,)."""
    key = pos.poseidon([pk_pass_hash, ri.pk_identity_hash(sk_identity)])
    value = pos.poseidon([dg_commit, identity_counter, timestamp])
    ok, _ = smt.verify(root, key, value, siblings)
    return ok


@functools.lru_cache(maxsize=None)
def _countries(device: torch.device, ndim: int):
    """COUNTRIES as a (240, 1, ..., 1) int64 tensor on `device`, made once
    per (device, ndim) and shared: never write to it."""
    return torch.tensor(COUNTRIES, dtype=torch.int64, device=device).reshape(
        (len(COUNTRIES),) + (1,) * ndim)


def citizenship_check(citizenship, mask_limbs):
    """CitizenshipCheck: the citizenship must be in the 240-entry table and
    its mask bit (MSB-first: bit 239 - i gates entry i) must be 0. Returns
    (in_table, not_blacklisted), each bool (*B,)."""
    cz = citizenship[0] | (citizenship[1] << 16)          # 24-bit value
    match = cz.unsqueeze(0) == _countries(cz.device, cz.dim())
    in_table = match.sum(0) == 1
    entry_bit = fr.to_bits(mask_limbs, len(COUNTRIES)).bool().flip(0)
    return in_table, ~(match & entry_bit).any(0)


def forward(inp: QueryInputs, document_type: int = 3, tree_depth: int = 80):
    """Returns (outputs, checks) dicts with the JAX function's keys. Outputs
    are selector-gated like the reference's public outputs; checks are the
    constraint predicates. tree_depth is the reference's template parameter;
    the siblings' shape carries it."""
    f = extract_dg1_fields(inp.dg1_words, document_type)
    sel = inp.selector

    sk_hash = pos.poseidon([inp.sk_identity])
    nullifier = pos.poseidon([inp.sk_identity, sk_hash, inp.event_id])

    outputs = {
        "nullifier": _gate(nullifier, _sel_bit(sel, SEL_NULLIFIER)),
        "birth_date": _gate(f["birth_date"], _sel_bit(sel, SEL_BIRTH_DATE)),
        "expiration_date": _gate(f["expiration_date"],
                                 _sel_bit(sel, SEL_EXPIRATION_DATE)),
        "name": _gate(f["name"], _sel_bit(sel, SEL_NAME)),
        "nationality": _gate(f["nationality"],
                             _sel_bit(sel, SEL_NATIONALITY)),
        "citizenship": _gate(f["citizenship"],
                             _sel_bit(sel, SEL_CITIZENSHIP)),
        "sex": _gate(f["sex"], _sel_bit(sel, SEL_SEX)),
    }
    if document_type == 3:
        outputs["name_residual"] = _gate(f["name_residual"],
                                         _sel_bit(sel, SEL_NAME))
        outputs["document_number"] = _gate(
            f["document_number"], _sel_bit(sel, SEL_DOCUMENT_NUMBER))
    else:
        outputs["document_number_hash"] = _gate(
            pos.poseidon([f["document_number"]]),
            _sel_bit(sel, SEL_DOCUMENT_NUMBER))
        outputs["personal_number_hash"] = _gate(
            pos.poseidon([f["personal_number"]]),
            _sel_bit(sel, SEL_PERSONAL_NUMBER))
        outputs["document_type"] = _gate(
            f["document_type"], _sel_bit(sel, SEL_DOCUMENT_TYPE))

    def bounded(enabled_bit, pred):
        return ~enabled_bit | pred

    checks = {}
    checks["timestamp_lower"] = bounded(
        _sel_bit(sel, SEL_TS_LOWER),
        ~bn.lt(inp.timestamp, inp.timestamp_lower))       # ts >= lower
    checks["timestamp_upper"] = bounded(
        _sel_bit(sel, SEL_TS_UPPER),
        bn.lt(inp.timestamp, inp.timestamp_upper))        # ts < upper
    checks["identity_counter_lower"] = bounded(
        _sel_bit(sel, SEL_IDC_LOWER),
        ~bn.lt(inp.identity_counter, inp.identity_counter_lower))
    checks["identity_counter_upper"] = bounded(
        _sel_bit(sel, SEL_IDC_UPPER),
        bn.lt(inp.identity_counter, inp.identity_counter_upper))

    exp_lo, _ = dates.encoded_date_is_less(inp.expiration_date_lower,
                                           f["expiration_date"])
    exp_hi, _ = dates.encoded_date_is_less(f["expiration_date"],
                                           inp.expiration_date_upper)
    birth_lo, _ = dates.encoded_date_is_less_normalized(
        inp.birth_date_lower, f["birth_date"], inp.current_date)
    birth_hi, _ = dates.encoded_date_is_less_normalized(
        f["birth_date"], inp.birth_date_upper, inp.current_date)
    checks["expiration_lower"] = bounded(_sel_bit(sel, SEL_EXP_LOWER), exp_lo)
    checks["expiration_upper"] = bounded(_sel_bit(sel, SEL_EXP_UPPER), exp_hi)
    checks["birth_lower"] = bounded(_sel_bit(sel, SEL_BIRTH_LOWER), birth_lo)
    checks["birth_upper"] = bounded(_sel_bit(sel, SEL_BIRTH_UPPER), birth_hi)

    # dg1 commitment recompute (reversed-bit chunks, like RegisterIdentity)
    dg_commit = pos.poseidon(ri.dg1_chunks(inp.dg1_words, document_type)
                             + [sk_hash])

    # eventData is bound by squaring only (queryIdentity.circom:208-209).
    # The product has no output, in the JAX package either; it is kept so
    # that the port does the same work.
    fr.sqr(inp.event_data)

    checks["identity_state"] = identity_state_verify(
        inp.sk_identity, inp.pk_passport_hash, dg_commit,
        inp.identity_counter, inp.timestamp, inp.id_state_root,
        inp.id_state_siblings)

    in_table, not_blacklisted = citizenship_check(f["citizenship"],
                                                  inp.citizenship_mask)
    checks["citizenship_in_table"] = in_table
    checks["citizenship_not_blacklisted"] = not_blacklisted

    return outputs, checks
