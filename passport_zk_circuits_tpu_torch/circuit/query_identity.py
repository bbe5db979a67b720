"""QueryIdentity (TD3 + TD1) lowered to R1CS.

Constraint twin of the reference's circuits/identityManagement/
queryIdentity.circom:37-229 and queryIdentityTD1.circom:47-237
(+ dg1DataExtractor.circom:5-98, dg1TD1DataExtractor.circom:5-108,
identityStateVerifier.circom:8-47, citizenshipCheck.circom:6-276),
matching the witness semantics of models/query_identity.py. Every
predicate the witness program returns as a boolean is a hard constraint
here (the reference's ForceEqualIfEnabled / `=== 1` discipline).

The port's copy of
``passport_zk_circuits_tpu/circuit/query_identity.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ..models.query_identity import (_TD3_FIELDS, _TD1_FIELDS,
                                     SEL_NULLIFIER,
                                     SEL_BIRTH_DATE, SEL_EXPIRATION_DATE,
                                     SEL_NAME, SEL_NATIONALITY,
                                     SEL_CITIZENSHIP, SEL_SEX,
                                     SEL_DOCUMENT_NUMBER, SEL_TS_LOWER,
                                     SEL_TS_UPPER, SEL_IDC_LOWER,
                                     SEL_IDC_UPPER, SEL_EXP_LOWER,
                                     SEL_EXP_UPPER, SEL_BIRTH_LOWER,
                                     SEL_BIRTH_UPPER,
                                     SEL_PERSONAL_NUMBER,
                                     SEL_DOCUMENT_TYPE)
from ..utils.constants.countries import COUNTRIES
from . import babyjubjub as bjj
from . import dates as cdates
from . import poseidon as pose
from . import smt as csmt
from .builder import Builder, Sig


def _bits_value_msb(b: Builder, bits: Sequence[Sig]) -> Sig:
    acc = b.const(0)
    n = len(bits)
    for j, s in enumerate(bits):
        acc = acc + s.scale(1 << (n - 1 - j))
    return acc


def _bits_value_lsb(b: Builder, bits: Sequence[Sig]) -> Sig:
    acc = b.const(0)
    for j, s in enumerate(bits):
        acc = acc + s.scale(1 << j)
    return acc


def _lt64(b: Builder, x: Sig, y: Sig) -> Sig:
    bits = b.num2bits(x - y + b.const(1 << 64), 65, "q_lt64")
    return b.not_(bits[64])


def _force_if(b: Builder, enabled: Sig, pred: Sig):
    """ForceEqualIfEnabled(enabled, [pred, 1])."""
    b.enforce(enabled, pred - 1, 0)


def build(b: Builder, inp: Dict[str, object], document_type: int = 3):
    """Lower QueryIdentity (TD3 or TD1) into an existing Builder.

    `inp` carries per-instance value lists: dg1 (bytes), sk, pk_pass_hash,
    event_id, event_data, root, siblings (list of 80 lists), selector,
    current_date, timestamp(+bounds), identity_counter(+bounds),
    birth/expiration bounds (encoded), citizenship_mask.
    Returns outputs dict of gated Sigs."""
    B = b.batch
    dg1_bits = []
    for bit in range(744 if document_type == 3 else 760):
        byte, off = divmod(bit, 8)
        s = b.input([(d[byte] >> (7 - off)) & 1 for d in inp["dg1"]],
                    "qdg1")
        b.enforce_bool(s)
        dg1_bits.append(s)
    sk = b.input(inp["sk"], "q_sk")
    pk_pass = b.input(inp["pk_passport_hash"], "q_pkpass")
    event_id = b.input(inp["event_id"], "q_event")
    event_data = b.input(inp["event_data"], "q_eventdata")
    root = b.input(inp["root"], "q_root")
    sibs = [b.input(inp["siblings"][i], f"q_sib{i}") for i in range(80)]
    selector = b.input(inp["selector"], "q_sel")
    current_date = b.input(inp["current_date"], "q_now")
    ts = b.input(inp["timestamp"], "q_ts")
    ts_lo = b.input(inp["timestamp_lower"], "q_tslo")
    ts_hi = b.input(inp["timestamp_upper"], "q_tshi")
    idc = b.input(inp["identity_counter"], "q_idc")
    idc_lo = b.input(inp["identity_counter_lower"], "q_idclo")
    idc_hi = b.input(inp["identity_counter_upper"], "q_idchi")
    bd_lo = b.input(inp["birth_date_lower"], "q_bdlo")
    bd_hi = b.input(inp["birth_date_upper"], "q_bdhi")
    ed_lo = b.input(inp["expiration_date_lower"], "q_edlo")
    ed_hi = b.input(inp["expiration_date_upper"], "q_edhi")
    cz_mask = b.input(inp["citizenship_mask"], "q_mask")

    sel_bits = b.num2bits(selector, 18, "q_selbit")

    fields_map = _TD3_FIELDS if document_type == 3 else _TD1_FIELDS

    def field(name):
        off, size = fields_map[name]
        return _bits_value_msb(b, dg1_bits[off:off + size])

    def gate(value, bit_idx):
        return b.mul(sel_bits[bit_idx], value, "q_gate")

    sk_hash = pose.poseidon(b, [sk])
    nullifier = pose.poseidon(b, [sk, sk_hash, event_id])

    outputs = {
        "nullifier": gate(nullifier, SEL_NULLIFIER),
        "birth_date": gate(field("birth_date"), SEL_BIRTH_DATE),
        "expiration_date": gate(field("expiration_date"),
                                SEL_EXPIRATION_DATE),
        "name": gate(field("name"), SEL_NAME),
        "nationality": gate(field("nationality"), SEL_NATIONALITY),
        "citizenship": gate(field("citizenship"), SEL_CITIZENSHIP),
        "sex": gate(field("sex"), SEL_SEX),
    }
    if document_type == 3:
        outputs["name_residual"] = gate(field("name_residual"), SEL_NAME)
        outputs["document_number"] = gate(field("document_number"),
                                          SEL_DOCUMENT_NUMBER)
    else:
        # TD1 hashes the document/personal numbers before disclosure
        # (queryIdentityTD1.circom:146-166)
        outputs["document_number_hash"] = gate(
            pose.poseidon(b, [field("document_number")]),
            SEL_DOCUMENT_NUMBER)
        outputs["personal_number_hash"] = gate(
            pose.poseidon(b, [field("personal_number")]),
            SEL_PERSONAL_NUMBER)
        outputs["document_type"] = gate(field("document_type"),
                                        SEL_DOCUMENT_TYPE)

    # -- numeric bounds (queryIdentity.circom:110-149); inputs 64-bit ---
    for v in (ts, ts_lo, ts_hi, idc, idc_lo, idc_hi):
        b.num2bits(v, 64, "q_rc64")
    _force_if(b, sel_bits[SEL_TS_LOWER], b.not_(_lt64(b, ts, ts_lo)))
    _force_if(b, sel_bits[SEL_TS_UPPER], _lt64(b, ts, ts_hi))
    _force_if(b, sel_bits[SEL_IDC_LOWER], b.not_(_lt64(b, idc, idc_lo)))
    _force_if(b, sel_bits[SEL_IDC_UPPER], _lt64(b, idc, idc_hi))

    # -- date bounds (:151-191) ----------------------------------------
    exp = field("expiration_date")
    birth = field("birth_date")
    _force_if(b, sel_bits[SEL_EXP_LOWER],
              cdates.encoded_date_is_less(b, ed_lo, exp))
    _force_if(b, sel_bits[SEL_EXP_UPPER],
              cdates.encoded_date_is_less(b, exp, ed_hi))
    _force_if(b, sel_bits[SEL_BIRTH_LOWER],
              cdates.encoded_date_is_less_normalized(b, bd_lo, birth,
                                                     current_date))
    _force_if(b, sel_bits[SEL_BIRTH_UPPER],
              cdates.encoded_date_is_less_normalized(b, birth, bd_hi,
                                                     current_date))

    # -- dg1 commitment recompute (:193-206; TD1 uses 190-bit chunks) --
    cs = 186 if document_type == 3 else 190
    chunks = [_bits_value_lsb(b, dg1_bits[i * cs:(i + 1) * cs])
              for i in range(4)]
    dg_commit = pose.poseidon(b, chunks + [sk_hash])

    # -- eventData binding (:208-209) ----------------------------------
    b.mul(event_data, event_data, "q_eventsq")

    # -- identity state (identityStateVerifier.circom:8-47, ENFORCED) --
    px, py = bjj.base8_mul(b, sk)
    pk_hash = pose.poseidon(b, [px, py])
    key = pose.poseidon(b, [pk_pass, pk_hash])
    value = pose.poseidon(b, [dg_commit, idc, ts])
    ok = csmt.verify(b, root, key, value, sibs)
    b.enforce_eq(ok, 1)

    # -- citizenship (citizenshipCheck.circom:6-276) -------------------
    cz = field("citizenship")
    mask_bits = b.num2bits(cz_mask, 240, "q_maskbit")
    total = b.const(0)
    for i, country in enumerate(COUNTRIES):
        match = b.is_equal(cz, b.const(country))
        # match * blacklistBit === 0 (bit i MSB-first -> mask bit 239-i)
        b.enforce(match, mask_bits[239 - i], 0)
        total = total + match
    b.enforce_eq(total, 1)                    # must be in the table

    return outputs
