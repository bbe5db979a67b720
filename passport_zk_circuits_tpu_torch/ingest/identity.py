"""Host-side inputs of RegisterIdentityLight and QueryIdentity, and the
Python-int oracles of their outputs.

The JAX package builds these inputs inline in its tests
(tests/test_register_variants.py, test_query_identity.py,
test_query_identity_td1.py, test_register_query_chain.py): dg1 in the MRZ
layout with the birth date, expiry, citizenship and sex at the offsets the
circuits read, and an identity-state SMT whose leaf holds
(key, value) = (Poseidon2(pkPassportHash, Poseidon2(BabyPbk(sk))),
Poseidon3(dg1Commitment, identityCounter, timestamp)). Here the same
construction serves the port's tests, its fixture writer and
``chip_smoke.py``. Everything is pure Python and numpy over the port's
oracles, so a pool's worker process can run it.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

from ..models.query_identity import QueryInputs
from ..models.register_identity_light import LightInputs
from ..ops import bignum as bn
from ..ops import field as fr
from ..ops import sha2
from ..utils import poseidon_ref as pref
from . import synthetic

QUERY_WORDS = 24                 # dg1 (93 or 95 bytes) zero-padded to 768 bits
DG1_BYTES = {3: 93, 1: 95}
# (bit offset, bits) of each disclosed dg1 field, by document type: the
# offsets make_dg1 writes at, which the oracle reads back
LAYOUT = {
    3: {"birth_date": (496, 48), "expiration_date": (560, 48),
        "name": (80, 248), "name_residual": (328, 64),
        "nationality": (472, 24), "citizenship": (56, 24),
        "sex": (552, 8), "document_number": (392, 72)},
    1: {"birth_date": (280, 48), "expiration_date": (344, 48),
        "name": (520, 240), "nationality": (400, 24),
        "citizenship": (56, 24), "sex": (336, 8),
        "document_number": (80, 72), "personal_number": (160, 88),
        "document_type": (40, 16)},
}
# selector bit of each gated output (queryIdentity.circom:12-31)
SELECTOR_BIT = {"nullifier": 0, "birth_date": 1, "expiration_date": 2,
                "name": 3, "name_residual": 3, "nationality": 4,
                "citizenship": 5, "sex": 6, "document_number": 7,
                "document_number_hash": 7, "personal_number_hash": 16,
                "document_type": 17}


def enc_date(date: bytes) -> int:
    """"YYMMDD" -> its encoded (big-endian UTF-8) value."""
    return int.from_bytes(date, "big")


def make_dg1(rng: random.Random, document_type: int, birth=b"900115",
             expiry=b"301231", citizenship=b"UKR") -> bytes:
    """Random A-Z dg1 with the fields the query reads written at their
    offsets: TD3 (93 bytes) sex "F"; TD1 (95 bytes) sex "M", document type
    "ID", a document and a personal number, the nationality equal to the
    citizenship."""
    dg1 = bytearray(0x41 + rng.randrange(26)
                    for _ in range(DG1_BYTES[document_type]))
    lay = LAYOUT[document_type]
    fields = {"citizenship": citizenship, "birth_date": birth,
              "expiration_date": expiry}
    if document_type == 3:
        fields["sex"] = b"F"
    else:
        fields.update(sex=b"M", document_type=b"ID",
                      document_number=b"D23145890",
                      personal_number=b"99001558998",
                      nationality=citizenship)
    for name, value in fields.items():
        off = lay[name][0] // 8
        dg1[off:off + len(value)] = value
    return bytes(dg1)


def words(blobs, n_words: int) -> np.ndarray:
    """Byte strings -> (n_words, B) uint32 big-endian words, zero-padded."""
    return np.stack([sha2.bytes_to_words32(b + bytes(4 * n_words - len(b)))
                     for b in blobs], axis=-1)


def field_value(dg1: bytes, off: int, size: int) -> int:
    """The big-endian value of dg1's bits off..off+size-1."""
    return synthetic.be_bits_value(synthetic._bits_list(dg1), off, size)


def live_siblings(rng: random.Random, n_live: int, depth: int = 80):
    """A proof path with non-zero siblings at levels 0..n_live-1 (index 0
    root-most) and zero below: the leaf sits n_live levels down."""
    return [rng.randrange(1, fr.P) if i < n_live else 0
            for i in range(depth)]


def smt_root(key: int, value: int, siblings) -> int:
    """Root of a one-proof SMT path (siblings[0] root-most): the leaf
    Poseidon3(key, value, 1) one level past the last non-zero sibling,
    hashed up with the key's bits LSB-first from the root."""
    node = pref.poseidon([key, value, 1])
    last = max((i for i, s in enumerate(siblings) if s), default=-1)
    for i in range(last, -1, -1):
        pair = [siblings[i], node] if (key >> i) & 1 else [node, siblings[i]]
        node = pref.poseidon(pair)
    return node


def identity_key(sk_identity: int, pk_passport_hash: int) -> int:
    return pref.poseidon([pk_passport_hash,
                          synthetic.pk_identity_hash_oracle(sk_identity)])


def identity_value(dg1_commitment: int, identity_counter: int,
                   timestamp: int) -> int:
    return pref.poseidon([dg1_commitment, identity_counter, timestamp])


@dataclasses.dataclass
class QueryLane:
    """One QueryIdentity witness as Python values; the defaults are the
    JAX tests' (every bound met by the default dg1 of make_dg1). root None:
    the identity-state root of the lane's own sk, dg1 and path."""
    dg1: bytes
    sk_identity: int
    pk_passport_hash: int
    event_id: int
    event_data: int
    siblings: list
    selector: int = (1 << 16) - 1
    current_date: int = enc_date(b"250817")
    timestamp: int = 1716482295
    timestamp_lower: int = 1716482295
    timestamp_upper: int = 1816482295
    identity_counter: int = 3
    identity_counter_lower: int = 0
    identity_counter_upper: int = 10
    birth_date_lower: int = enc_date(b"800101")
    birth_date_upper: int = enc_date(b"991231")
    expiration_date_lower: int = enc_date(b"250101")
    expiration_date_upper: int = enc_date(b"501231")
    citizenship_mask: int = 0
    root: int | None = None


def identity_root(lane: QueryLane, document_type: int) -> int:
    """The identity-state root of the lane's registration: its dg1
    commitment under its sk, counter and timestamp, on its path."""
    commit = synthetic.dg1_commitment_oracle(lane.dg1, document_type,
                                             lane.sk_identity)
    return smt_root(identity_key(lane.sk_identity, lane.pk_passport_hash),
                    identity_value(commit, lane.identity_counter,
                                   lane.timestamp), lane.siblings)


def with_roots(lanes, document_type: int):
    """The lanes with every missing root computed (a pool's worker runs
    this on a chunk)."""
    return [lane if lane.root is not None else dataclasses.replace(
        lane, root=identity_root(lane, document_type)) for lane in lanes]


_SCALARS = [f.name for f in dataclasses.fields(QueryLane)
            if f.name not in ("dg1", "siblings", "selector")]


def query_arrays(lanes) -> dict:
    """Lanes with roots -> the QueryInputs fields as numpy uint32 arrays:
    (24, B) words, (16, B) limbs, (16, depth, B) siblings, (B,) selector."""
    if any(lane.root is None for lane in lanes):
        raise ValueError("query_arrays: compute the roots first "
                         "(with_roots)")
    out = {"dg1_words": words([lane.dg1 for lane in lanes], QUERY_WORDS),
           "selector": np.array([lane.selector for lane in lanes],
                                dtype=np.uint32),
           "id_state_siblings": np.stack(
               [fr.batch_to_limbs(level) for level in
                zip(*(lane.siblings for lane in lanes))], axis=1)}
    for name in _SCALARS:
        key = "id_state_root" if name == "root" else name
        out[key] = fr.batch_to_limbs([getattr(lane, name) for lane in lanes])
    return out


def lowering_inputs(lanes) -> dict:
    """Lanes with roots -> the input dict of ``circuit/query_identity``'s
    ``build``: per input a list of the lanes' Python values (``dg1`` bytes,
    ``sk`` the sk_identity), ``siblings`` one such list a level, root side
    first."""
    if any(lane.root is None for lane in lanes):
        raise ValueError("lowering_inputs: compute the roots first "
                         "(with_roots)")
    out = {"dg1": [lane.dg1 for lane in lanes],
           "siblings": [list(level) for level in
                        zip(*(lane.siblings for lane in lanes))]}
    for name in _SCALARS + ["selector"]:
        key = "sk" if name == "sk_identity" else name
        out[key] = [getattr(lane, name) for lane in lanes]
    return out


def query_inputs(arrays: dict, device) -> QueryInputs:
    """Numpy QueryInputs fields -> the port's QueryInputs on `device`."""
    return QueryInputs(**{f: bn.to_tensor(arrays[f], device)
                          for f in QueryInputs._fields})


def expected_query_outputs(lane: QueryLane, document_type: int) -> dict:
    """The gated outputs of QueryIdentity on one lane, as Python ints."""
    lay = LAYOUT[document_type]
    val = {name: field_value(lane.dg1, *lay[name]) for name in lay}
    sk = lane.sk_identity
    out = {"nullifier": pref.poseidon([sk, pref.poseidon([sk]),
                                       lane.event_id])}
    for name in ("birth_date", "expiration_date", "name", "nationality",
                 "citizenship", "sex"):
        out[name] = val[name]
    if document_type == 3:
        out["name_residual"] = val["name_residual"]
        out["document_number"] = val["document_number"]
    else:
        out["document_number_hash"] = pref.poseidon([val["document_number"]])
        out["personal_number_hash"] = pref.poseidon([val["personal_number"]])
        out["document_type"] = val["document_type"]
    return {k: v if (lane.selector >> SELECTOR_BIT[k]) & 1 else 0
            for k, v in out.items()}


def light_inputs(dg1s, sks, hash_type: int, device) -> LightInputs:
    """dg1 byte strings and sk ints -> LightInputs: dg1 MD-padded for the
    hash (to 1024 bits: two 512-bit blocks or one 1024-bit block)."""
    padded = [sha2.pad_message(d, sha2.ALGO_BITS[hash_type]) for d in dg1s]
    if any(len(p) != 128 for p in padded):
        raise ValueError("light_inputs: dg1 must pad to 1024 bits")
    return LightInputs(
        dg1_words=bn.to_tensor(words(padded, 32), device),
        sk_identity=bn.to_tensor(fr.batch_to_limbs(sks), device))


def expected_light_outputs(dg1: bytes, sk_identity: int, document_type: int,
                           hash_type: int) -> dict:
    """RegisterIdentityLight's three outputs on one lane, as Python ints."""
    digest = sha2.sha_hash_bytes_host(dg1, hash_type)
    return {"dg1_commitment": synthetic.dg1_commitment_oracle(
                dg1, document_type, sk_identity),
            "pk_identity_hash": synthetic.pk_identity_hash_oracle(
                sk_identity),
            "dg1_hash": int.from_bytes(digest, "big") % (1 << 248)}

