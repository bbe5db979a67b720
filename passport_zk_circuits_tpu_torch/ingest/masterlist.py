"""ICAO master-list (slave-certificate) sparse Merkle tree, host side.

The port's own copy of ``passport_zk_circuits_tpu/ingest/masterlist.py``
(the same code, over the port's ``utils/poseidon_ref``, ``ingest/x509``
and ``ingest/synthetic``'s pubkey-hash oracles).

The reference fabricates a 1-leaf slave SMT per test passport (root =
Poseidon3(pkHash, pkHash, 1), 80 zero branches). A production
registration proves that the DS certificate's pubkey hash is in a real
multi-leaf tree. This module builds that tree from a certificate set with
the iden3 semantics of ``ops/smt.py`` (merkleTree/SMTVerifier.circom):

    leaf  = Poseidon3(key, value, 1)
    node  = Poseidon2(left, right)
    path  = key bits LSB-first from the ROOT

Keys and values are both the pubkey hash, so ``prove(pk_hash)`` yields
(root, 80 siblings) ready for the register-identity witness inputs.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from ..utils import poseidon_ref as pref
from .synthetic import rsa_pubkey_hash_oracle, ecdsa_pubkey_hash_oracle
from . import x509


class SparseMerkleTree:
    """Fixed-depth iden3-style SMT over (key -> value) pairs."""

    def __init__(self, depth: int = 80):
        self.depth = depth
        self.leaves: Dict[int, int] = {}
        self._root_cache = None

    def insert(self, key: int, value: int):
        self.leaves[key] = value
        self._root_cache = None

    # -- recursive build ----------------------------------------------------

    def _subtree(self, keys: List[int], level: int) -> int:
        if not keys:
            return 0
        if len(keys) == 1:
            k = keys[0]
            return pref.poseidon([k, self.leaves[k], 1])
        if level >= self.depth:
            raise ValueError("key-prefix collision beyond tree depth")
        left = [k for k in keys if not (k >> level) & 1]
        right = [k for k in keys if (k >> level) & 1]
        return pref.poseidon([self._subtree(left, level + 1),
                              self._subtree(right, level + 1)])

    def root(self) -> int:
        if self._root_cache is None:
            self._root_cache = self._subtree(sorted(self.leaves), 0)
        return self._root_cache

    def prove(self, key: int) -> Tuple[int, List[int]]:
        """Inclusion proof: (root, siblings[depth]) with siblings[0] the
        root-most level — the layout ops/smt.verify consumes."""
        if key not in self.leaves:
            raise KeyError("key not in tree")
        siblings = [0] * self.depth
        keys = sorted(self.leaves)
        level = 0
        while len(keys) > 1:
            bit = (key >> level) & 1
            same = [k for k in keys if ((k >> level) & 1) == bit]
            other = [k for k in keys if ((k >> level) & 1) != bit]
            siblings[level] = self._subtree(other, level + 1)
            keys = same
            level += 1
        return self.root(), siblings


def pubkey_hash_of_cert(cert_der: bytes) -> int:
    """DS certificate -> circuit pubkey hash (RSA: Poseidon5 of 192-bit
    chunks, passportVerificationBuilder.circom:182-191; ECDSA: Poseidon2 of
    truncated coords, :193-232)."""
    parsed = x509.parse_certificate_pubkey(cert_der)
    if parsed[0] == "rsa":
        return rsa_pubkey_hash_oracle(parsed[1])
    _, curve_name, (qx, qy) = parsed
    from ..ops.curves import CURVES
    return ecdsa_pubkey_hash_oracle(qx, qy, CURVES[curve_name].p.bit_length())


def build_master_list(cert_ders: Iterable[bytes],
                      depth: int = 80) -> SparseMerkleTree:
    """Master list from DER certificates: key = value = pubkey hash."""
    tree = SparseMerkleTree(depth)
    for der in cert_ders:
        h = pubkey_hash_of_cert(der)
        tree.insert(h, h)
    return tree
