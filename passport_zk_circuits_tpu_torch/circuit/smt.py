"""Sparse-Merkle-Tree inclusion verifier as an R1CS gadget.

Constraint twin of the reference's circuits/merkleTree/SMTVerifier.circom
(SMTHash1/2 :10-33, SMTLevIns :39-65, the per-level state machine :71-107
and root climb :109-175), matching the witness semantics of ops/smt.py.
Returns `is_verified` unenforced — the reference leaves enforcement to the
caller (passportVerificationBuilder.circom:240 keeps it commented out,
identityStateVerifier.circom:46 enforces it).

The port's copy of
``passport_zk_circuits_tpu/circuit/smt.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from . import poseidon as pose
from .builder import Builder, Sig


def verify(b: Builder, root: Sig, key: Sig, value: Sig,
           siblings: List[Sig]) -> Sig:
    """siblings: deepest-last list of N field signals (level 0 = root side,
    matching ops/smt.verify's (16, N, B) axis-1 ordering)."""
    n = len(siblings)
    sib_zero = [b.is_zero(s) for s in siblings]

    # SMTLevIns (top-down recurrence, SMTVerifier.circom:56-64)
    lev = [None] * n
    done = [None] * n
    lev[n - 1] = b.not_(sib_zero[n - 2])
    done[n - 1] = lev[n - 1]
    for i in range(n - 2, 0, -1):
        lev[i] = b.and_(b.not_(done[i + 1]), b.not_(sib_zero[i - 1]))
        done[i] = b.or_(done[i + 1], lev[i])
    lev[0] = b.not_(done[1])

    # state machine: st_top until levIns fires; st_inew exactly at the fire
    st_top = [None] * n
    st_inew = [None] * n
    prev_top = b.const(1)
    for i in range(n):
        st_inew[i] = b.and_(prev_top, lev[i])
        st_top[i] = b.and_(prev_top, b.not_(lev[i]))
        prev_top = st_top[i]

    key_bits = b.num2bits(key, 254, "smt_key")

    leaf = pose.poseidon(b, [key, value, b.const(1)])

    child = b.const(0)
    for i in range(n - 1, -1, -1):          # climb deepest level first
        sib = siblings[i]
        lr = key_bits[i]
        left = b.select(lr, sib, child)
        right = b.select(lr, child, sib)
        h = pose.poseidon(b, [left, right])
        child = b.mul(st_top[i], h, "smt_top") + \
            b.mul(st_inew[i], leaf, "smt_new")
    # the reference asserts the deepest sibling is zero (SMTVerifier.circom:
    # 54 SMTLevIns well-formedness); fold it into the verdict as ops/smt does
    return b.and_(b.is_equal(child, root), sib_zero[n - 1])
