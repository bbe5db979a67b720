"""ECDSA signature verification as R1CS constraints.

Constraint twin of the reference's circuits/lib/circuits/signatures/
ecdsa.circom:18-91 (verifyECDSABits: hash bits -> order chunks, s^-1 via
BigModInv, u1 = s^-1 h, u2 = s^-1 r, R = u1*G + u2*PK, x(R) mod n === r),
built on circuit/weierstrass (dummy-offset windowed mults) and
circuit/bignum (hinted mod-n arithmetic). Oracle: ops/ecdsa.verify /
utils/ecdsa_ref — the batched witness kernels these constraints must
reproduce bit-exactly.

Documented strengthenings over the reference (mirroring ops/ecdsa.py):
  * r, s are constrained to [1, n-1] (the reference accepts any chunks);
  * the public key is constrained on-curve;
  * x(R) is canonicalized (< p) before the mod-n comparison, so a prover
    cannot pick the x or x+p representative per instance
    (curve.circom:305-312 leaves this open as a recommendation).

The port's copy of
``passport_zk_circuits_tpu/circuit/ecdsa.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops.curves import Curve, CURVES
from .builder import Builder, Sig
from .bignum import Big, W, MASK
from . import bignum as cbn
from . import weierstrass as cw


def _bits_lsb_from_msb(bits_msb: Sequence[Sig]) -> List[Sig]:
    return list(bits_msb)[::-1]


def hash_to_scalar(b: Builder, digest_bits_msb: Sequence[Sig],
                   cv: Curve) -> Big:
    """Leftmost min(hash_len, nbits(n)) digest bits as an order-field
    element (ecdsa.circom:33-40 bits2num chunking + the standard ECDSA
    truncation of utils/ecdsa_ref._hash_to_int). Free (bits are already
    boolean-constrained)."""
    n = cw.k64(cv)
    keep = min(len(digest_bits_msb), cv.n.bit_length())
    kept = list(digest_bits_msb[:keep])
    cols = [[int(v) for v in s.val()] for s in kept]
    h_vals = [sum(cols[i][j] << (keep - 1 - i) for i in range(keep))
              for j in range(b.batch)]
    return cbn.from_bits(b, _bits_lsb_from_msb(kept), h_vals, n)


def _enforce_nonzero(b: Builder, x: Big):
    """At least one limb nonzero: product of per-limb IsZero flags == 0."""
    acc = b.is_zero(x.limbs[0])
    for limb in x.limbs[1:]:
        acc = b.mul(acc, b.is_zero(limb), "nz")
    b.enforce_zero(acc)


def _enforce_eq_const(b: Builder, x: Big, v: int):
    for i, limb in enumerate(x.limbs):
        b.enforce_eq(limb, (v >> (W * i)) & MASK)


def scalar_bits(b: Builder, x: Big) -> List[Sig]:
    """LSB-first bit decomposition of a limb bignum (64 per limb)."""
    bits: List[Sig] = []
    for limb in x.limbs:
        bits.extend(b.num2bits(limb, W, "sbits"))
    return bits


def verify(b: Builder, curve_name: str, pk: cw.CPoint, r: Big, s: Big,
           digest_bits_msb: Sequence[Sig]):
    """Enforce ECDSA validity of (r, s) on digest under pk. All checks are
    hard constraints (the register circuits enforce the signature,
    passportVerificationBuilder.circom:161-180)."""
    cv = CURVES[curve_name]
    n_ord = cv.n
    nl = cw.k64(cv)
    order = cbn.constant(b, n_ord, nl)

    # r, s in [1, n-1]  (strengthened)
    b.enforce_eq(cbn.lt(b, r, order), 1)
    b.enforce_eq(cbn.lt(b, s, order), 1)
    _enforce_nonzero(b, r)
    _enforce_nonzero(b, s)
    # pk on curve  (strengthened)
    cw.on_curve(b, pk, cv)

    # s_inv: hinted + checked s * s_inv ≡ 1 mod n (BigModInv discipline,
    # bigInt.circom:352-393)
    sinv = cw.hint_big(b, [pow(v % n_ord, -1, n_ord) for v in s.vals],
                       nl, "sinv")
    _enforce_eq_const(b, cbn.mod_mul(b, s, sinv, order, canonical=True), 1)

    h = hash_to_scalar(b, digest_bits_msb, cv)
    u1 = cbn.mod_mul(b, sinv, h, order)        # any representative: the
    u2 = cbn.mod_mul(b, sinv, r, order)        # group kills multiples of n

    g_part = cw.gen_mul(b, scalar_bits(b, u1), cv)
    q_part = cw.scalar_mul(b, scalar_bits(b, u2), pk, cv)
    acc = cw.ec_add(b, g_part[0], q_part[0], cv)
    R = cw.remove_dummy(b, (acc, g_part[1] + q_part[1]), cv)

    # canonicalize x(R) (strengthened), then x(R) mod n === r
    # (ecdsa.circom:82-90)
    p_big = cbn.constant(b, cv.p, nl)
    b.enforce_eq(cbn.lt(b, R.x, p_big), 1)
    x_mod_n = cbn.mod_mul(b, R.x, cbn.constant(b, 1, nl), order,
                          canonical=True)
    for i in range(nl):
        b.enforce_eq(x_mod_n.limbs[i], r.limbs[i])
    return R


def pubkey_hash(b: Builder, pk: cw.CPoint, field_bits: int, pose):
    """Poseidon2(X_trunc, Y_trunc) with coordinates truncated to their low
    min(field, 248) bits (passportVerificationBuilder.circom:193-231;
    witness twin models/passport_verification.ecdsa_pubkey_hash)."""
    keep = min(field_bits, 248)
    outs = []
    for coord in (pk.x, pk.y):
        acc = b.const(0)
        full = keep // W
        for i in range(full):
            acc = acc + coord.limbs[i].scale(1 << (W * i))
        rem = keep - W * full
        if rem:
            bits = b.num2bits(coord.limbs[full], W, "pkh")
            low = b.const(0)
            for i in range(rem):
                low = low + bits[i].scale(1 << i)
            acc = acc + low.scale(1 << (W * full))
        outs.append(acc)
    return pose.poseidon(b, outs)
