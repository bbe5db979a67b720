"""Batched ECDSA signature verification over the registry curves.

Counterpart of ``passport_zk_circuits_tpu/ops/ecdsa.py``, plain PyTorch:
s^-1 mod n by Fermat, u1 = s^-1 h, u2 = s^-1 r, R = u1 G (fixed-base,
stride 8) + u2 PK (windowed, w = 4), x(R) mod n == r. As in the JAX package
the checks are stricter than the reference circuit's: r and s in [1, n-1],
the public key on the curve and R not at infinity. The key's coordinates
must also lie in [0, p-1] (SEC 1 v2, 3.2.2.1): the field arithmetic takes
canonical residues, and a key (x, y + p) is rejected rather than read as
(x, y).

``verify_blinded`` is the capability twin of the experimental
``ecdsaBeta.circom`` (the JAX package's ``ops/ecdsa.verify_blinded``): the
same formulas in the same order, so its verdicts equal the JAX package's.
"""

from __future__ import annotations

from . import bignum as bn
from . import bitops
from . import weierstrass as wst


def hash_bits_to_limbs(hash_bits, kn: int):
    """Big-endian hash bit tensor (nbits, *B) -> (kn, *B) limbs. A hash
    wider than the order field keeps its leftmost kn * 16 bits."""
    return bitops.bits_to_limbs(hash_bits[:kn * 16], kn, msb_first=True)


def on_curve(c: wst.CurveCtx, x, y):
    """y^2 == x^3 + a*x + b."""
    xx, yy, ax = c.mul(c.stack(x, y, x), c.stack(
        x, y, c.const_like(c.curve.a, x).expand(x.shape))).unbind(1)
    rhs = c.add(c.mul(xx, x), c.add(ax, c.const_like(c.curve.b, x).expand(
        x.shape)))
    return bn.eq(yy, rhs)


def verify(curve_name: str, pk_x, pk_y, signature, hash_bits):
    """pk_x, pk_y: (k, B) field limbs; signature: (2*kn, B) = r || s;
    hash_bits: (hash_len, B) big-endian bits. Returns bool (B,)."""
    c = wst.ctx(curve_name)
    kn = c.kn
    if c.k != kn:
        raise ValueError(f"{curve_name}: field and order limb counts differ")
    r = signature[:kn]
    s = signature[kn:2 * kn]
    h = hash_bits_to_limbs(hash_bits, kn)

    # scalar-field (mod n) arithmetic
    s_inv = c.fn.inv(s)
    u1, u2 = c.fn.mul(s_inv.unsqueeze(1), c.stack(c.fn.reduce(h), r)) \
        .unbind(1)

    R = wst.jac_add(c, wst.fixed_base_mul(c, u1),
                    wst.scalar_mul_window(c, u2, pk_x, pk_y))
    rx, _ = wst.to_affine(c, R)

    ok = bn.eq(c.fn.reduce(rx), r)
    ok = ok & ~bn.is_zero(r) & ~bn.is_zero(s)
    n_l = c.n_limbs(r)
    ok = ok & bn.lt(r, n_l) & bn.lt(s, n_l)
    p_l = bn.cached_const(c.curve.p, c.k, pk_x.device, pk_x.dim())
    ok = ok & bn.lt(pk_x, p_l) & bn.lt(pk_y, p_l)
    ok = ok & on_curve(c, pk_x, pk_y)
    return ok & ~wst.is_inf(c, R)


def verify_blinded(curve_name: str, pk_x, pk_y, signature, hash_bits,
                   beta, alpha_x, alpha_y):
    """Blinded verification: the prover supplies a blind beta (below
    2^80) and alpha = beta s^-1 r PK; the check is beta R == (beta u1) G +
    alpha and x(R) mod n == r, with R = u1 G + u2 PK, u1 = s^-1 h, u2 =
    s^-1 r, and r, s != 0. pk_x, pk_y, alpha_x, alpha_y: (k, B) field
    limbs (alpha (0, 0) is infinity); signature (2 kn, B) = r || s;
    hash_bits (hash_len, B) big-endian bits; beta (kn, B). Returns bool
    (B,)."""
    c = wst.ctx(curve_name)
    kn = c.kn
    r = signature[:kn]
    s = signature[kn:2 * kn]
    h = hash_bits_to_limbs(hash_bits, kn)

    s_inv = c.fn.inv(s)
    u1, u2 = c.fn.mul(s_inv.unsqueeze(1), c.stack(c.fn.reduce(h), r)) \
        .unbind(1)
    R = wst.jac_add(c, wst.fixed_base_mul(c, u1),
                    wst.scalar_mul_window(c, u2, pk_x, pk_y))
    rx, ry = wst.to_affine(c, R)

    # beta R (an 80-bit scalar) against (beta u1 mod n) G + alpha
    lx, ly = wst.to_affine(c, wst.scalar_mul_window(c, beta, rx, ry))
    right = wst.jac_add_affine(c, wst.fixed_base_mul(c, c.fn.mul(beta, u1)),
                               alpha_x, alpha_y,
                               bn.is_zero(alpha_x) & bn.is_zero(alpha_y))
    rxr, ryr = wst.to_affine(c, right)

    ok = bn.eq(lx, rxr) & bn.eq(ly, ryr)
    ok = ok & bn.eq(c.fn.reduce(rx), r)
    return ok & ~bn.is_zero(r) & ~bn.is_zero(s)
