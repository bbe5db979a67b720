"""Multi-limb bignum gadgets over 64-bit limb signals.

Constraint twin of the reference's circuits/lib/circuits/bigInt/
bigInt.circom (BigMult :81, BigMod witness/check discipline :139-203,
BigMultModP :206-272, PowerMod :280-340) with the same hint-then-check
structure: products are schoolbook mul wires, normalization/quotients are
hinted and re-constrained with range-checked carries (`<--` paired with
`===`, SURVEY §5).

A big integer is a list of 64-bit limb Sigs, little-endian — the
reference's CHUNK_SIZE=64 layout (signatureVerification.circom:13-116),
NOT the witness kernels' 16-bit limb layout; the two meet at
`value()`/`from_ints` int level.

The port's copy of
``passport_zk_circuits_tpu/circuit/bignum.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from .builder import Builder, Sig

W = 64
BASE = 1 << W
MASK = BASE - 1


class Big:
    """n-limb 64-bit bignum signal with tracked per-instance int values."""

    __slots__ = ("limbs", "vals")

    def __init__(self, limbs: List[Sig], vals: List[int]):
        self.limbs = limbs
        self.vals = vals               # per-instance Python ints

    @property
    def n(self):
        return len(self.limbs)


def from_input(b: Builder, ints: Sequence[int], n_limbs: int,
               range_check: bool = True) -> Big:
    """Limb wires from per-instance values (range-checked: inputs are
    untrusted, bigInt.circom range discipline)."""
    ints = [int(v) for v in ints]
    limbs = []
    for i in range(n_limbs):
        s = b.input([(v >> (W * i)) & MASK for v in ints], f"big_l{i}")
        if range_check:
            b.num2bits(s, W, "big_rc")
        limbs.append(s)
    return Big(limbs, ints)


def from_bits(b: Builder, bits: Sequence[Sig], vals: List[int],
              n_limbs: int) -> Big:
    """Recompose LSB-first bit signals into 64-bit limbs (free — bits are
    already boolean-constrained)."""
    limbs = []
    for i in range(n_limbs):
        chunk = bits[W * i:W * (i + 1)]
        acc = b.const(0)
        for j, s in enumerate(chunk):
            acc = acc + s.scale(1 << j)
        limbs.append(acc)
    return Big(limbs, [int(v) % (1 << (W * n_limbs)) for v in vals])


def constant(b: Builder, v: int, n_limbs: int) -> Big:
    return Big([b.const((v >> (W * i)) & MASK) for i in range(n_limbs)],
               [v] * b.batch)


def _carry_equalize(b: Builder, lhs_lcs: List[Sig], lhs_max_bits: int,
                    rhs: Big):
    """Constrain sum(lhs_lcs[k] b^k) == rhs, where each lhs term is an
    overflowed coefficient LC < 2^lhs_max_bits and rhs is limb-normalized.
    Hinted running carry, range-checked to lhs_max_bits - W + 1 bits
    (the ProcessChunk/RemoveOverflow analog, bigIntHelpers.circom:129-249).
    """
    carry_bits = lhs_max_bits - W + 1
    carry = b.const(0)
    carry_val = [0] * b.batch
    lhs_vals = [[int(x) for x in lc.val()] for lc in lhs_lcs]
    for k in range(rhs.n):
        lc = lhs_lcs[k] if k < len(lhs_lcs) else b.const(0)
        lv = lhs_vals[k] if k < len(lhs_lcs) else [0] * b.batch
        rv = [(v >> (W * k)) & MASK for v in rhs.vals]
        t_val = [lv[i] + carry_val[i] - rv[i] for i in range(b.batch)]
        assert all(v % BASE == 0 for v in t_val), "carry equalize mismatch"
        carry_val = [v >> W for v in t_val]
        if k < rhs.n - 1:
            new_carry = b.hint(carry_val, "carry")
            b.num2bits(new_carry, carry_bits, "carry_rc")
            b.enforce_eq(lc + carry, rhs.limbs[k] + new_carry.scale(BASE))
            carry = new_carry
        else:
            # top: the final carry must be zero (rhs holds the full value)
            assert all(v == 0 for v in carry_val), "top carry nonzero"
            b.enforce_eq(lc + carry, rhs.limbs[k])


def mult(b: Builder, x: Big, y: Big) -> Big:
    """Full product, normalized limbs hinted + carry-checked
    (BigMult analog, bigInt.circom:81-137)."""
    n, m = x.n, y.n
    prods = [[b.mul(x.limbs[i], y.limbs[j], "bigmul")
              for j in range(m)] for i in range(n)]
    coeffs = []
    for k in range(n + m - 1):
        acc = b.const(0)
        for i in range(max(0, k - m + 1), min(n, k + 1)):
            acc = acc + prods[i][k - i]
        coeffs.append(acc)

    zvals = [xv * yv for xv, yv in
             zip(x.vals, y.vals)]
    z = Big([], zvals)
    for i in range(n + m):
        s = b.hint([(v >> (W * i)) & MASK for v in zvals], "bigmul_out")
        b.num2bits(s, W, "bigmul_rc")
        z.limbs.append(s)
    # coefficient k < min(n,m) * 2^128: bound the carry width accordingly
    max_bits = 2 * W + (min(n, m) - 1).bit_length() + 1
    _carry_equalize(b, coeffs, max_bits, z)
    return z


def lt(b: Builder, x: Big, y: Big) -> Sig:
    """x < y over equal-limb bignums (BigLessThan analog,
    bigIntComparators.circom:19-56): limb-wise compare chained MSB-down."""
    assert x.n == y.n
    res = b.const(0)
    for i in range(x.n):                      # LSB -> MSB accumulate
        diff = y.limbs[i] - x.limbs[i] + b.const(BASE)
        bits = b.num2bits(diff, W + 1, "biglt")
        eq_i = b.is_zero(x.limbs[i] - y.limbs[i])
        # x_i < y_i  <=>  diff > 2^64  <=> bits[W]==1 and diff != 2^64
        lt_i = b.and_(bits[W], b.not_(eq_i))
        res = b.select(eq_i, res, lt_i)
    return res


def mod_mul(b: Builder, x: Big, y: Big, m: Big, canonical: bool = False
            ) -> Big:
    """(x*y) mod m via hinted quotient/remainder: q*m + r == x*y with q, r
    range-checked (BigMultModP / BigMod discipline, bigInt.circom:139-272).

    canonical=False skips the r < m comparison: r is then any
    range-checked n-limb representative — sound for chained modexp steps;
    set canonical=True on the final step before byte-level comparisons."""
    n = x.n
    assert y.n == n and m.n == n
    prods = [[b.mul(x.limbs[i], y.limbs[j], "mm")
              for j in range(m.n)] for i in range(n)]
    qv = [(xv * yv) // mv for xv, yv, mv in zip(x.vals, y.vals, m.vals)]
    rv = [(xv * yv) % mv for xv, yv, mv in zip(x.vals, y.vals, m.vals)]

    def hint_big(vals, nl, label):
        limbs = []
        for i in range(nl):
            s = b.hint([(v >> (W * i)) & MASK for v in vals], label)
            b.num2bits(s, W, label + "_rc")
            limbs.append(s)
        return Big(limbs, vals)

    q = hint_big(qv, n + 1, "mm_q")
    r = hint_big(rv, n, "mm_r")

    # lhs coefficients of q*m + r; rhs = x*y as a normalized 2n-limb hint
    qm = [[b.mul(q.limbs[i], m.limbs[j], "mm_qm")
           for j in range(n)] for i in range(n + 1)]
    coeffs = []
    for k in range(2 * n + 1):
        acc = b.const(0)
        for i in range(max(0, k - n + 1), min(n + 1, k + 1)):
            acc = acc + qm[i][k - i]
        for i in range(max(0, k - n + 1), min(n, k + 1)):
            acc = acc + prods[i][k - i].scale(-1)
        if k < n:
            acc = acc + r.limbs[k]
        coeffs.append(acc)
    # q*m + r - x*y == 0: run the carry chain against the zero bignum.
    # coefficients are signed; shift by adding a static offset to keep
    # hints nonneg: use balanced check instead — sum with carries must be 0
    _signed_zero_check(b, coeffs,
                       2 * W + (n + 1).bit_length() + 1,
                       [qvv * mvv + rvv - xvv * yvv for qvv, mvv, rvv,
                        xvv, yvv in zip(q.vals, m.vals, r.vals,
                                        x.vals, y.vals)])
    if canonical:
        b.enforce_eq(lt(b, r, m), 1)
    return r


def _signed_zero_check(b: Builder, coeffs: List[Sig], max_bits: int,
                       total_vals: List[int]):
    """Constrain sum(coeffs[k] b^k) == 0 where coefficients are signed LCs
    with |coeff| < 2^max_bits (BigIntIsZero analog,
    bigIntComparators.circom:105-157): running signed carry, offset by
    2^carry_bits to range-check as nonnegative."""
    assert all(v == 0 for v in total_vals), "zero check witness mismatch"
    carry_bits = max_bits - W + 2
    off = 1 << carry_bits
    n = len(coeffs)
    carry = b.const(0)
    carry_val = [0] * b.batch
    for k in range(n):
        cvals = [int(v) for v in coeffs[k].val()]
        # interpret mod P as signed (values are tiny vs P)
        from .builder import P
        cvals = [v - P if v > P // 2 else v for v in cvals]
        t_val = [cv + ca for cv, ca in zip(cvals, carry_val)]
        assert all(v % BASE == 0 for v in t_val), "signed chain mismatch"
        carry_val = [v >> W for v in t_val]
        if k < n - 1:
            new_carry = b.hint([v + off for v in carry_val], "scarry")
            b.num2bits(new_carry, carry_bits + 1, "scarry_rc")
            shifted = new_carry - b.const(off)
            b.enforce_eq(coeffs[k] + carry, shifted.scale(BASE))
            carry = shifted
        else:
            assert all(v == 0 for v in carry_val)
            b.enforce_eq(coeffs[k] + carry, 0)


def pow_mod(b: Builder, base: Big, exp: int, m: Big) -> Big:
    """Fixed-exponent modexp (PowerMod analog, bigInt.circom:280-340,
    square-and-multiply over exp_to_bits). Intermediate steps keep
    redundant (non-canonical) residues; the result is canonicalized."""
    bits = bin(exp)[2:]
    acc = base
    for i, bit in enumerate(bits[1:]):
        last = i == len(bits) - 2
        acc = mod_mul(b, acc, acc, m, canonical=last and bit != "1")
        if bit == "1":
            acc = mod_mul(b, acc, base, m, canonical=last)
    return acc
