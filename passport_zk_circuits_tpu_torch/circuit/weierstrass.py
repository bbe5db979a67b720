"""Short-Weierstrass point gadgets over 64-bit limb signals — the R1CS
constraint twin of the reference's circuits/lib/circuits/ec/curve.circom.

Structure (hint-then-check, SURVEY §5):
  * affine add/double results AND the chord/tangent slope lambda are hinted
    from host ints (`<--`, EllipticCurveAdd/Double curve.circom:281-355
    hint x3/y3 via prod_mod vars) and re-constrained with quadratic
    identities checked mod p by `zero_mod_p` (the BigIntIsZeroModP analog,
    bigIntComparators.circom:105-157);
  * hinting lambda explicitly lets each identity stay degree-2 in limb
    products — 3 cheap identities per add/double instead of the
    reference's PointOnLine + PointOnCurve pair (curve.circom:107-241),
    and it pins (x3, y3) UNIQUELY given x1 != x2, closing the
    x3 in {x1, x2} malleability the on-line+on-curve form leaves open
    (documented strengthening, like ops/ecdsa.py's input checks);
  * scalar multiplication is 4-bit windowed (EllipticCurveScalarMult
    WINDOW_SIZE=4, curve.circom:359-516) with a dummy-offset table:
    T[d] = [d]Q + D for a nothing-up-my-sleeve point D whose discrete log
    nobody knows (the reference instead uses a generator multiple as its
    dummy, curve.circom EllipticCurveGetDummy, and per-window Switcher
    chains; NUMS-D makes every incomplete addition's bad case — equal x
    coordinates — a discrete-log break, so no switchers are needed);
  * fixed-base generator mults use stride-8 precomputed constant tables
    (EllipicCurveScalarGeneratorMult, curve.circom:680-740), each entry
    offset by the same D, selected by two-level one-hot — constant-table
    selection is linear, so a window costs ~1 add.

Witness math rides utils/ecdsa_ref (the test oracle) over Python ints.

The port's copy of
``passport_zk_circuits_tpu/circuit/weierstrass.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's, but for ``_gen_tables``, which computes its tables in
memory where the original caches them in an ``.npz`` file beside
itself (loaded with ``allow_pickle``).
"""

from __future__ import annotations

import functools
import hashlib
from typing import List, Sequence

import numpy as np

from ..ops.curves import Curve, CURVES
from ..utils import ecdsa_ref as ecref
from .builder import Builder, Sig, P as FR_P
from .bignum import Big, W, MASK, _signed_zero_check
from . import bignum as cbn


class CPoint:
    """Affine curve point: two k64-limb Bigs (never infinity — infinity
    cases are excluded by the dummy-offset construction, see module doc)."""

    __slots__ = ("x", "y")

    def __init__(self, x: Big, y: Big):
        self.x = x
        self.y = y

    def vals(self) -> List[tuple]:
        return list(zip(self.x.vals, self.y.vals))


def k64(cv: Curve) -> int:
    return -(-cv.p.bit_length() // W)


def hint_big(b: Builder, vals: Sequence[int], n_limbs: int,
             label: str) -> Big:
    """Hinted bignum: limb wires range-checked to 64 bits (`<--` + rc)."""
    vals = [int(v) for v in vals]
    limbs = []
    for i in range(n_limbs):
        s = b.hint([(v >> (W * i)) & MASK for v in vals], label)
        b.num2bits(s, W, label + "_rc")
        limbs.append(s)
    return Big(limbs, vals)


def coeff_mul(b: Builder, xs: Sequence[Sig], ys: Sequence[Sig]
              ) -> List[Sig]:
    """Overflowed product coefficients of two limb-LC lists (the
    BigMultOverflow analog, bigIntOverflow.circom): len(xs)+len(ys)-1
    signed coefficient LCs, one mul wire per limb pair."""
    prods = [[b.mul(x, y, "ecmul") for y in ys] for x in xs]
    out = []
    for k in range(len(xs) + len(ys) - 1):
        acc = b.const(0)
        for i in range(max(0, k - len(ys) + 1), min(len(xs), k + 1)):
            acc = acc + prods[i][k - i]
        out.append(acc)
    return out


def zero_mod_p(b: Builder, coeffs: List[Sig], coeff_bound_bits: int,
               p: int):
    """Constrain sum(coeffs[k] 2^(64k)) ≡ 0 (mod p) for signed coefficient
    LCs with |coeff| < 2^coeff_bound_bits (BigIntIsZeroModP twin,
    bigIntComparators.circom:105-157): hint the exact quotient q = V/p
    (offset to nonnegative, limbs range-checked), fold -q*p + the offset
    constant into the coefficients (p is constant, so this is linear in
    the q limbs), and run the signed carry chain to zero."""
    # signed witness values
    vals = []
    for csig in coeffs:
        v = [int(x) for x in csig.val()]
        vals.append([x - FR_P if x > FR_P // 2 else x for x in v])
    V = [sum(vals[k][i] << (W * k) for k in range(len(coeffs)))
         for i in range(b.batch)]
    assert all(v % p == 0 for v in V), "zero_mod_p witness not divisible"

    L = len(coeffs)
    vbits = coeff_bound_bits + W * (L - 1) + 1
    qbits = max(vbits - p.bit_length() + 1, 1)
    off = 1 << qbits
    nq = (qbits + 1 + W - 1) // W
    qs = hint_big(b, [(v // p) + off for v in V], nq, "qmodp")

    npl = -(-p.bit_length() // W)
    pl = [(p >> (W * j)) & MASK for j in range(npl)]
    offp = off * p
    lp = max(L, nq + npl)
    new_coeffs = []
    for k in range(lp):
        acc = coeffs[k] if k < L else b.const(0)
        for i in range(max(0, k - npl + 1), min(nq, k + 1)):
            if pl[k - i]:
                acc = acc - qs.limbs[i].scale(pl[k - i])
        ck = (offp >> (W * k)) & MASK
        if ck:
            acc = acc + b.const(ck)
        new_coeffs.append(acc)
    max_bits = max(coeff_bound_bits, 2 * W + nq.bit_length() + 1) + 1
    _signed_zero_check(b, new_coeffs, max_bits, [0] * b.batch)


def _sub_lcs(x: Big, y: Big) -> List[Sig]:
    return [a - bb for a, bb in zip(x.limbs, y.limbs)]


def const_point(b: Builder, pt, cv: Curve) -> CPoint:
    n = k64(cv)
    return CPoint(cbn.constant(b, pt[0], n), cbn.constant(b, pt[1], n))


def input_point(b: Builder, xs: Sequence[int], ys: Sequence[int],
                cv: Curve) -> CPoint:
    n = k64(cv)
    return CPoint(cbn.from_input(b, xs, n), cbn.from_input(b, ys, n))


def on_curve(b: Builder, pt: CPoint, cv: Curve):
    """Enforce y^2 ≡ x^3 + a x + b (PointOnCurve, curve.circom:107-143)."""
    n = k64(cv)
    x2 = coeff_mul(b, pt.x.limbs, pt.x.limbs)            # bound 2^130
    x3 = coeff_mul(b, x2, pt.x.limbs)                    # bound 2^197
    y2 = coeff_mul(b, pt.y.limbs, pt.y.limbs)
    coeffs = list(x3)
    for i in range(len(y2)):
        coeffs[i] = coeffs[i] - y2[i]
    # a*x as a limb convolution (a is constant, so this is linear)
    al = [(cv.a >> (W * j)) & MASK for j in range(n)]
    for k in range(2 * n - 1):
        acc = b.const(0)
        any_term = False
        for i in range(max(0, k - n + 1), min(n, k + 1)):
            if al[k - i]:
                acc = acc + pt.x.limbs[i].scale(al[k - i])
                any_term = True
        if any_term:
            coeffs[k] = coeffs[k] + acc
    for j in range(n):
        bj = (cv.b >> (W * j)) & MASK
        if bj:
            coeffs[j] = coeffs[j] + b.const(bj)
    zero_mod_p(b, coeffs, W * 3 + 4 + n.bit_length(), cv.p)


def ec_add(b: Builder, p1: CPoint, p2: CPoint, cv: Curve) -> CPoint:
    """Incomplete affine addition (requires x1 != x2 — guaranteed by the
    dummy-offset ladder, see module doc). Hinted lambda/x3/y3 + 3
    quadratic identities mod p (EllipticCurveAdd twin, curve.circom:316)."""
    p_int = cv.p
    n = k64(cv)
    lam_v, x3_v, y3_v = [], [], []
    for (x1, y1), (x2, y2) in zip(p1.vals(), p2.vals()):
        assert x1 % p_int != x2 % p_int, "ec_add hit equal x (build-time)"
        lam = (y2 - y1) * pow(x2 - x1, -1, p_int) % p_int
        x3 = (lam * lam - x1 - x2) % p_int
        lam_v.append(lam)
        x3_v.append(x3)
        y3_v.append((lam * (x1 - x3) - y1) % p_int)
    lam = hint_big(b, lam_v, n, "ec_lam")
    x3 = hint_big(b, x3_v, n, "ec_x3")
    y3 = hint_big(b, y3_v, n, "ec_y3")

    # id1: lam*(x2 - x1) - (y2 - y1) ≡ 0  (pins lam given x1 != x2)
    c1 = coeff_mul(b, lam.limbs, _sub_lcs(p2.x, p1.x))
    for i in range(n):
        c1[i] = c1[i] - (p2.y.limbs[i] - p1.y.limbs[i])
    zero_mod_p(b, c1, 2 * W + 3 + n.bit_length(), p_int)
    # id2: lam^2 - x1 - x2 - x3 ≡ 0       (pins x3)
    c2 = coeff_mul(b, lam.limbs, lam.limbs)
    for i in range(n):
        c2[i] = c2[i] - p1.x.limbs[i] - p2.x.limbs[i] - x3.limbs[i]
    zero_mod_p(b, c2, 2 * W + 3 + n.bit_length(), p_int)
    # id3: lam*(x1 - x3) - y1 - y3 ≡ 0    (pins y3)
    c3 = coeff_mul(b, lam.limbs, _sub_lcs(p1.x, x3))
    for i in range(n):
        c3[i] = c3[i] - p1.y.limbs[i] - y3.limbs[i]
    zero_mod_p(b, c3, 2 * W + 3 + n.bit_length(), p_int)
    return CPoint(x3, y3)


def ec_double(b: Builder, pt: CPoint, cv: Curve) -> CPoint:
    """Affine doubling with hinted tangent slope (EllipticCurveDouble twin,
    curve.circom:281-314; sound on prime-order curves where y != 0)."""
    p_int = cv.p
    n = k64(cv)
    lam_v, x3_v, y3_v = [], [], []
    for x1, y1 in pt.vals():
        lam = (3 * x1 * x1 + cv.a) * pow(2 * y1, -1, p_int) % p_int
        x3 = (lam * lam - 2 * x1) % p_int
        lam_v.append(lam)
        x3_v.append(x3)
        y3_v.append((lam * (x1 - x3) - y1) % p_int)
    lam = hint_big(b, lam_v, n, "dbl_lam")
    x3 = hint_big(b, x3_v, n, "dbl_x3")
    y3 = hint_big(b, y3_v, n, "dbl_y3")

    # id1: 2*lam*y - 3*x^2 - a ≡ 0        (pins lam; y != 0)
    ly = coeff_mul(b, lam.limbs, pt.y.limbs)
    xx = coeff_mul(b, pt.x.limbs, pt.x.limbs)
    c1 = [ly[k].scale(2) - xx[k].scale(3) for k in range(2 * n - 1)]
    for j in range(n):
        aj = (cv.a >> (W * j)) & MASK
        if aj:
            c1[j] = c1[j] - b.const(aj)
    zero_mod_p(b, c1, 2 * W + 5 + n.bit_length(), p_int)
    # id2: lam^2 - 2*x - x3 ≡ 0
    c2 = coeff_mul(b, lam.limbs, lam.limbs)
    for i in range(n):
        c2[i] = c2[i] - pt.x.limbs[i].scale(2) - x3.limbs[i]
    zero_mod_p(b, c2, 2 * W + 4 + n.bit_length(), p_int)
    # id3: lam*(x - x3) - y - y3 ≡ 0
    c3 = coeff_mul(b, lam.limbs, _sub_lcs(pt.x, x3))
    for i in range(n):
        c3[i] = c3[i] - pt.y.limbs[i] - y3.limbs[i]
    zero_mod_p(b, c3, 2 * W + 3 + n.bit_length(), p_int)
    return CPoint(x3, y3)


# -- NUMS dummy point ---------------------------------------------------------

def _sqrt_mod(a: int, p: int) -> int:
    """Tonelli-Shanks; returns r with r^2 ≡ a, or raises if a is a QNR."""
    if p % 4 == 3:
        r = pow(a, (p + 1) // 4, p)
    else:
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            bb = pow(c, 1 << (m - i - 1), p)
            m, c = i, bb * bb % p
            t, r = t * c % p, r * bb % p
    if r * r % p != a % p:
        raise ValueError("not a quadratic residue")
    return r


@functools.lru_cache(maxsize=None)
def dummy_point(curve_name: str):
    """Nothing-up-my-sleeve point D: x from SHA-256 of a fixed tag,
    incremented until x^3 + ax + b is a square; y the even root. Nobody
    knows log_G(D) (unlike the reference's generator-multiple dummy,
    curve.circom EllipticCurveGetDummy), so any equal-x collision inside
    the dummy-offset ladder would constitute a discrete-log break."""
    cv = CURVES[curve_name]
    x = int.from_bytes(hashlib.sha256(
        b"passport-zk-circuits-tpu/nums-dummy/" + curve_name.encode()
    ).digest(), "big") % cv.p
    while True:
        rhs = (x * x * x + cv.a * x + cv.b) % cv.p
        try:
            y = _sqrt_mod(rhs, cv.p)
            break
        except ValueError:
            x = (x + 1) % cv.p
    if y % 2:
        y = cv.p - y
    # sanity: on curve, and in the prime-order group (cofactor 1 curves)
    assert (y * y - x * x * x - cv.a * x - cv.b) % cv.p == 0
    return (x, y)


# -- one-hot window selection -------------------------------------------------

def _onehot4(b: Builder, bits: Sequence[Sig]) -> List[Sig]:
    """16 one-hot flags from 4 boolean signals (LSB first): two pair
    products (1 mul each) + 16 outer products (16 muls)."""
    b0, b1, b2, b3 = bits
    m01 = b.mul(b0, b1, "oh")
    lo = [b.const(1) - b0 - b1 + m01, b0 - m01, b1 - m01, m01]
    m23 = b.mul(b2, b3, "oh")
    hi = [b.const(1) - b2 - b3 + m23, b2 - m23, b3 - m23, m23]
    return [b.mul(lo[d & 3], hi[d >> 2], "oh") for d in range(16)]


def select_point(b: Builder, flags: Sequence[Sig], pts: Sequence[CPoint],
                 cv: Curve) -> CPoint:
    """sum_d flags[d] * pts[d] per limb (GetSumOfNElements analog,
    curve.circom:429-470). One mul per (flag, limb) pair for variable
    tables; constant-folds to linear for constant entries."""
    n = k64(cv)
    sel_idx = [max(range(len(flags)),
                   key=lambda d: int(flags[d].val()[i]))
               for i in range(b.batch)]
    out = []
    for coord in (lambda p: p.x, lambda p: p.y):
        limbs = []
        for i in range(n):
            acc = b.const(0)
            for d, f in enumerate(flags):
                acc = acc + b.mul(f, coord(pts[d]).limbs[i], "psel")
            limbs.append(acc)
        vals = [coord(pts[sel_idx[j]]).vals[j] for j in range(b.batch)]
        out.append(Big(limbs, vals))
    return CPoint(out[0], out[1])


# -- windowed variable-base scalar mult --------------------------------------

def scalar_mul(b: Builder, scalar_bits: Sequence[Sig], q: CPoint,
               cv: Curve) -> tuple:
    """[u]Q + [c]D with the dummy multiplier c returned for later removal.

    scalar_bits: boolean signals, LSB first, length 64*k64 (the full limb
    width — scalars are any range-checked representative; the group kills
    multiples of n). Table T[d] = [d]Q + D; per 4-bit window (MSB first):
    4 doublings + one table add. Returns (CPoint, c_total)."""
    n = k64(cv)
    nbits = W * n
    assert len(scalar_bits) == nbits
    d0 = dummy_point(cv.name)

    table = [const_point(b, d0, cv)]
    for d in range(1, 16):
        table.append(ec_add(b, table[-1], q, cv))

    nwin = nbits // 4
    acc = None
    c_total = 0
    for wdx in range(nwin):
        lo = nbits - 4 * (wdx + 1)
        window = scalar_bits[lo:lo + 4]
        flags = _onehot4(b, window)
        t = select_point(b, flags, table, cv)
        if acc is None:
            acc = t
            c_total = 1
        else:
            for _ in range(4):
                acc = ec_double(b, acc, cv)
            acc = ec_add(b, acc, t, cv)
            c_total = c_total * 16 + 1
    return acc, c_total


# -- fixed-base generator mult ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gen_tables(curve_name: str):
    """Stride-8 constant tables over ints: tbl[w][j] = [j * 256^w]G + D
    (EllipicCurveScalarGeneratorMult powers analog, curve.circom:680-740 /
    ec/powers; D-offset so entries are never infinity and selection stays
    linear). Computed in memory once per curve and process: nothing is
    read from or written to a file, so no pickle is loaded."""
    cv = CURVES[curve_name]
    nwin = (W * k64(cv)) // 8
    d0 = dummy_point(curve_name)
    xy = np.zeros((nwin, 256, 2), object)
    stride = (cv.gx, cv.gy)
    for w in range(nwin):
        acc = d0
        for j in range(256):
            xy[w, j] = acc
            acc = ecref._add(cv, acc, stride)
        for _ in range(8):
            stride = ecref._add(cv, stride, stride)
    return xy


def gen_mul(b: Builder, scalar_bits: Sequence[Sig], cv: Curve) -> tuple:
    """[u]G + [nwin]D via stride-8 constant tables: per byte window a
    two-level one-hot over constants (selection is linear) + one add.
    Returns (CPoint, dummy multiplier)."""
    n = k64(cv)
    nbits = W * n
    assert len(scalar_bits) == nbits
    tables = _gen_tables(cv.name)
    nwin = nbits // 8

    acc = None
    for wdx in range(nwin):
        bits = scalar_bits[8 * wdx:8 * wdx + 8]
        lo_flags = _onehot4(b, bits[:4])
        hi_flags = _onehot4(b, bits[4:])
        # selected = sum_i lo_i * (sum_j hi_j * const[16j + i])
        byte_vals = [int(sum(int(bit.val()[j]) << i
                             for i, bit in enumerate(bits)))
                     for j in range(b.batch)]
        limbs_out = []
        for coord in (0, 1):
            limbs = []
            for li in range(n):
                acc_lc = b.const(0)
                for i, lf in enumerate(lo_flags):
                    inner = b.const(0)
                    for j, hf in enumerate(hi_flags):
                        cval = (int(tables[wdx, 16 * j + i, coord])
                                >> (W * li)) & MASK
                        if cval:
                            inner = inner + hf.scale(cval)
                    acc_lc = acc_lc + b.mul(lf, inner, "gsel")
                limbs.append(acc_lc)
            vals = [int(tables[wdx, byte_vals[j], coord])
                    for j in range(b.batch)]
            limbs_out.append(Big(limbs, vals))
        t = CPoint(limbs_out[0], limbs_out[1])
        acc = t if acc is None else ec_add(b, acc, t, cv)
    return acc, nwin


def remove_dummy(b: Builder, pt_and_c: tuple, cv: Curve) -> CPoint:
    """Subtract the accumulated dummy multiple: pt + [-c]D (host-computed
    constant point)."""
    pt, c = pt_and_c
    d0 = dummy_point(cv.name)
    neg = ecref.scalar_mul(cv, cv.n - (c % cv.n), d0)
    return ec_add(b, pt, const_point(b, neg, cv), cv)
