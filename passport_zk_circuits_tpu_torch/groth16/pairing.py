"""Host-side BN254 (alt_bn128) tower fields, G2, and the optimal-ate pairing.

The reference delegates proof verification to snarkjs
(the reference's circuits/scripts/verify.sh:19-21) whose pairing lives in
ffjavascript. This module is the from-scratch Python equivalent used by
groth16.verify: exact integer arithmetic, no device involvement (the pairing
runs once per proof; the prover's hot loops — NTT/MSM — are the device path in
groth16.protocol).

Tower: Fq2 = Fq[u]/(u^2+1); Fq12 = Fq[w]/(w^12 - 18 w^6 + 82), with
w^6 = 9 + u (so the sextic twist maps E'(Fq2) into E(Fq12)).

Everything is self-checked by tests/test_groth16.py (bilinearity,
non-degeneracy) rather than trusted.

The port's copy of ``passport_zk_circuits_tpu/groth16/pairing.py`` (host
code over Python ints), with the same relative imports, which here name
the port's modules; ``tests/test_torch_copies.py`` holds its code equal
to the original's.
"""

from __future__ import annotations

# BN254 base-field modulus (EIP-196), scalar-field order r, and the BN
# parameter-derived ate loop count 6x+2 for x = 4965661367192848881.
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ATE_LOOP_COUNT = 29793968203157093288
_LOG_ATE = 63  # MSB (bit 64) is the implicit leading 1 of the Miller loop


# -- generic polynomial-extension field elements ----------------------------

def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_divmod(a, b):
    """Long division of coefficient lists (little-endian) over Fq."""
    a = [x % Q for x in a]
    b = [x % Q for x in b]
    da, db = _deg(a), _deg(b)
    if da < db:
        return [0], a
    quot = [0] * (da - db + 1)
    inv_lead = pow(b[db], Q - 2, Q)
    rem = a[:]
    for i in range(da - db, -1, -1):
        coef = rem[db + i] * inv_lead % Q
        quot[i] = coef
        if coef:
            for j in range(db + 1):
                rem[i + j] = (rem[i + j] - coef * b[j]) % Q
    return quot, rem


class FQP:
    """Element of Fq[x]/(modulus). Subclasses pin degree + modulus."""

    degree: int = 0
    mod_coeffs: tuple = ()          # x^degree + sum mod_coeffs[i] x^i = 0

    __slots__ = ("coeffs",)

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = tuple(c % Q for c in coeffs)

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)

    def __eq__(self, other):
        return type(self) is type(other) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash(self.coeffs)

    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, other):
        d = self.degree
        if isinstance(other, int):
            return type(self)([a * other for a in self.coeffs])
        acc = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                oc = other.coeffs
                for j in range(d):
                    acc[i + j] += a * oc[j]
        # fold x^k (k >= d) down via the modulus relation
        mc = self.mod_coeffs
        for i in range(2 * d - 2, d - 1, -1):
            top = acc[i] % Q
            if top:
                base = i - d
                for j, m in enumerate(mc):
                    if m:
                        acc[base + j] -= top * m
        return type(self)(acc[:d])

    __rmul__ = __mul__

    def inv(self):
        """Inverse via extended Euclid over Fq[x]."""
        d = self.degree
        mod_poly = list(self.mod_coeffs) + [1]
        t0, t1 = [0], [1]
        r0, r1 = mod_poly, list(self.coeffs)
        while _deg(r1) > 0 or r1[0] != 0:
            qt, rem = _poly_divmod(r0, r1)
            r0, r1 = r1, rem
            # t0 - qt*t1
            prod = [0] * (len(qt) + len(t1) - 1)
            for i, qc in enumerate(qt):
                if qc:
                    for j, tc in enumerate(t1):
                        prod[i + j] += qc * tc
            nt = [( (t0[i] if i < len(t0) else 0) - prod[i]) % Q
                  for i in range(max(len(t0), len(prod)))]
            t0, t1 = t1, nt
        s = pow(r0[0], Q - 2, Q)
        out = [(t0[i] if i < len(t0) else 0) * s % Q for i in range(d)]
        return type(self)(out)

    def __truediv__(self, other):
        return self * other.inv()

    def __pow__(self, n: int):
        if n < 0:
            return self.inv() ** (-n)
        result = type(self).one()
        base = self
        while n:
            if n & 1:
                result = result * base
            base = base * base
            n >>= 1
        return result

    def __repr__(self):
        return f"{type(self).__name__}{self.coeffs}"


class FQ1(FQP):
    """Fq itself, wrapped so the generic curve ops work uniformly."""
    degree = 1
    mod_coeffs = (0,)

    def __mul__(self, other):  # fast path
        if isinstance(other, int):
            return FQ1([self.coeffs[0] * other])
        return FQ1([self.coeffs[0] * other.coeffs[0]])

    __rmul__ = __mul__

    def inv(self):
        return FQ1([pow(self.coeffs[0], Q - 2, Q)])


class FQ2(FQP):
    degree = 2
    mod_coeffs = (1, 0)             # u^2 = -1


class FQ12(FQP):
    degree = 12
    mod_coeffs = (82, 0, 0, 0, 0, 0, (-18) % Q, 0, 0, 0, 0, 0)


# -- generic affine curve ops (None = point at infinity) --------------------
# y^2 = x^3 + b over any of the fields above; all BN254 groups have a = 0.

def ec_double(pt):
    if pt is None:
        return None
    x, y = pt
    if y.is_zero():
        return None
    m = (x * x * 3) / (y * 2)
    nx = m * m - x - x
    ny = m * (x - nx) - y
    return (nx, ny)


def ec_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return ec_double(p1)
        return None
    m = (y2 - y1) / (x2 - x1)
    nx = m * m - x1 - x2
    ny = m * (x1 - nx) - y1
    return (nx, ny)


def ec_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def ec_mul(pt, k: int):
    k %= R
    result = None
    add = pt
    while k:
        if k & 1:
            result = ec_add(result, add)
        add = ec_double(add)
        k >>= 1
    return result


def on_curve(pt, b):
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == b


# -- group generators --------------------------------------------------------

G1 = (FQ1([1]), FQ1([2]))
B1 = FQ1([3])

G2 = (FQ2([10857046999023057135944570762232829481370756359578518086990519993285655852781,
           11559732032986387107991004021392285783925812861821192530917403151452391805634]),
      FQ2([8495653923123431417604973247489272438418190587263600148770280649306958101930,
           4082367875863433681332203403145435568316851327593401208105741076214120093531]))
B2 = FQ2([3, 0]) / FQ2([9, 1])

assert on_curve(G1, B1) and on_curve(G2, B2)


# -- twist E'(Fq2) -> E(Fq12) -------------------------------------------------

_W = FQ12([0, 1] + [0] * 10)
_W2 = _W * _W
_W3 = _W2 * _W


def twist(pt):
    """Map an E'(Fq2) point to E(Fq12) using u = w^6 - 9."""
    if pt is None:
        return None
    x, y = pt
    xc = [(x.coeffs[0] - 9 * x.coeffs[1]) % Q, x.coeffs[1]]
    yc = [(y.coeffs[0] - 9 * y.coeffs[1]) % Q, y.coeffs[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * _W2, ny * _W3)


def cast_g1(pt):
    """Embed a G1 point ((FQ1,FQ1) or int pair) into E(Fq12)."""
    if pt is None:
        return None
    x, y = pt
    xi = x.coeffs[0] if isinstance(x, FQP) else x % Q
    yi = y.coeffs[0] if isinstance(y, FQP) else y % Q
    return (FQ12([xi] + [0] * 11), FQ12([yi] + [0] * 11))


# -- Miller loop + final exponentiation --------------------------------------

def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all in E(Fq12))."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q_pt, p_pt):
    """Miller loop WITHOUT the final exponentiation (so products of loops
    share one final exp). q_pt, p_pt: points in E(Fq12) (twist/cast first)."""
    if q_pt is None or p_pt is None:
        return FQ12.one()
    r_pt = q_pt
    f = FQ12.one()
    for i in range(_LOG_ATE, -1, -1):
        f = f * f * _linefunc(r_pt, r_pt, p_pt)
        r_pt = ec_double(r_pt)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r_pt, q_pt, p_pt)
            r_pt = ec_add(r_pt, q_pt)
    q1 = (q_pt[0] ** Q, q_pt[1] ** Q)
    nq2 = (q1[0] ** Q, -(q1[1] ** Q))
    f = f * _linefunc(r_pt, q1, p_pt)
    r_pt = ec_add(r_pt, q1)
    f = f * _linefunc(r_pt, nq2, p_pt)
    return f


_FINAL_EXP = (Q ** 12 - 1) // R


def final_exponentiate(f):
    return f ** _FINAL_EXP


def pairing(q_pt, p_pt):
    """Full optimal-ate pairing e(P, Q): q_pt in E'(Fq2), p_pt in G1."""
    return final_exponentiate(miller_loop(twist(q_pt), cast_g1(p_pt)))
