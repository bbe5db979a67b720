"""Pure-Python ECDSA sign/verify oracle for fixture generation and tests.

The port's own copy of ``passport_zk_circuits_tpu/utils/ecdsa_ref.py``,
held equal to it by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import hashlib

from ..ops.curves import Curve


def _add(c: Curve, P, Q):
    p, a = c.p, c.a
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P == Q:
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def scalar_mul(c: Curve, k: int, P):
    R, Q = None, P
    while k:
        if k & 1:
            R = _add(c, R, Q)
        Q = _add(c, Q, Q)
        k >>= 1
    return R


def keygen(c: Curve, rng):
    d = rng.randrange(1, c.n)
    return d, scalar_mul(c, d, (c.gx, c.gy))


def _hash_to_int(c: Curve, digest: bytes) -> int:
    h = int.from_bytes(digest, "big")
    extra = len(digest) * 8 - c.n.bit_length()
    if extra > 0:
        h >>= extra
    return h


def sign(c: Curve, d: int, digest: bytes, rng):
    h = _hash_to_int(c, digest)
    while True:
        k = rng.randrange(1, c.n)
        R = scalar_mul(c, k, (c.gx, c.gy))
        r = R[0] % c.n
        if r == 0:
            continue
        s = pow(k, -1, c.n) * (h + r * d) % c.n
        if s:
            return r, s


def verify(c: Curve, Q, digest: bytes, r: int, s: int) -> bool:
    if not (0 < r < c.n and 0 < s < c.n):
        return False
    h = _hash_to_int(c, digest)
    w = pow(s, -1, c.n)
    u1, u2 = h * w % c.n, r * w % c.n
    R = _add(c, scalar_mul(c, u1, (c.gx, c.gy)), scalar_mul(c, u2, Q))
    return R is not None and R[0] % c.n == r
