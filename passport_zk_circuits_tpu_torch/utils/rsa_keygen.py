"""Pure-Python RSA key generation (Miller-Rabin) for synthetic test
fixtures: the framework ships no real passports. The port's own copy of
``passport_zk_circuits_tpu/utils/rsa_keygen.py``."""

from __future__ import annotations

import random

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def _is_probable_prime(n: int, rng: random.Random, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_prime(bits: int, rng: random.Random, e: int = 65537) -> int:
    while True:
        p = rng.getrandbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(p, rng) and (p - 1) % e != 0:
            return p


def gen_rsa_key(bits: int, rng: random.Random, e: int = 65537):
    """Returns (n, e, d) with n exactly `bits` bits."""
    while True:
        p = gen_prime(bits // 2, rng, e)
        q = gen_prime(bits - bits // 2, rng, e)
        n = p * q
        if n.bit_length() != bits or p == q:
            continue
        lam = (p - 1) * (q - 1)
        try:
            d = pow(e, -1, lam)
        except ValueError:
            continue
        return n, e, d
