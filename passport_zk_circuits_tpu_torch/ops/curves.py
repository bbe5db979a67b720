"""Short-Weierstrass curve registry (the 11 curves of the reference).

The port's own copy of ``passport_zk_circuits_tpu/ops/curves.py`` (pure
Python); ``tests/test_torch_copies.py`` holds it equal to the original curve
by curve. Parameters are the public standard values (SEC 2, FIPS 186,
RFC 5639); `validate()` proof-checks every curve (prime field, b consistency
with G, n*G = infinity) so a typo cannot survive.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Curve:
    name: str
    p: int
    a: int
    b: int
    gx: int
    gy: int
    n: int          # group order (prime)

    @property
    def bits(self) -> int:
        return self.p.bit_length()


def _c(name, p, a, b, gx, gy, n):
    return Curve(name, p, a, b, gx, gy, n)


CURVES = {c.name: c for c in [
    _c("p256",
       0xffffffff00000001000000000000000000000000ffffffffffffffffffffffff,
       0xffffffff00000001000000000000000000000000fffffffffffffffffffffffc,
       0x5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b,
       0x6b17d1f2e12c4247f8bce6e563a440f277037d812deb33a0f4a13945d898c296,
       0x4fe342e2fe1a7f9b8ee7eb4a7c0f9e162bce33576b315ececbb6406837bf51f5,
       0xffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2fc632551),
    _c("secp256k1",
       0xfffffffffffffffffffffffffffffffffffffffffffffffffffffffefffffc2f,
       0,
       7,
       0x79be667ef9dcbbac55a06295ce870b07029bfcdb2dce28d959f2815b16f81798,
       0x483ada7726a3c4655da4fbfc0e1108a8fd17b448a68554199c47d08ffb10d4b8,
       0xfffffffffffffffffffffffffffffffebaaedce6af48a03bbfd25e8cd0364141),
    _c("secp192r1",
       0xfffffffffffffffffffffffffffffffeffffffffffffffff,
       0xfffffffffffffffffffffffffffffffefffffffffffffffc,
       0x64210519e59c80e70fa7e9ab72243049feb8deecc146b9b1,
       0x188da80eb03090f67cbf20eb43a18800f4ff0afd82ff1012,
       0x07192b95ffc8da78631011ed6b24cdd573f977a11e794811,
       0xffffffffffffffffffffffff99def836146bc9b1b4d22831),
    _c("secp224r1",
       0xffffffffffffffffffffffffffffffff000000000000000000000001,
       0xfffffffffffffffffffffffffffffffefffffffffffffffffffffffe,
       0xb4050a850c04b3abf54132565044b0b7d7bfd8ba270b39432355ffb4,
       0xb70e0cbd6bb4bf7f321390b94a03c1d356c21122343280d6115c1d21,
       0xbd376388b5f723fb4c22dfe6cd4375a05a07476444d5819985007e34,
       0xffffffffffffffffffffffffffff16a2e0b8f03e13dd29455c5c2a3d),
    _c("p384",
       int("fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
           "effffffff0000000000000000ffffffff", 16),
       int("fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
           "effffffff0000000000000000fffffffc", 16),
       int("b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013875a"
           "c656398d8a2ed19d2a85c8edd3ec2aef", 16),
       int("aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e082542a38"
           "5502f25dbf55296c3a545e3872760ab7", 16),
       int("3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0b8c0"
           "0a60b1ce1d7e819d7a431d7c90ea0e5f", 16),
       int("ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f4372dd"
           "f581a0db248b0a77aecec196accc52973", 16)),
    _c("p521",
       (1 << 521) - 1,
       (1 << 521) - 4,
       0x51953eb9618e1c9a1f929a21a0b68540eea2da725b99b315f3b8b489918ef109e156193951ec7e937b1652c0bd3bb1bf073573df883d2c34f1ef451fd46b503f00,
       0xc6858e06b70404e9cd9e3ecb662395b4429c648139053fb521f828af606b4d3dbaa14b5e77efe75928fe1dc127a2ffa8de3348b3c1856a429bf97e7e31c2e5bd66,
       0x11839296a789a3bc0045c8a5fb42c7d1bd998f54449579b446817afbd17273e662c97ee72995ef42640c550b9013fad0761353c7086a272c24088be94769fd16650,
       0x1fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffa51868783bf2f966b7fcc0148f709a5d03bb5c9b8899c47aebb6fb71e91386409),
    _c("brainpoolP224r1",
       0xd7c134aa264366862a18302575d1d787b09f075797da89f57ec8c0ff,
       0x68a5e62ca9ce6c1c299803a6c1530b514e182ad8b0042a59cad29f43,
       0x2580f63ccfe44138870713b1a92369e33e2135d266dbb372386c400b,
       0x0d9029ad2c7e5cf4340823b2a87dc68c9e4ce3174c1e6efdee12c07d,
       0x58aa56f772c0726f24c6b89e4ecdac24354b9e99caa3f6d3761402cd,
       0xd7c134aa264366862a18302575d0fb98d116bc4b6ddebca3a5a7939f),
    _c("brainpoolP256r1",
       0xa9fb57dba1eea9bc3e660a909d838d726e3bf623d52620282013481d1f6e5377,
       0x7d5a0975fc2c3057eef67530417affe7fb8055c126dc5c6ce94a4b44f330b5d9,
       0x26dc5c6ce94a4b44f330b5d9bbd77cbf958416295cf7e1ce6bccdc18ff8c07b6,
       0x8bd2aeb9cb7e57cb2c4b482ffc81b7afb9de27e1e3bd23c23a4453bd9ace3262,
       0x547ef835c3dac4fd97f8461a14611dc9c27745132ded8e545c1d54c72f046997,
       0xa9fb57dba1eea9bc3e660a909d838d718c397aa3b561a6f7901e0e82974856a7),
    _c("brainpoolP320r1",
       0xd35e472036bc4fb7e13c785ed201e065f98fcfa6f6f40def4f92b9ec7893ec28fcd412b1f1b32e27,
       0x3ee30b568fbab0f883ccebd46d3f3bb8a2a73513f5eb79da66190eb085ffa9f492f375a97d860eb4,
       0x520883949dfdbc42d3ad198640688a6fe13f41349554b49acc31dccd884539816f5eb4ac8fb1f1a6,
       0x43bd7e9afb53d8b85289bcc48ee5bfe6f20137d10a087eb6e7871e2a10a599c710af8d0d39e20611,
       0x14fdd05545ec1cc8ab4093247f77275e0743ffed117182eaa9c77877aaac6ac7d35245d1692e8ee1,
       0xd35e472036bc4fb7e13c785ed201e065f98fcfa5b68f12a32d482ec7ee8658e98691555b44c59311),
    _c("brainpoolP384r1",
       0x8cb91e82a3386d280f5d6f7e50e641df152f7109ed5456b412b1da197fb71123acd3a729901d1a71874700133107ec53,
       0x7bc382c63d8c150c3c72080ace05afa0c2bea28e4fb22787139165efba91f90f8aa5814a503ad4eb04a8c7dd22ce2826,
       0x4a8c7dd22ce28268b39b55416f0447c2fb77de107dcd2a62e880ea53eeb62d57cb4390295dbc9943ab78696fa504c11,
       0x1d1c64f068cf45ffa2a63a81b7c13f6b8847a3e77ef14fe3db7fcafe0cbd10e8e826e03436d646aaef87b2e247d4af1e,
       0x8abe1d7520f9c2a45cb1eb8e95cfd55262b70b29feec5864e19c054ff99129280e4646217791811142820341263c5315,
       0x8cb91e82a3386d280f5d6f7e50e641df152f7109ed5456b31f166e6cac0425a7cf3ab6af6b7fc3103b883202e9046565),
    _c("brainpoolP512r1",
       0xaadd9db8dbe9c48b3fd4e6ae33c9fc07cb308db3b3c9d20ed6639cca703308717d4d9b009bc66842aecda12ae6a380e62881ff2f2d82c68528aa6056583a48f3,
       0x7830a3318b603b89e2327145ac234cc594cbdd8d3df91610a83441caea9863bc2ded5d5aa8253aa10a2ef1c98b9ac8b57f1117a72bf2c7b9e7c1ac4d77fc94ca,
       0x3df91610a83441caea9863bc2ded5d5aa8253aa10a2ef1c98b9ac8b57f1117a72bf2c7b9e7c1ac4d77fc94cadc083e67984050b75ebae5dd2809bd638016f723,
       0x81aee4bdd82ed9645a21322e9c4c6a9385ed9f70b5d916c1b43b62eef4d0098eff3b1f78e2d0d48d50d1687b93b97d5f7c6d5047406a5e688b352209bcb9f822,
       0x7dde385d566332ecc0eabfa9cf7822fdf209f70024a57b1aa000c55b881f8111b2dcde494a5f485e5bca4bd88a2763aed1ca2b2fa8f0540678cd1e0f3ad80892,
       0xaadd9db8dbe9c48b3fd4e6ae33c9fc07cb308db3b3c9d20ed6639cca70330870553e5c414ca92619418661197fac10471db1d381085ddaddb58796829ca90069),
    _c("bn254_g1",
       21888242871839275222246405745257275088696311157297823662689037894645226208583,
       0,
       3,
       1,
       2,
       21888242871839275222246405745257275088548364400416034343698204186575808495617),
]}


def validate(curve: Curve):
    """Sanity-proof the constants: G on curve, n*G = infinity, p,n odd."""
    p, a, b, n = curve.p, curve.a, curve.b, curve.n
    assert p % 2 == 1 and n % 2 == 1
    assert (curve.gy * curve.gy - (curve.gx ** 3 + a * curve.gx + b)) % p == 0, \
        f"{curve.name}: G not on curve"

    def add(P, Q):
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

    R, Q = None, (curve.gx, curve.gy)
    k = n
    while k:
        if k & 1:
            R = add(R, Q)
        Q = add(Q, Q)
        k >>= 1
    assert R is None, f"{curve.name}: n*G != infinity"


def validate_all():
    for c in CURVES.values():
        validate(c)
    return True
