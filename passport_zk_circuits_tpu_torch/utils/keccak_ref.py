"""Pure-Python Keccak-256 / SHA3-256 and the Ethereum address: the oracle
of ``ops/keccak.py``.

A plain transcription of FIPS 202 over Python ints, written apart from
the batched module (its own round constants and offsets, lanes as 64-bit
ints, the state a list of 25 lanes at x + 5y): ``hashlib.sha3_256`` checks
its SHA-3 padding, and the legacy-Keccak vectors its 0x01 padding.
"""

from __future__ import annotations

_M64 = (1 << 64) - 1
RATE = 136

_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15,
        21, 8, 18, 2, 61, 56, 14]           # offsets at x + 5y (FIPS 202)
_RC = [0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
       0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
       0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
       0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
       0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
       0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
       0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
       0x8000000000008080, 0x0000000080000001, 0x8000000080008008]


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _M64 if n else v


def keccak_f(a):
    """Keccak-f[1600] on 25 lanes at index x + 5y."""
    a = list(a)
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y],
                                                         _ROT[x + 5 * y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)] & _M64
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] ^= rc
    return a


def keccak256(data: bytes, sha3: bool = False) -> bytes:
    """Keccak-256 (domain byte 0x01) or SHA3-256 (0x06) of data."""
    msg = bytearray(data)
    pad = RATE - len(msg) % RATE
    msg += bytes(pad)
    msg[len(data)] ^= 0x06 if sha3 else 0x01
    msg[-1] ^= 0x80
    a = [0] * 25
    for off in range(0, len(msg), RATE):
        for i in range(RATE // 8):
            a[i] ^= int.from_bytes(msg[off + 8 * i:off + 8 * i + 8], "little")
        a = keccak_f(a)
    return b"".join(a[i].to_bytes(8, "little") for i in range(4))


def eth_address(pubkey64: bytes) -> bytes:
    """The 20-byte Ethereum address of a 64-byte (x || y) public key."""
    return keccak256(pubkey64)[12:]
