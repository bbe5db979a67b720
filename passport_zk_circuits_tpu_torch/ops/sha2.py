"""Batched SHA-224/256 over pre-padded message blocks, in PyTorch.

Counterpart of ``passport_zk_circuits_tpu/ops/sha2.py``. Messages are
(16*nb, *B) tensors of big-endian 32-bit words held in int64; digests are
(n_words, *B). Padding stays on the host (``pad_message``).

SHA-1, SHA-384 and SHA-512 are not ported yet (ROADMAP, queue 1, "Remaining
hashes") and raise ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib

import numpy as np

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host-side: padding + byte <-> word-array conversion
# ---------------------------------------------------------------------------

def pad_message(data: bytes, block_bits: int) -> bytes:
    """MD-style padding (SHA-1/2): 0x80, zeros, 64/128-bit big-endian
    length. block_bits: 512 (SHA-1/224/256) or 1024 (SHA-384/512)."""
    L = len(data) * 8
    lenfield = 8 if block_bits == 512 else 16
    data = data + b"\x80"
    data += b"\x00" * (-(len(data) + lenfield) % (block_bits // 8))
    return data + L.to_bytes(lenfield, "big")


def bytes_to_words32(data: bytes) -> np.ndarray:
    """Padded bytes -> (n_words,) uint32 big-endian words."""
    if len(data) % 4:
        raise ValueError("byte length must be a multiple of 4")
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


# ---------------------------------------------------------------------------
# SHA-224/256 compression, plain PyTorch
# ---------------------------------------------------------------------------

# FIPS 180-4 constants (fractional parts of cube roots of primes 2..311)
K256 = np.array([int(k, 16) for k in """
428a2f98 71374491 b5c0fbcf e9b5dba5 3956c25b 59f111f1 923f82a4 ab1c5ed5
d807aa98 12835b01 243185be 550c7dc3 72be5d74 80deb1fe 9bdc06a7 c19bf174
e49b69c1 efbe4786 0fc19dc6 240ca1cc 2de92c6f 4a7484aa 5cb0a9dc 76f988da
983e5152 a831c66d b00327c8 bf597fc7 c6e00bf3 d5a79147 06ca6351 14292967
27b70a85 2e1b2138 4d2c6dfc 53380d13 650a7354 766a0abb 81c2c92e 92722c85
a2bfe8a1 a81a664b c24b8b70 c76c51a3 d192e819 d6990624 f40e3585 106aa070
19a4c116 1e376c08 2748774c 34b0bcb5 391c0cb3 4ed8aa4a 5b9cca4f 682e6ff3
748f82ee 78a5636f 84c87814 8cc70208 90befffa a4506ceb bef9a3f7 c67178f2
""".split()], dtype=np.uint32)

H256 = np.array([0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19],
                dtype=np.uint32)
H224 = np.array([0xc1059ed8, 0x367cd507, 0x3070dd17, 0xf70e5939,
                 0xffc00b31, 0x68581511, 0x64f98fa7, 0xbefa4fa4],
                dtype=np.uint32)


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _sha256_block(state, block):
    """state: list of 8 (*B,) words; block: (16, *B) -> new state list."""
    w = list(block.unbind(0))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + int(K256[i]) + w[i]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = ((t1 + S0 + maj) & M32, a, b, c,
                                  (d + t1) & M32, e, f, g)
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _sha2_32(msg, algo: int):
    """Shared SHA-224/256 entry. msg: (16*nb, *B) int64 words.
    Dispatch: the kernel wrapper takes a CUDA tensor to the hand-written
    kernel and a CPU tensor to the plain version."""
    from . import cuda_sha2
    bshape = msg.shape[1:]
    out = cuda_sha2.sha2_32_chunks(msg.reshape(msg.shape[0], -1), algo)
    return out.reshape((out.shape[0],) + bshape)


def sha256_chunks(msg):
    """Batched SHA-256 of pre-padded words. msg: (16*nb, *B) -> (8, *B)."""
    return _sha2_32(msg, 256)


def sha224_chunks(msg):
    """Batched SHA-224: msg (16*nb, *B) -> (7, *B)."""
    return _sha2_32(msg, 224)


# ---------------------------------------------------------------------------
# Dispatch facade — ShaHashChunks(BLOCK_NUM, ALGO) analog
# ---------------------------------------------------------------------------

def _require_ported(algo: int) -> None:
    """SHA-1/384/512 are still to port (ROADMAP queue 1, "Remaining
    hashes")."""
    if algo in (160, 384, 512):
        raise NotImplementedError(
            f"SHA-{algo if algo != 160 else 1} is not ported yet "
            "(ROADMAP queue 1: Remaining hashes)")
    if algo not in (224, 256):
        raise ValueError(f"unsupported SHA algo {algo}")


def sha_hash_chunks(msg, algo: int):
    """algo in {224, 256}; msg pre-padded words."""
    _require_ported(algo)
    return _sha2_32(msg, algo)


def sha_hash_chunks_many(msgs, algos):
    """Several independent hashes of one batch in one kernel launch: msgs a
    list of up to four pre-padded word tensors (16*nb_i, *B) with the same
    batch shape, algos 224 or 256 for each. Returns the list of digests,
    (8 or 7, *B) each. SHA-1/384/512 raise before anything launches."""
    from . import cuda_sha2
    for algo in algos:
        _require_ported(algo)
    bshape = msgs[0].shape[1:]
    outs = cuda_sha2.sha2_32_chunks_many(
        [m.reshape(m.shape[0], -1) for m in msgs], algos)
    return [o.reshape((o.shape[0],) + bshape) for o in outs]


def sha_hash_bytes_host(data: bytes, algo: int) -> bytes:
    """Host oracle via hashlib (tests and ingestion)."""
    name = {160: "sha1", 224: "sha224", 256: "sha256",
            384: "sha384", 512: "sha512"}[algo]
    return hashlib.new(name, data).digest()
