"""Batched SHA-1 / SHA-2 family over pre-padded message blocks, in PyTorch.

Counterpart of ``passport_zk_circuits_tpu/ops/sha2.py``. Every word is held
in int64 and kept in [0, 2^32): each add and rotate is masked (torch has no
uint64, and ``>>`` on a negative int64 is arithmetic). Padding stays on the
host (``pad_message``), except for ``sha_hash_byte_rows``, which pads a
static-length stream of per-byte rows computed on the device.

Layouts:
  * 32-bit algorithms (SHA-1/224/256): message (16*nb, *B) big-endian words;
    digest (n_words, *B). SHA-224/256 go to K1 (``ops/cuda_sha2``), SHA-1 is
    plain PyTorch.
  * 64-bit algorithms (SHA-384/512): 64-bit words as (hi, lo) 32-bit pairs,
    message (16*nb, 2, *B) as ``bitops.words32_to_words64`` gives it, digest
    (n_words, 2, *B). Plain PyTorch.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

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
# SHA-1, plain PyTorch
# ---------------------------------------------------------------------------

H1 = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0],
              dtype=np.uint32)
K_SHA1 = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & M32


def _sha1_block(state, block):
    """state: list of 5 (*B,) words; block: (16, *B) -> new state list."""
    w = list(block.unbind(0))
    for i in range(16, 80):
        w.append(_rotl(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1))
    a, b, c, d, e = state
    for i in range(80):
        st = i // 20
        if st == 0:
            f = (b & c) | (~b & d)
        elif st == 2:
            f = (b & c) | (b & d) | (c & d)
        else:
            f = b ^ c ^ d
        t = (_rotl(a, 5) + f + e + K_SHA1[st] + w[i]) & M32
        a, b, c, d, e = t, a, _rotl(b, 30), c, d
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e))]


def sha1_chunks(msg):
    """Batched SHA-1 of pre-padded words. msg: (16*nb, *B) -> (5, *B)."""
    state = [torch.full(msg.shape[1:], int(v), dtype=torch.int64,
                        device=msg.device) for v in H1]
    for blk in range(msg.shape[0] // 16):
        state = _sha1_block(state, msg[16 * blk:16 * blk + 16])
    return torch.stack(state)


# ---------------------------------------------------------------------------
# SHA-384/512, plain PyTorch. A 64-bit word is a (2, *B) tensor (hi, lo).
# ---------------------------------------------------------------------------

def _k512_exact():
    """floor(cbrt(q) * 2^64) mod 2^64 for the first 80 primes q, by an
    integer cube root of q * 2^192 (FIPS 180-4): Newton's iteration on
    integers, from above, ends at the floor."""
    ks, primes, p = [], [], 2
    while len(primes) < 80:
        if all(p % q for q in primes):
            primes.append(p)
        p += 1
    for q in primes:
        n = q << 192
        x = 1 << -(-n.bit_length() // 3)
        while (y := (2 * x + n // (x * x)) // 3) < x:
            x = y
        ks.append(x & 0xFFFFFFFFFFFFFFFF)
    return ks


K512 = np.array([[k >> 32, k & M32] for k in _k512_exact()], dtype=np.uint32)

H512 = np.array([[0x6a09e667, 0xf3bcc908], [0xbb67ae85, 0x84caa73b],
                 [0x3c6ef372, 0xfe94f82b], [0xa54ff53a, 0x5f1d36f1],
                 [0x510e527f, 0xade682d1], [0x9b05688c, 0x2b3e6c1f],
                 [0x1f83d9ab, 0xfb41bd6b], [0x5be0cd19, 0x137e2179]],
                dtype=np.uint32)
H384 = np.array([[0xcbbb9d5d, 0xc1059ed8], [0x629a292a, 0x367cd507],
                 [0x9159015a, 0x3070dd17], [0x152fecd8, 0xf70e5939],
                 [0x67332667, 0xffc00b31], [0x8eb44a87, 0x68581511],
                 [0xdb0c2e0d, 0x64f98fa7], [0x47b5481d, 0xbefa4fa4]],
                dtype=np.uint32)


def _add64(*xs):
    """Sum mod 2^64 of (2, *B) words (at most a few terms: the low halves'
    sum stays far below 2^63)."""
    s = xs[0]
    for x in xs[1:]:
        s = s + x
    lo = s[1]
    return torch.stack([(s[0] + (lo >> 32)) & M32, lo & M32])


def _rotr64(x, n):
    if n >= 32:
        x, n = x.flip(0), n - 32
    if n == 0:
        return x
    return ((x >> n) | (x.flip(0) << (32 - n))) & M32


def _shr64(x, n):
    """x >> n for 0 < n < 32."""
    y = x >> n
    return torch.stack([y[0], y[1] | ((x[0] << (32 - n)) & M32)])


def _sha512_block(state, block, k512):
    """state: list of 8 (2, *B) words; block: (16, 2, *B); k512: (80, 2, 1..)
    round constants on the device -> new state list."""
    w = list(block.unbind(0))
    for i in range(16, 80):
        s0 = _rotr64(w[i - 15], 1) ^ _rotr64(w[i - 15], 8) ^ \
            _shr64(w[i - 15], 7)
        s1 = _rotr64(w[i - 2], 19) ^ _rotr64(w[i - 2], 61) ^ \
            _shr64(w[i - 2], 6)
        w.append(_add64(w[i - 16], s0, w[i - 7], s1))
    a, b, c, d, e, f, g, h = state
    for i in range(80):
        S1 = _rotr64(e, 14) ^ _rotr64(e, 18) ^ _rotr64(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = _add64(h, S1, ch, k512[i], w[i])
        S0 = _rotr64(a, 28) ^ _rotr64(a, 34) ^ _rotr64(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (_add64(t1, S0, maj), a, b, c,
                                  _add64(d, t1), e, f, g)
    return [_add64(x, y) for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _sha2_64(msg, iv, out_words):
    """msg: (16*nb, 2, *B) hi/lo words -> (out_words, 2, *B)."""
    bshape = msg.shape[2:]
    ones = (1,) * len(bshape)
    k512 = torch.as_tensor(K512.astype(np.int64), device=msg.device)
    k512 = k512.reshape((80, 2) + ones)
    ivt = torch.as_tensor(iv.astype(np.int64), device=msg.device)
    state = list(ivt.reshape((8, 2) + ones).expand(
        (8, 2) + tuple(bshape)).unbind(0))
    for blk in range(msg.shape[0] // 16):
        state = _sha512_block(state, msg[16 * blk:16 * blk + 16], k512)
    return torch.stack(state[:out_words])


def sha512_chunks(msg):
    """Batched SHA-512. msg: (16*nb, 2, *B) -> (8, 2, *B)."""
    return _sha2_64(msg, H512, 8)


def sha384_chunks(msg):
    """Batched SHA-384: SHA-512 core, H384 IV, 6-word digest."""
    return _sha2_64(msg, H384, 6)


# ---------------------------------------------------------------------------
# Dispatch facade — ShaHashChunks(BLOCK_NUM, ALGO) analog
# ---------------------------------------------------------------------------

ALGO_BITS = {160: 512, 224: 512, 256: 512, 384: 1024, 512: 1024}
DIGEST_WORDS = {160: 5, 224: 7, 256: 8, 384: 6, 512: 8}


def sha_hash_chunks(msg, algo: int):
    """algo in {160 (SHA-1), 224, 256, 384, 512}; msg pre-padded words,
    (16*nb, *B) for 160/224/256 and (16*nb, 2, *B) for 384/512."""
    if algo == 160:
        return sha1_chunks(msg)
    if algo in (224, 256):
        return _sha2_32(msg, algo)
    if algo == 384:
        return sha384_chunks(msg)
    if algo == 512:
        return sha512_chunks(msg)
    raise ValueError(f"unsupported SHA algo {algo}")


def sha_hash_chunks_many(msgs, algos):
    """Several independent SHA-224/256 hashes of one batch in one K1
    launch: msgs a list of up to four pre-padded word tensors (16*nb_i, *B)
    with the same batch shape, algos 224 or 256 for each. Returns the list
    of digests, (8 or 7, *B) each. Any other algo raises ``ValueError``
    before anything launches."""
    from . import cuda_sha2
    bshape = msgs[0].shape[1:]
    outs = cuda_sha2.sha2_32_chunks_many(
        [m.reshape(m.shape[0], -1) for m in msgs], algos)
    return [o.reshape((o.shape[0],) + bshape) for o in outs]


def sha_hash_bytes_host(data: bytes, algo: int) -> bytes:
    """Host oracle via hashlib (tests and ingestion)."""
    name = {160: "sha1", 224: "sha224", 256: "sha256",
            384: "sha384", 512: "sha512"}[algo]
    return hashlib.new(name, data).digest()


# ---------------------------------------------------------------------------
# In-graph hashing of composed byte streams — ShaHashBits analog: the
# message is computed on the device (MGF1 counters, EM bytes, ...), so the
# padding is applied here, to a static-length stream.
# ---------------------------------------------------------------------------

def pad_byte_rows(byte_rows, block_bits: int):
    """MD-pad a static-length list of per-byte rows ((*B,) tensors or int
    constants)."""
    L = len(byte_rows) * 8
    lenfield = 8 if block_bits == 512 else 16
    rows = list(byte_rows) + [0x80]
    rows += [0] * (-(len(rows) + lenfield) % (block_bits // 8))
    return rows + list(L.to_bytes(lenfield, "big"))


def byte_rows_to_words(byte_rows, bshape):
    """4-byte big-endian packing of per-byte rows -> (n_words, *B) words on
    the rows' device. The constant rows are one host array, the tensor rows
    one stack."""
    device = next((b.device for b in byte_rows
                   if isinstance(b, torch.Tensor)), torch.device("cpu"))
    n = len(byte_rows)
    const = np.array([b if isinstance(b, int) else 0 for b in byte_rows],
                     dtype=np.int64)
    rows = torch.as_tensor(const, device=device).reshape(
        (n,) + (1,) * len(bshape)).expand((n,) + tuple(bshape)).clone()
    live = [i for i, b in enumerate(byte_rows) if not isinstance(b, int)]
    if live:
        rows[torch.as_tensor(live, device=device)] = torch.stack(
            [byte_rows[i].expand(bshape) for i in live])
    rows = rows.reshape((n // 4, 4) + tuple(bshape))
    return ((rows[:, 0] << 24) | (rows[:, 1] << 16) | (rows[:, 2] << 8)
            | rows[:, 3])


def sha_hash_byte_rows(byte_rows, algo: int, bshape):
    """Digest of a static-length byte-row stream, returned as byte rows:
    a (digest bytes, *B) tensor, whose rows index like the JAX package's
    list. SHA-224/256 go to K1's per-message entry."""
    words = byte_rows_to_words(pad_byte_rows(byte_rows, ALGO_BITS[algo]),
                               bshape)
    if algo in (384, 512):
        words = words.reshape((words.shape[0] // 2, 2) + tuple(bshape))
    dw = sha_hash_chunks(words, algo)
    if algo in (384, 512):
        dw = dw.reshape((dw.shape[0] * 2,) + tuple(bshape))
    j = torch.arange(dw.shape[0] * 4, device=dw.device)
    sh = (8 * (3 - j % 4)).reshape((j.shape[0],) + (1,) * len(bshape))
    return (dw[j // 4] >> sh) & 0xFF
