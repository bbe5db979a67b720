"""SHA-256/224 compression as R1CS gadgets over bit signals.

Constraint-level twin of the reference's bit-level SHA-2 circuits
(the reference's circuits/lib/circuits/hasher/sha2/sha256/ — Schedule +
Rounds over 512-bit blocks, sha256HashChunks.circom:8) and of our batched
witness kernel ops/sha2.py. Input is pre-padded (ShaHashChunks semantics:
padding is host-side, process_passport.js:11-91).

Word representation: a 32-bit word is a list of 32 boolean Sigs, LSB
first, so rotations/shifts are free index permutations and additions are
Fr linear combinations decomposed once per round pair (two Num2Bits per
round — the dominant cost, ~300 constraints/round, ~27k per block; same
order as the reference's ~30k/block).

The port's copy of ``passport_zk_circuits_tpu/circuit/sha256.py`` (host
code over Python ints), with the same relative imports, which here name
the port's modules; ``tests/test_torch_copies.py`` holds its code equal
to the original's.
"""

from __future__ import annotations

from typing import List, Sequence

from .builder import Builder, Sig

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

_IV256 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]
_IV224 = [0xc1059ed8, 0x367cd507, 0x3070dd17, 0xf70e5939,
          0xffc00b31, 0x68581511, 0x64f98fa7, 0xbefa4fa4]

Word = List[Sig]          # 32 boolean Sigs, LSB first


def const_word(b: Builder, v: int) -> Word:
    return [b.const((v >> i) & 1) for i in range(32)]


def _rotr(w: Word, r: int) -> Word:
    # result bit i (weight 2^i) = input bit (i + r) mod 32
    return [w[(i + r) % 32] for i in range(32)]


def _shr(b: Builder, w: Word, r: int) -> Word:
    return [w[i + r] if i + r < 32 else b.const(0) for i in range(32)]


def _xor3_word(b: Builder, x: Word, y: Word, z: Word) -> Word:
    return [b.xor(b.xor(x[i], y[i]), z[i]) for i in range(32)]


def _word_lc(b: Builder, w: Word) -> Sig:
    acc = b.const(0)
    for i, bit in enumerate(w):
        acc = acc + bit.scale(1 << i)
    return acc


def _sum_to_word(b: Builder, terms: Sequence[Sig], n_extra: int) -> Word:
    """Decompose sum(terms) (each < 2^32, at most 2^n_extra terms) into
    32 + n_extra bits; return the low 32 as the mod-2^32 word."""
    acc = b.const(0)
    for t in terms:
        acc = acc + t
    bits = b.num2bits(acc, 32 + n_extra, "sha_add")
    return bits[:32]


def _small_sigma0(b, w):
    return _xor3_word(b, _rotr(w, 7), _rotr(w, 18), _shr(b, w, 3))


def _small_sigma1(b, w):
    return _xor3_word(b, _rotr(w, 17), _rotr(w, 19), _shr(b, w, 10))


def _big_sigma0(b, w):
    return _xor3_word(b, _rotr(w, 2), _rotr(w, 13), _rotr(w, 22))


def _big_sigma1(b, w):
    return _xor3_word(b, _rotr(w, 6), _rotr(w, 11), _rotr(w, 25))


def _ch(b: Builder, e: Word, f: Word, g: Word) -> Word:
    # e ? f : g per bit — 1 constraint each
    return [b.select(e[i], f[i], g[i]) for i in range(32)]


def _maj(b: Builder, x: Word, y: Word, z: Word) -> Word:
    out = []
    for i in range(32):
        t = b.mul(x[i], y[i], "maj")
        out.append(t + b.mul(z[i], x[i] + y[i] - t.scale(2), "maj"))
    return out


def compress_block(b: Builder, state: List[Word], block: List[Word]
                   ) -> List[Word]:
    """One SHA-256 compression: state (8 words) + block (16 words)."""
    w = list(block)
    for i in range(16, 64):
        s0 = _small_sigma0(b, w[i - 15])
        s1 = _small_sigma1(b, w[i - 2])
        w.append(_sum_to_word(
            b, [_word_lc(b, w[i - 16]), _word_lc(b, s0),
                _word_lc(b, w[i - 7]), _word_lc(b, s1)], 2))

    a, bb, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _word_lc(b, _big_sigma1(b, e))
        ch = _word_lc(b, _ch(b, e, f, g))
        s0 = _word_lc(b, _big_sigma0(b, a))
        mj = _word_lc(b, _maj(b, a, bb, c))
        t1_terms = [_word_lc(b, h), s1, ch, b.const(_K[i]), _word_lc(b, w[i])]
        new_e = _sum_to_word(b, [_word_lc(b, d)] + t1_terms, 3)
        new_a = _sum_to_word(b, t1_terms + [s0, mj], 3)
        a, bb, c, d, e, f, g, h = new_a, a, bb, c, new_e, e, f, g

    upd = [a, bb, c, d, e, f, g, h]
    return [_sum_to_word(b, [_word_lc(b, state[i]), _word_lc(b, upd[i])], 1)
            for i in range(8)]


def sha_hash_chunks(b: Builder, msg_bits: Sequence[Sig], algo: int = 256
                    ) -> List[Sig]:
    """SHA-256/224 of pre-padded message bits (reading order, MSB-first
    per word — the blob bit convention of ops/bitops.py). Returns the
    digest as a bit list in reading order (hash.circom:32 ShaHashChunks
    contract). len(msg_bits) must be a multiple of 512."""
    assert algo in (224, 256) and len(msg_bits) % 512 == 0
    iv = _IV256 if algo == 256 else _IV224
    state = [const_word(b, v) for v in iv]
    for blk in range(len(msg_bits) // 512):
        words = []
        for wi in range(16):
            base = blk * 512 + wi * 32
            # word bits arrive MSB-first; our Word is LSB-first
            words.append([msg_bits[base + 31 - i] for i in range(32)])
        state = compress_block(b, state, words)
    out_words = state[:8] if algo == 256 else state[:7]
    bits = []
    for w in out_words:
        bits.extend(w[::-1])              # back to MSB-first reading order
    return bits
