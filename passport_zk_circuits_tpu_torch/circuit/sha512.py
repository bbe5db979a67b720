"""SHA-512/384 compression as R1CS gadgets over bit signals.

Constraint-level twin of the reference's 64-bit-word SHA-2 circuits
(the reference's circuits/lib/circuits/hasher/sha2/sha512/
sha512Rounds.circom + sha384/, Schedule + 80 rounds over 1024-bit blocks,
sha512HashChunks semantics) and of our batched witness kernel
ops/sha2.sha512_chunks (hi/lo u32 pairs). Structure mirrors
circuit/sha256.py: a 64-bit word is 64 boolean Sigs LSB-first, rotations
are free index permutations, additions decompose via Num2Bits once per
round pair (~600 constraints/round, ~52k per 1024-bit block — same order
as the reference's per-block cost).

Round constants come from ops/sha2._k512_exact() (generated, not
transcribed — frac(cbrt(prime)) per FIPS 180-4).

The port's copy of
``passport_zk_circuits_tpu/circuit/sha512.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's, but for the names of the
SHA-512 and SHA-384 IVs, which the port's ``ops/sha2`` calls ``H512``
and ``H384``.
"""

from __future__ import annotations

from typing import List, Sequence

from ..ops import sha2 as _sha2
from .builder import Builder, Sig

_K = _sha2._k512_exact()                               # 80 x 64-bit ints
_IV512 = [(int(hi) << 32) | int(lo) for hi, lo in _sha2.H512]
_IV384 = [(int(hi) << 32) | int(lo) for hi, lo in _sha2.H384]

Word = List[Sig]          # 64 boolean Sigs, LSB first


def const_word(b: Builder, v: int) -> Word:
    return [b.const((v >> i) & 1) for i in range(64)]


def _rotr(w: Word, r: int) -> Word:
    return [w[(i + r) % 64] for i in range(64)]


def _shr(b: Builder, w: Word, r: int) -> Word:
    return [w[i + r] if i + r < 64 else b.const(0) for i in range(64)]


def _xor3_word(b: Builder, x: Word, y: Word, z: Word) -> Word:
    return [b.xor(b.xor(x[i], y[i]), z[i]) for i in range(64)]


def _word_lc(b: Builder, w: Word) -> Sig:
    acc = b.const(0)
    for i, bit in enumerate(w):
        acc = acc + bit.scale(1 << i)
    return acc


def _sum_to_word(b: Builder, terms: Sequence[Sig], n_extra: int) -> Word:
    acc = b.const(0)
    for t in terms:
        acc = acc + t
    bits = b.num2bits(acc, 64 + n_extra, "sha512_add")
    return bits[:64]


def _small_sigma0(b, w):
    return _xor3_word(b, _rotr(w, 1), _rotr(w, 8), _shr(b, w, 7))


def _small_sigma1(b, w):
    return _xor3_word(b, _rotr(w, 19), _rotr(w, 61), _shr(b, w, 6))


def _big_sigma0(b, w):
    return _xor3_word(b, _rotr(w, 28), _rotr(w, 34), _rotr(w, 39))


def _big_sigma1(b, w):
    return _xor3_word(b, _rotr(w, 14), _rotr(w, 18), _rotr(w, 41))


def _ch(b: Builder, e: Word, f: Word, g: Word) -> Word:
    return [b.select(e[i], f[i], g[i]) for i in range(64)]


def _maj(b: Builder, x: Word, y: Word, z: Word) -> Word:
    out = []
    for i in range(64):
        t = b.mul(x[i], y[i], "maj")
        out.append(t + b.mul(z[i], x[i] + y[i] - t.scale(2), "maj"))
    return out


def compress_block(b: Builder, state: List[Word], block: List[Word]
                   ) -> List[Word]:
    """One SHA-512 compression: state (8 words) + block (16 words)."""
    w = list(block)
    for i in range(16, 80):
        s0 = _small_sigma0(b, w[i - 15])
        s1 = _small_sigma1(b, w[i - 2])
        w.append(_sum_to_word(
            b, [_word_lc(b, w[i - 16]), _word_lc(b, s0),
                _word_lc(b, w[i - 7]), _word_lc(b, s1)], 2))

    a, bb, c, d, e, f, g, h = state
    for i in range(80):
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


def sha_hash_chunks(b: Builder, msg_bits: Sequence[Sig], algo: int = 512
                    ) -> List[Sig]:
    """SHA-512/384 of pre-padded message bits (reading order, MSB-first per
    64-bit word). Returns the digest as a bit list in reading order.
    len(msg_bits) must be a multiple of 1024."""
    assert algo in (384, 512) and len(msg_bits) % 1024 == 0
    iv = _IV512 if algo == 512 else _IV384
    state = [const_word(b, v) for v in iv]
    for blk in range(len(msg_bits) // 1024):
        words = []
        for wi in range(16):
            base = blk * 1024 + wi * 64
            words.append([msg_bits[base + 63 - i] for i in range(64)])
        state = compress_block(b, state, words)
    out_words = state[:8] if algo == 512 else state[:6]
    bits = []
    for w in out_words:
        bits.extend(w[::-1])              # back to MSB-first reading order
    return bits
