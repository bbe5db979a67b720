"""SHA-1 compression as R1CS gadgets over bit signals.

Constraint twin of the reference's SHA-1 circuit
(the reference's circuits/lib/circuits/hasher/sha1/ — Schedule + 80
rounds over 512-bit blocks) and of the witness kernel ops/sha2.sha1
path. Same word representation as circuit/sha256: 32 boolean Sigs LSB
first, rotations free, additions decomposed once per round.

The port's copy of
``passport_zk_circuits_tpu/circuit/sha1.py`` (host code over
Python ints), with the same relative imports, which here name the port's
modules; ``tests/test_torch_copies.py`` holds its code equal to the
original's.
"""

from __future__ import annotations

from typing import List, Sequence

from .builder import Builder, Sig

_IV = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
_KR = [0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6]

Word = List[Sig]


def const_word(b: Builder, v: int) -> Word:
    return [b.const((v >> i) & 1) for i in range(32)]


def _rotl(w: Word, r: int) -> Word:
    # result bit i = input bit (i - r) mod 32
    return [w[(i - r) % 32] for i in range(32)]


def _word_lc(b: Builder, w: Word) -> Sig:
    acc = b.const(0)
    for i, bit in enumerate(w):
        acc = acc + bit.scale(1 << i)
    return acc


def _sum_to_word(b: Builder, terms: Sequence[Sig], n_extra: int) -> Word:
    acc = b.const(0)
    for t in terms:
        acc = acc + t
    bits = b.num2bits(acc, 32 + n_extra, "sha1_add")
    return bits[:32]


def _xor2(b, x: Word, y: Word) -> Word:
    return [b.xor(x[i], y[i]) for i in range(32)]


def _ch(b, x: Word, y: Word, z: Word) -> Word:
    return [b.select(x[i], y[i], z[i]) for i in range(32)]


def _maj(b, x: Word, y: Word, z: Word) -> Word:
    out = []
    for i in range(32):
        t = b.mul(x[i], y[i], "maj")
        out.append(t + b.mul(z[i], x[i] + y[i] - t.scale(2), "maj"))
    return out


def compress_block(b: Builder, state: List[Word], block: List[Word]
                   ) -> List[Word]:
    w = list(block)
    for i in range(16, 80):
        x = _xor2(b, _xor2(b, w[i - 3], w[i - 8]),
                  _xor2(b, w[i - 14], w[i - 16]))
        w.append(_rotl(x, 1))

    a, bb, c, d, e = state
    for i in range(80):
        if i < 20:
            f = _ch(b, bb, c, d)
        elif i < 40 or i >= 60:
            f = _xor2(b, _xor2(b, bb, c), d)
        else:
            f = _maj(b, bb, c, d)
        t = _sum_to_word(b, [_word_lc(b, _rotl(a, 5)), _word_lc(b, f),
                             _word_lc(b, e), b.const(_KR[i // 20]),
                             _word_lc(b, w[i])], 3)
        a, bb, c, d, e = t, a, _rotl(bb, 30), c, d

    upd = [a, bb, c, d, e]
    return [_sum_to_word(b, [_word_lc(b, state[i]), _word_lc(b, upd[i])], 1)
            for i in range(5)]


def sha_hash_chunks(b: Builder, msg_bits: Sequence[Sig]) -> List[Sig]:
    """SHA-1 of pre-padded message bits (reading order). Returns 160
    digest bits in reading order. len(msg_bits) % 512 == 0."""
    assert len(msg_bits) % 512 == 0
    state = [const_word(b, v) for v in _IV]
    for blk in range(len(msg_bits) // 512):
        words = []
        for wi in range(16):
            base = blk * 512 + wi * 32
            words.append([msg_bits[base + 31 - i] for i in range(32)])
        state = compress_block(b, state, words)
    bits = []
    for w in state:
        bits.extend(w[::-1])
    return bits
