"""Byte/bit extraction over (n_words, *B) big-endian 32-bit word tensors.

Counterpart of ``passport_zk_circuits_tpu/ops/bitops.py``. Bit i of a blob
is the i-th bit in reading order: bit (31 - i % 32) of word i // 32.
"""

from __future__ import annotations

import torch

from . import field as fr


def _col(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return idx.reshape((idx.shape[0],) + (1,) * (like.dim() - 1))


def get_byte(words, byte_idx: int):
    """Byte at reading-order index -> (*B,) int64."""
    w, b = divmod(byte_idx, 4)
    return (words[w] >> (8 * (3 - b))) & 0xFF


def get_bytes(words, byte_off: int, n: int):
    """(n, *B) bytes starting at byte_off."""
    idx = torch.arange(byte_off, byte_off + n, device=words.device)
    return (words[idx // 4] >> _col(8 * (3 - idx % 4), words)) & 0xFF


def get_bit(words, bit_idx: int):
    """Bit at reading-order index -> (*B,) in {0, 1}."""
    w, b = divmod(bit_idx, 32)
    return (words[w] >> (31 - b)) & 1


def get_bits(words, bit_off: int, n: int):
    """(n, *B) bits starting at bit_off (reading order)."""
    idx = torch.arange(bit_off, bit_off + n, device=words.device)
    return (words[idx // 32] >> _col(31 - idx % 32, words)) & 1


def bits_to_limbs(bits, k: int, msb_first: bool = True):
    """Recompose a bit tensor (n, *B) into (k, *B) 16-bit limbs.

    msb_first=True: value = sum bits[i] * 2^(n-1-i); msb_first=False:
    value = sum bits[i] * 2^i. Bits past 16k are dropped."""
    lsb = bits.flip(0) if msb_first else bits
    full = bits.new_zeros((16 * k,) + bits.shape[1:])
    n = min(bits.shape[0], 16 * k)
    full[:n] = lsb[:n]
    full = full.reshape((k, 16) + bits.shape[1:])
    sh = torch.arange(16, device=bits.device).reshape(
        (1, 16) + (1,) * (bits.dim() - 1))
    return (full << sh).sum(1)


def bits_to_fr(bits, msb_first: bool = True):
    """Recompose a bit tensor (n, *B) into Fr limbs (16, *B)."""
    return bits_to_limbs(bits, fr.NLIMBS, msb_first)


def word_slice_to_fr(words, bit_off: int, n: int, msb_first: bool = True):
    """Field extraction: n bits at bit_off recomposed into Fr limbs."""
    return bits_to_fr(get_bits(words, bit_off, n), msb_first)


def digest32_bytes(digest_words):
    """(w, *B) digest words -> (4w, *B) bytes (big-endian)."""
    return get_bytes(digest_words, 0, digest_words.shape[0] * 4)


def digest64_bytes(digest_words):
    """(w, 2, *B) hi/lo word-pair digest -> (8w, *B) bytes."""
    w = digest_words.shape[0]
    flat = digest_words.reshape((2 * w,) + digest_words.shape[2:])
    return get_bytes(flat, 0, 8 * w)


def words32_to_words64(words):
    """(2n, *B) words -> (n, 2, *B) hi/lo pairs (SHA-384/512 input)."""
    n2 = words.shape[0]
    return words.reshape((n2 // 2, 2) + words.shape[1:])


def u64_limbs_from_fr16(l16, j: int):
    """64-bit little-endian chunk j of a 16-bit limb tensor, as Fr limbs."""
    out = l16.new_zeros((fr.NLIMBS,) + l16.shape[1:])
    out[:4] = l16[4 * j:4 * j + 4]
    return out
