"""Batched Keccak-f[1600], Keccak-256 / SHA3-256 and the Ethereum address.

Counterpart of ``passport_zk_circuits_tpu/ops/keccak.py``, plain PyTorch
(the JAX module is XLA code: no Pallas kernel reaches it), with its
contract: keccak.circom's Pad / Absorb / Keccakf / Squeeze and eth.circom's
GetEthAddrFromPubKey (keccak256 of the 64-byte public key, its low 20
bytes).

A 64-bit lane is a (hi, lo) pair of 32-bit halves in int64 tensors, as
the port's SHA-384/512 keeps its words: the state is (5, 5, 2, *B),
indexed [x][y]. torch's ``>>`` on int64 is arithmetic, so every half stays
below 2^32 and each ``<<`` is masked. A round works on the whole state at
once: theta by rolls over x, rho as one rotation of the 25 lanes by their
offsets (an offset of 32 or more swaps the halves first; a half shifted
right by 32 is 0, so an offset of 0 or 32 needs no case of its own), pi
as one index_select, chi by rolls over x, iota by one XOR. The round
constants and rotation offsets are generated (FIPS 202, Algorithm 5 and
the (t+1)(t+2)/2 walk) as in the JAX module.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _round_constants():
    """24 iota constants via the standard LFSR (FIPS 202 Algorithm 5)."""
    rcs = []
    R = 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            if R & 1:
                rc |= 1 << ((1 << j) - 1)
            R = ((R << 1) ^ (0x71 if R & 0x80 else 0)) & 0xFF
        rcs.append(rc)
    return rcs


def _rho_offsets():
    """Rotation offsets via the (t+1)(t+2)/2 walk (FIPS 202 §3.2.2)."""
    offs = np.zeros((5, 5), dtype=np.int64)
    x, y = 1, 0
    for t in range(24):
        offs[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return offs


_RC = _round_constants()
_RHO = _rho_offsets()


def _pi_sources():
    """For each flat destination lane 5x + y, the flat source lane of pi
    (B[y][(2x + 3y) % 5] = A[x][y])."""
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[5 * y + (2 * x + 3 * y) % 5] = 5 * x + y
    return src


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """Per device, made once (never write to them): the pi source of each
    flat lane, the rho offset mod 32 and the half swap (offset >= 32) of
    that source, and the iota masks (24, 5, 5, 2) (a round's constant in
    lane [0][0], zeros elsewhere)."""
    src = _pi_sources()
    offs = _RHO.reshape(25)[src]
    iota = np.zeros((24, 5, 5, 2), dtype=np.int64)
    for r, rc in enumerate(_RC):
        iota[r, 0, 0] = (rc >> 32, rc & _M32)
    return (torch.tensor(src, device=device),
            torch.tensor(offs % 32, device=device),
            torch.tensor(offs >= 32, device=device),
            torch.tensor(iota, device=device))


def _bc(t, nd):
    """A (25,) per-lane constant shaped to broadcast against (25, *B)."""
    return t.reshape((25,) + (1,) * nd)


def keccak_f(state):
    """state: (5, 5, 2, *B) int64 halves below 2^32, [x][y] lane order ->
    the permuted state."""
    src, s, swap, iota = _consts(state.device)
    bshape = tuple(state.shape[3:])
    nd = len(bshape)
    s, swap = _bc(s, nd), _bc(swap, nd)
    st = state
    for r in range(24):
        # theta: C[x] = XOR over y; D[x] = C[x-1] ^ rotl1(C[x+1])
        C = st[:, 0] ^ st[:, 1] ^ st[:, 2] ^ st[:, 3] ^ st[:, 4]
        Cn = C.roll(-1, 0)
        hi, lo = Cn[:, 0], Cn[:, 1]
        rot = torch.stack([((hi << 1) & _M32) | (lo >> 31),
                           ((lo << 1) & _M32) | (hi >> 31)], 1)
        D = C.roll(1, 0) ^ rot
        st = st ^ D.unsqueeze(1)
        # rho + pi: lane by lane rotation, then the lane permutation
        flat = st.reshape((25, 2) + bshape).index_select(0, src)
        hi, lo = flat[:, 0], flat[:, 1]
        hi, lo = torch.where(swap, lo, hi), torch.where(swap, hi, lo)
        Bf = torch.stack([((hi << s) & _M32) | (lo >> (32 - s)),
                          ((lo << s) & _M32) | (hi >> (32 - s))], 1)
        B = Bf.reshape((5, 5, 2) + bshape)
        # chi (over x), iota
        st = B ^ (~B.roll(-1, 0) & B.roll(-2, 0))
        st = st ^ iota[r].reshape((5, 5, 2) + (1,) * nd)
    return st


# ---------------------------------------------------------------------------
# Keccak-256 / SHA3-256 over byte tensors
# ---------------------------------------------------------------------------

RATE_BYTES = 136   # 1088-bit rate for 256-bit output


def pad_keccak(data_len: int, sha3: bool = False):
    """Host: the padded length and the first padding byte for a static
    message length (keccak.circom's Pad). Domain byte: 0x01 legacy
    Keccak, 0x06 SHA-3."""
    n_blocks = data_len // RATE_BYTES + 1
    padded_len = n_blocks * RATE_BYTES
    first = 0x06 if sha3 else 0x01
    return padded_len, first


def keccak256_bytes(byte_rows, sha3: bool = False):
    """Batched Keccak-256 (or SHA3-256). byte_rows: one (n, *B) int64
    tensor of message bytes (n = 0 for the empty message). Returns the 32
    digest bytes as a list of (*B,) tensors."""
    bshape, device = tuple(byte_rows.shape[1:]), byte_rows.device
    n = byte_rows.shape[0]
    padded_len, first = pad_keccak(n, sha3)
    pad = [0] * (padded_len - n)
    pad[0] |= first
    pad[-1] |= 0x80
    pad = torch.tensor(pad, dtype=torch.int64, device=device)
    rows = torch.cat([byte_rows.to(torch.int64),
                      pad.reshape((-1,) + (1,) * len(bshape)).expand(
                          (len(pad),) + bshape)])

    n_blocks = padded_len // RATE_BYTES
    nd = len(bshape)
    # little-endian lanes: lane i = bytes 8i..8i+7 -> (x, y) = (i % 5, i // 5)
    sh = torch.tensor([0, 8, 16, 24], device=device).reshape(
        (1, 1, 1, 4) + (1,) * nd)
    words = (rows.reshape((n_blocks, RATE_BYTES // 8, 2, 4) + bshape)
             << sh).sum(3)                         # (blocks, 17, lo/hi, *B)
    lanes = torch.zeros((n_blocks, 25, 2) + bshape, dtype=torch.int64,
                        device=device)
    lanes[:, :RATE_BYTES // 8] = words.flip(2)      # (hi, lo)
    # lane index i = x + 5y -> the state's [x][y]
    blocks = lanes.reshape((n_blocks, 5, 5, 2) + bshape).transpose(1, 2)

    state = torch.zeros((5, 5, 2) + bshape, dtype=torch.int64, device=device)
    for blk in range(n_blocks):
        state = keccak_f(state ^ blocks[blk])

    out = []
    for i in range(4):                      # 32 bytes = 4 lanes
        hi, lo = state[i, 0, 0], state[i, 0, 1]
        for b in range(4):
            out.append((lo >> (8 * b)) & 0xFF)
        for b in range(4):
            out.append((hi >> (8 * b)) & 0xFF)
    return out


def eth_address_from_pubkey(pk_bytes64):
    """GetEthAddrFromPubKey (eth.circom): keccak256 of the 64-byte
    uncompressed public key (x || y, no 0x04 prefix), its low 20 bytes.
    pk_bytes64: one (64, *B) int64 tensor. Returns 20 byte tensors."""
    return keccak256_bytes(pk_bytes64)[12:]
