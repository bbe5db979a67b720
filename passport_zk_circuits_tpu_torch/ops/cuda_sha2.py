"""K1 wrapper: batched SHA-256/224 over pre-padded blocks (csrc/sha256.cu).

Replaces ``sha2_32_chunks`` of ``passport_zk_circuits_tpu/ops/pallas_sha2.py``
(one fused Pallas call over all blocks of a message). On the H100 the work
is 64 rounds of 32-bit logic per block and lane with a state of 8 words and
a 16-word schedule window: it fits in registers, and each lane's rounds are
one dependent chain, so at the flagship's 1024 lanes the kernel is bound by
that chain and by how few SMs one message's lanes occupy. Two entries:

- ``sha2_32_chunks``: one message, one launch, a thread a lane;
- ``sha2_32_chunks_many``: up to four messages of the same batch, each with
  its own block count and SHA-224/256, in one launch (the witness step's
  dg1, dg15, ec and sa), one warp of one message a thread block.

The kernel reads the int64 word tensors as they are (no narrowing cast).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import sha2


def sha2_32_chunks_plain(msg, algo: int = 256):
    """Plain PyTorch version: msg (16*nb, B) int64 words -> (8 or 7, B)."""
    iv = sha2.H256 if algo == 256 else sha2.H224
    state = [torch.full(msg.shape[1:], int(v), dtype=torch.int64,
                        device=msg.device) for v in iv]
    for blk in range(msg.shape[0] // 16):
        state = sha2._sha256_block(state, msg[16 * blk:16 * blk + 16])
    return torch.stack(state[:8 if algo == 256 else 7])


def sha2_32_chunks(msg, algo: int = 256):
    """Batched SHA-256/224 of pre-padded big-endian words.
    msg: (16*nb, B) int64 -> (8 or 7, B). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if algo not in (224, 256):
        raise ValueError(f"sha2_32_chunks: algo {algo} is not SHA-224/256")
    if msg.dim() != 2 or msg.shape[0] % 16:
        raise ValueError(f"sha2_32_chunks: bad message shape {msg.shape}")
    if not msg.is_cuda:
        return sha2_32_chunks_plain(msg, algo)
    msg = msg.contiguous()
    cuda_build.require_cuda_int64("sha2_32_chunks", msg)
    nb, B = msg.shape[0] // 16, msg.shape[1]
    out = torch.empty((8, B), dtype=torch.int64, device=msg.device)
    cuda_build.launch("sha2_32_chunks", "pzk_sha256", msg, msg.data_ptr(),
                      out.data_ptr(), nb, B, int(algo == 224))
    if B:
        sha2_32_chunks.launches += 1
    return out if algo == 256 else out[:7]


sha2_32_chunks.launches = 0

MAX_MSGS = 4


def sha2_32_chunks_many_plain(msgs, algos):
    """Plain PyTorch version: sha2_32_chunks_plain over the list."""
    return [sha2_32_chunks_plain(m, a) for m, a in zip(msgs, algos)]


def sha2_32_chunks_many(msgs, algos):
    """Up to four batched SHA-256/224 hashes in one launch. msgs: a list of
    (16*nb_i, B) int64 word tensors, one B for all; algos: 224 or 256 for
    each. Returns the list of digests, (8 or 7, B) each. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    msgs, algos = list(msgs), list(algos)
    if not 1 <= len(msgs) <= MAX_MSGS or len(algos) != len(msgs):
        raise ValueError(f"sha2_32_chunks_many: 1 to {MAX_MSGS} messages, "
                         f"one algo each; got {len(msgs)} and {len(algos)}")
    for m, a in zip(msgs, algos):
        if a not in (224, 256):
            raise ValueError(f"sha2_32_chunks_many: algo {a} is not "
                             "SHA-224/256")
        if m.dim() != 2 or m.shape[0] % 16 or m.shape[1] != msgs[0].shape[1]:
            raise ValueError("sha2_32_chunks_many: bad message shape "
                             f"{tuple(m.shape)} (first {tuple(msgs[0].shape)})")
    if not msgs[0].is_cuda:
        return sha2_32_chunks_many_plain(msgs, algos)
    msgs = [m.contiguous() for m in msgs]
    cuda_build.require_cuda_int64("sha2_32_chunks_many", *msgs)
    n, B = len(msgs), msgs[0].shape[1]
    outs = [torch.empty((8, B), dtype=torch.int64, device=m.device)
            for m in msgs]
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    cuda_build.launch("sha2_32_chunks_many", "pzk_sha256_many", msgs[0],
                      ptrs(*[m.data_ptr() for m in msgs]),
                      ptrs(*[o.data_ptr() for o in outs]),
                      ints(*[m.shape[0] // 16 for m in msgs]),
                      ints(*[int(a == 224) for a in algos]), n, B)
    if B:
        sha2_32_chunks_many.launches += 1
    return [o if a == 256 else o[:7] for o, a in zip(outs, algos)]


sha2_32_chunks_many.launches = 0
