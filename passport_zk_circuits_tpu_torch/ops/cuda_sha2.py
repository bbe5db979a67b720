"""K1 wrapper: batched SHA-256/224 over pre-padded blocks (csrc/sha256.cu).

Replaces ``sha2_32_chunks`` of ``passport_zk_circuits_tpu/ops/pallas_sha2.py``
(one fused Pallas call over all blocks of a message). On the H100 the work
is 64 rounds of 32-bit logic per block and lane with a state of 8 words and
a 16-word schedule window: it fits in registers, so the kernel is bound by
integer issue rate and, at the flagship's 1024 lanes (8 blocks of 128
threads), by how few SMs it occupies. One thread per lane, all blocks of a
message in one launch, batch-minor layout so that loads coalesce.

The kernel reads the int64 word tensors as they are (no narrowing cast).
"""

from __future__ import annotations

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
    lib = cuda_build.library()
    with torch.cuda.device(msg.device):
        rc = lib.pzk_sha256(msg.data_ptr(), out.data_ptr(), nb, B,
                            int(algo == 224), cuda_build.stream_of(msg))
    cuda_build.check(rc, "sha2_32_chunks")
    sha2_32_chunks.launches += 1
    return out if algo == 256 else out[:7]


sha2_32_chunks.launches = 0
