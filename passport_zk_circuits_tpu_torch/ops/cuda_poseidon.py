"""K3 and K4 wrappers: PoseidonEx permutation and the whole SMT root climb
(csrc/poseidon.cu, the permutation's schedule in csrc/poseidon.cuh).

Replace ``poseidon_ex`` / ``_permute`` and ``smt_climb`` of
``passport_zk_circuits_tpu/ops/pallas_poseidon.py``. On the H100 a
permutation is a chain of ~65-70 rounds of dependent 256-bit Montgomery
products: the kernels are bound by the latency of those chains, not by
memory, since B = 1024 lanes are too few to hide one chain behind others.
K3 splits a lane's permutation over a group of threads: the state's
elements side by side, each over a team of threads that holds its words
(4 threads at t <= 8, 2 at t <= 16, 1 at t = 17), so a round waits on
about 4 team products instead of 2t + 2 products of one thread, and a
batch of 1024 fills 256 to 1024 one-warp blocks. K4 runs the whole
climb in one launch with a team of eight threads a lane
(csrc/fr_team.cuh), one warp (four lanes) a block, the t = 3 constants in
shared memory, and skips a level for a warp when none of its lanes is on
the top path there. The TPU route is capped at t <= 8 by the MXU's f32
exactness; K3 takes every t from 2 to 17.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cuda_build
from . import field as fr
from . import poseidon as pos

_R = 1 << 256                   # Montgomery radix of csrc/fr_bn254.cuh


def _limbs_row_to_int(row) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(row))


@functools.lru_cache(maxsize=None)
def _pack(t: int, device: torch.device) -> torch.Tensor:
    """The kernel's constant pack for width t: C, M, P and S rows of the
    npz, each as 8 little-endian 32-bit words in Montgomery form (see
    csrc/poseidon.cuh), as an int32 tensor the kernel reads as uint32."""
    with np.load(pos.NPZ) as data:
        rows = np.concatenate([data[f"{k}_{t}"] for k in "CMPS"])
    words = np.zeros((rows.shape[0], 8), np.uint32)
    for r, row in enumerate(rows):
        x = _limbs_row_to_int(row) * _R % fr.P
        words[r] = [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    return torch.from_numpy(words.reshape(-1).view(np.int32)).to(device)


def poseidon_ex_plain(inputs, n_outs: int = 1, initial_state=None):
    """Plain PyTorch version (ops/poseidon.permute_plain)."""
    return pos.permute_plain(pos.stack_inputs(inputs, initial_state), n_outs)


def poseidon_ex(inputs, n_outs: int = 1, initial_state=None):
    """PoseidonEx. inputs: (16, n, B) or list of (16, B) canonical limbs;
    returns (16, n_outs, B). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    state = pos.stack_inputs(inputs, initial_state)       # (16, t, B)
    if not state.is_cuda:
        return pos.permute_plain(state, n_outs)
    _, t, B = state.shape
    if not 2 <= t <= 17 or not 1 <= n_outs <= t:
        raise ValueError(f"poseidon_ex: bad width {t} or n_outs {n_outs}")
    # kernel layout: element j in rows 16j..16j+15
    flat = state.transpose(0, 1).reshape(16 * t, B).contiguous()
    cuda_build.require_cuda_int64("poseidon_ex", flat)
    out = torch.empty((16 * n_outs, B), dtype=torch.int64, device=flat.device)
    pack = _pack(t, flat.device)
    cuda_build.launch("poseidon_ex", "pzk_poseidon", flat, flat.data_ptr(),
                      out.data_ptr(), pack.data_ptr(), t,
                      pos.N_ROUNDS_P[t - 2], n_outs, B)
    poseidon_ex.launches += 1
    return out.reshape(n_outs, 16, B).transpose(0, 1)


poseidon_ex.launches = 0


def _leaf(key, value):
    """SMT leaf hash Poseidon(key, value, 1)."""
    one = torch.zeros_like(key)
    one[0] = 1
    return torch.stack([key, value, one], 1)


def smt_climb_plain(siblings_flip, lrbits_flip, top_flip, inew_flip, key,
                    value):
    """Plain PyTorch version of the climb. A level's hash reaches the root
    only in lanes still on the top path, so a level where no lane is on it
    skips the hash: the result is the same, and the flagship's all-zero
    sibling paths cost one permutation instead of 81."""
    leaf = poseidon_ex_plain(_leaf(key, value))[:, 0]
    n_levels, B = lrbits_flip.shape
    sibs = siblings_flip.reshape(n_levels, 16, B)
    need = top_flip.bool().any(1).tolist()
    child = torch.zeros_like(key)
    for i in range(n_levels):
        below = fr.select(inew_flip[i], leaf, torch.zeros_like(leaf))
        if not need[i]:
            child = below
            continue
        lr = lrbits_flip[i]
        left = fr.select(lr, sibs[i], child)
        right = fr.select(lr, child, sibs[i])
        h = poseidon_ex_plain([left, right])[:, 0]
        child = fr.select(top_flip[i], h, below)
    return child


def smt_climb(siblings_flip, lrbits_flip, top_flip, inew_flip, key, value):
    """Whole SMT root climb. siblings_flip: (N*16, B), deepest level first,
    16 limb rows per level; lrbits/top/inew_flip: (N, B) 0/1 flags, deepest
    first; key, value: (16, B) canonical. Returns the root (16, B). The
    leaf hash is one K3 launch, the climb one K4 launch. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernels."""
    if not key.is_cuda:
        return smt_climb_plain(siblings_flip, lrbits_flip, top_flip,
                               inew_flip, key, value)
    n_levels, B = lrbits_flip.shape
    leaf = poseidon_ex(_leaf(key, value))[:, 0].contiguous()
    args = [x.contiguous() for x in
            (siblings_flip, lrbits_flip, top_flip, inew_flip)]
    if args[0].shape != (16 * n_levels, B):
        raise ValueError(f"smt_climb: bad siblings {tuple(args[0].shape)}")
    cuda_build.require_cuda_int64("smt_climb", *args, leaf)
    out = torch.empty_like(leaf)
    pack = _pack(3, leaf.device)
    cuda_build.launch("smt_climb", "pzk_smt_climb", leaf,
                      *[a.data_ptr() for a in args], leaf.data_ptr(),
                      out.data_ptr(), pack.data_ptr(), pos.N_ROUNDS_P[1],
                      n_levels, B)
    smt_climb.launches += 1
    return out


smt_climb.launches = 0
