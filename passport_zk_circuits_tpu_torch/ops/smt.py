"""Batched iden3-style Sparse-Merkle-Tree inclusion verifier, in PyTorch.

Counterpart of ``passport_zk_circuits_tpu/ops/smt.py``:
  * leaf hash  = Poseidon3(key, value, 1);
  * node hash  = Poseidon2(L, R);
  * SMTLevIns finds the level just past the last non-zero sibling;
  * the per-level state machine st_top / st_inew and the root climb keyed by
    the bits of `key`.
The verdict is returned, not enforced.
"""

from __future__ import annotations

import torch

from . import field as fr


def _lev_ins(sib_is_zero):
    """SMTLevIns. sib_is_zero: (N, *B) bool -> levIns (N, *B) bool: set at
    the first level (from the root-most index 0) whose previous sibling is
    the last non-zero one. In closed form: lev[i] (i >= 1) is "sibling i-1
    non-zero and siblings i..N-2 all zero", lev[0] is "siblings 0..N-2 all
    zero"; the suffix test is a reverse cumulative product, so the whole
    function is a handful of tensor ops at any depth."""
    z = sib_is_zero[:-1]
    ones = torch.ones_like(sib_is_zero[:1])
    zero_from = torch.cat([z.flip(0).long().cumprod(0).flip(0).bool(), ones])
    return zero_from & torch.cat([ones, ~z])


def climb_inputs(key, siblings):
    """The climb's per-level inputs, deepest level first, as the kernel
    takes them: siblings (16 N, B), and the key bit, st_top and st_inew
    flags (N, B). st_top[i]: no levIns fired at or before level i;
    st_inew[i]: it fires at i."""
    N, B = siblings.shape[1], siblings.shape[2]
    lev_ins = _lev_ins(fr.is_zero(siblings))
    fired = torch.cumsum(lev_ins.long(), 0)
    st_inew = lev_ins & (fired == 1)
    st_top = fired == 0
    return (siblings.transpose(0, 1).flip(0).reshape(N * 16, B),
            fr.to_bits(key, N).flip(0), st_top.long().flip(0),
            st_inew.long().flip(0))


def verify(root, key, value, siblings):
    """Batched SMT inclusion proof.

    root, key, value: (16, B) Fr limbs; siblings: (16, N_LEVELS, B).
    Returns (is_verified (B,) bool, computed_root (16, B)). The leaf hash
    and the whole climb go through the kernel wrapper, which takes a CUDA
    tensor to the hand-written kernels and a CPU tensor to the plain
    version."""
    from . import cuda_poseidon
    computed = cuda_poseidon.smt_climb(*climb_inputs(key, siblings), key,
                                       value)
    # the reference asserts the topmost sibling is zero
    return (fr.eq(computed, root) & fr.is_zero(siblings[:, -1]),
            computed)
