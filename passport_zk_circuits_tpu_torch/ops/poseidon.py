"""Batched circomlib-compatible Poseidon over BN254 Fr, in PyTorch.

Counterpart of ``passport_zk_circuits_tpu/ops/poseidon.py``: the optimized
circomlib schedule (8 full rounds around nP partial rounds, the sparse P
pre-matrix and the per-round s0 row / s1 column maps), with the constants of
the port's copy of ``utils/constants/poseidon_bn254.npz``.

The plain version keeps the state as one (16, t, B) tensor: every S-box layer
is three batched modmuls, and every linear layer, the MDS mix as much as a
partial round's s0/s1 map, is one batched limb product over all t x t
entries followed by one Barrett reduction.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from . import bignum as bn
from . import field as fr

N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]

NPZ = (pathlib.Path(__file__).resolve().parent.parent / "utils" / "constants"
       / "poseidon_bn254.npz")


@functools.lru_cache(maxsize=None)
def _consts(t: int):
    """Constant arrays for width t (16-bit limbs, limb axis first), the same
    as the JAX package's, plus each partial round's whole linear map.

      ark:     (5, 16, t)    initial + first-half round constants
      ark2:    (3, 16, t)    second-half round constants
      cp:      (nP, 16)      partial-round constants
      m, p:    (16, t, t)    [l, j, i] = limb l of M[j][i] / P[j][i]
      s0:      (nP, 16, t)   MixS row constants
      s1:      (nP, 16, t-1) MixS column constants
      partial: (nP, 16, t, t) out[0] = sum_j s0[j] x_j,
                              out[i] = x_i + s1[i-1] x_0 (i >= 1)
    """
    with np.load(NPZ) as data:
        C = data[f"C_{t}"]
        S = data[f"S_{t}"]
        M = data[f"M_{t}"].reshape(t, t, 16)
        Pm = data[f"P_{t}"].reshape(t, t, 16)
    nP = N_ROUNDS_P[t - 2]
    out = {
        "ark": C[:5 * t].reshape(5, t, 16).transpose(0, 2, 1),
        "cp": C[5 * t:5 * t + nP],
        "ark2": C[5 * t + nP:5 * t + nP + 3 * t].reshape(3, t, 16)
                .transpose(0, 2, 1),
        "m": M.transpose(2, 0, 1),
        "p": Pm.transpose(2, 0, 1),
        "s0": S.reshape(nP, 2 * t - 1, 16)[:, :t].transpose(0, 2, 1),
        "s1": S.reshape(nP, 2 * t - 1, 16)[:, t:].transpose(0, 2, 1),
    }
    part = np.zeros((nP, 16, t, t), np.uint32)
    part[:, :, :, 0] = out["s0"]
    part[:, :, 0, 1:] = out["s1"]
    for i in range(1, t):
        part[:, 0, i, i] = 1
    out["partial"] = part
    return {k: np.ascontiguousarray(v, dtype=np.uint32)
            for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _tensors(t: int, device: torch.device):
    """The constants of `_consts(t)` as int64 tensors on `device`, with a
    trailing unit batch axis."""
    return {k: bn.to_tensor(v, device).unsqueeze(-1)
            for k, v in _consts(t).items()}


def _sigma(x):
    """x^5 (three modmuls)."""
    x2 = fr.sqr(x)
    x4 = fr.sqr(x2)
    return fr.mul(x4, x)


def _mix(rows, state):
    """out[:, i] = sum_j rows[:, j, i] * state[:, j]: all t x t_out limb
    products in one batched multiply, summed lazily, reduced once.
    rows: (16, t, t_out, 1); state: (16, t, B) -> (16, t_out, B)."""
    prods = bn.poly_mul(rows, state.unsqueeze(2))       # (32, t, t_out, B)
    return fr.reduce_overflowed(prods.sum(1))


def permute_plain(state, n_outs: int):
    """Plain PoseidonEx permutation of a (16, t, B) canonical state ->
    (16, n_outs, B)."""
    t = state.shape[1]
    c = _tensors(t, state.device)
    state = fr.add(state, c["ark"][0])

    def full_round(state, ark, rows):
        return _mix(rows, fr.add(_sigma(state), ark))

    for r in range(1, 4):
        state = full_round(state, c["ark"][r], c["m"])
    state = full_round(state, c["ark"][4], c["p"])
    for r in range(c["cp"].shape[0]):
        x0 = fr.add(_sigma(state[:, 0]), c["cp"][r])
        state = _mix(c["partial"][r],
                     torch.cat([x0.unsqueeze(1), state[:, 1:]], 1))
    for r in range(3):
        state = full_round(state, c["ark2"][r], c["m"])
    return _mix(c["m"][:, :, :n_outs], _sigma(state))


def stack_inputs(inputs, initial_state=None):
    """(16, n, B) tensor or list of (16, B) -> the (16, n+1, B) initial
    permutation state [initial_state or 0, inputs...]."""
    if isinstance(inputs, (list, tuple)):
        inputs = torch.stack(inputs, 1)
    if initial_state is None:
        init = torch.zeros_like(inputs[:, :1])
    else:
        init = initial_state.unsqueeze(1).expand_as(inputs[:, :1])
    return torch.cat([init, inputs], 1)


def poseidon_ex(inputs, n_outs: int = 1, initial_state=None):
    """Batched PoseidonEx. inputs: (16, n, B) or list of (16, B) limbs;
    returns (16, n_outs, B). Dispatch: the kernel wrapper takes a CUDA
    tensor to the hand-written kernel (any t from 2 to 17) and a CPU tensor
    to the plain version."""
    n = inputs.shape[1] if isinstance(inputs, torch.Tensor) else len(inputs)
    if not 2 <= n + 1 <= 17:
        raise ValueError("poseidon supports 1..16 inputs")
    from . import cuda_poseidon
    return cuda_poseidon.poseidon_ex(inputs, n_outs, initial_state)


def poseidon(inputs):
    """circomlib-compatible Poseidon hash: (16, n, B) or list of (16, B)
    -> (16, B)."""
    return poseidon_ex(inputs, 1)[:, 0]
