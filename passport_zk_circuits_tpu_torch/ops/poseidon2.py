"""Batched Poseidon2 permutation (BN254, T = 3), sponge and Merkle root.

Counterpart of ``passport_zk_circuits_tpu/ops/poseidon2.py``, plain PyTorch
(the JAX module is XLA code: no Pallas kernel reaches it). The same
schedule, so every output equals the JAX package's: the external linear
layer circulant(2, 1, 1), 4 external rounds, 56 internal rounds with the
matrix [[2,1,1],[1,2,1],[1,1,3]], 4 external rounds (poseidon2Perm.circom);
the sponge with CIV = 2^64 + 256*T + rate and 10* padding
(poseidon2Sponge.circom); the Merkle root by compression at each level
(poseidon2Merkle.circom).

The arithmetic is ``bignum.StaticMod`` over Fr (canonical residues, the
integers ``ops/field`` gives, in about a quarter of its tensor ops), and
the state is one (16, 3, *B) tensor, so an external round's three S-boxes
and its linear layer are one call each. The round constants come from
``utils/constants/poseidon2_bn254_t3.npz`` and are held on the device once
per device; ``lax.scan`` becomes a Python loop over their rows.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from . import bignum as bn
from . import field as fr

NPZ = pathlib.Path(__file__).parent.parent / "utils" / "constants" / \
    "poseidon2_bn254_t3.npz"

T = 3
N_EXT = 8
N_INT = 56
_F = bn.StaticMod(fr.P, fr.NLIMBS)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device, ndim: int):
    """(external (8, 16, 3, 1..), internal (56, 16, 1..)) int64 limbs on
    device, shaped to broadcast against a (16, 3, *B) state of ndim - 2
    batch dims (internal: a (16, *B) element), made once: never write to
    them."""
    with np.load(NPZ) as d:
        ext = bn.to_tensor(d["external"], device).transpose(1, 2)
        internal = bn.to_tensor(d["internal"], device)
    nb = ndim - 2
    return (ext.reshape(ext.shape + (1,) * nb),
            internal.reshape(internal.shape + (1,) * nb))


def _sigma(x):
    x2 = _F.mul(x, x)
    return _F.mul(_F.mul(x2, x2), x)


def _linear_layer(s):
    """circulant(2,1,1) on a (16, 3, *B) state: s_i + (s_0 + s_1 + s_2)."""
    tot = _F.add(_F.add(s[:, 0], s[:, 1]), s[:, 2])
    return _F.add(s, tot.unsqueeze(1))


def _internal(s, c):
    """One internal round: the S-box on s_0 + c, then the matrix
    [[2,1,1],[1,2,1],[1,1,3]], as (x + y + z) + (x, y, 2z)."""
    x = _sigma(_F.add(s[:, 0], c))
    y, z = s[:, 1], s[:, 2]
    tot = _F.add(_F.add(x, y), z)
    return _F.add(torch.stack([x, y, _F.add(z, z)], 1), tot.unsqueeze(1))


def permute(s):
    """Poseidon2 permutation of a (16, 3, *B) state (standard domain)."""
    ext, internal = _consts(s.device, s.dim())
    s = _linear_layer(s)
    for k in range(N_EXT // 2):
        s = _linear_layer(_sigma(_F.add(s, ext[k])))
    for k in range(N_INT):
        s = _internal(s, internal[k])
    for k in range(N_EXT // 2, N_EXT):
        s = _linear_layer(_sigma(_F.add(s, ext[k])))
    return s


def permutation(s0, s1, s2):
    """Poseidon2 permutation, T = 3. Inputs and outputs (16, *B) limbs,
    standard domain."""
    return permute(torch.stack([s0, s1, s2], 1)).unbind(1)


def compression(a, b):
    """2 -> 1 compression (poseidon2Perm.circom's Compression)."""
    return permutation(a, b, torch.zeros_like(a))[0]


def sponge_hash(inputs, capacity: int = 2):
    """Poseidon2Hash (Poseidon2SpongeHashRate1 with rate = T - capacity).
    inputs: a list of (16, *B) or one (16, n, *B); returns (16, *B)."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs[:, i] for i in range(inputs.shape[1])]
    rate = T - capacity
    bshape = tuple(inputs[0].shape[1:])
    dev = inputs[0].device
    n = len(inputs)
    n_blocks = ((n + 1) + (rate - 1)) // rate
    padded = list(inputs) + [fr.const(1, bshape, dev)]
    while len(padded) < n_blocks * rate:
        padded.append(fr.const(0, bshape, dev))

    civ = (1 << 64) + 256 * T + rate
    state = torch.stack([fr.const(0, bshape, dev), fr.const(0, bshape, dev),
                         fr.const(civ, bshape, dev)], 1)
    for m in range(n_blocks):
        block = torch.stack(padded[m * rate:(m + 1) * rate], 1)
        state = torch.cat([_F.add(state[:, :rate], block),
                           state[:, rate:]], 1)
        state = permute(state)
    return state[:, 0]


def merkle_root(leaves):
    """PoseidonMerkle: (16, 2^L, *B) leaves -> (16, *B) root, by
    compression at each level."""
    n = leaves.shape[1]
    if n & (n - 1):
        raise ValueError("leaf count must be a power of two")
    level = leaves
    while level.shape[1] > 1:
        level = compression(level[:, 0::2].contiguous(),
                            level[:, 1::2].contiguous())
    return level[:, 0]
