"""Pure-Python (bigint) Poseidon oracle, circomlib-compatible.

The port's own copy of ``passport_zk_circuits_tpu/utils/poseidon_ref.py``
with its Poseidon2 (T = 3) oracle, reading the port's copies of
``constants/poseidon_bn254.npz`` and ``constants/poseidon2_bn254_t3.npz``.
It builds SMT roots during ingestion and is the bit-exactness oracle of
the port's Poseidon and Poseidon2.

Implements the optimized Poseidon round schedule over BN254 Fr: 8 full rounds
(4 + 4) around nP partial rounds, with the pre-combined P/S matrices of the
optimized representation.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]

_NPZ = pathlib.Path(__file__).parent / "constants" / "poseidon_bn254.npz"


def _limbs_to_int(row: np.ndarray) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(row))


@functools.lru_cache(maxsize=None)
def constants(t: int):
    """Returns (C, M, Pm, S) as tuples of Python ints for state width t."""
    data = np.load(_NPZ)
    C = tuple(_limbs_to_int(r) for r in data[f"C_{t}"])
    S = tuple(_limbs_to_int(r) for r in data[f"S_{t}"])
    M = tuple(tuple(_limbs_to_int(data[f"M_{t}"][j * t + i]) for i in range(t))
              for j in range(t))
    Pm = tuple(tuple(_limbs_to_int(data[f"P_{t}"][j * t + i]) for i in range(t))
               for j in range(t))
    return C, M, Pm, S


def _sigma(x: int) -> int:
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x % P


def _mix(M, state):
    t = len(state)
    return [sum(M[j][i] * state[j] for j in range(t)) % P for i in range(t)]


def poseidon_ex(inputs, n_outs: int = 1, initial_state: int = 0):
    n = len(inputs)
    t = n + 1
    if not (2 <= t <= 17):
        raise ValueError("poseidon supports 1..16 inputs")
    nP = N_ROUNDS_P[t - 2]
    C, M, Pm, S = constants(t)
    state = [initial_state % P] + [x % P for x in inputs]

    state = [(state[i] + C[i]) % P for i in range(t)]
    for r in range(3):
        state = [_sigma(x) for x in state]
        state = [(state[i] + C[(r + 1) * t + i]) % P for i in range(t)]
        state = _mix(M, state)
    state = [_sigma(x) for x in state]
    state = [(state[i] + C[4 * t + i]) % P for i in range(t)]
    state = _mix(Pm, state)

    for r in range(nP):
        s0 = (_sigma(state[0]) + C[5 * t + r]) % P
        state = [s0] + state[1:]
        row = S[(2 * t - 1) * r:(2 * t - 1) * (r + 1)]
        new0 = sum(row[i] * state[i] for i in range(t)) % P
        state = [new0] + [(state[i] + state[0] * row[t + i - 1]) % P
                          for i in range(1, t)]

    for r in range(3):
        state = [_sigma(x) for x in state]
        state = [(state[i] + C[5 * t + nP + r * t + i]) % P for i in range(t)]
        state = _mix(M, state)
    state = [_sigma(x) for x in state]
    return [sum(M[j][i] * state[j] for j in range(t)) % P
            for i in range(n_outs)]


def poseidon(inputs) -> int:
    """circomlib-compatible Poseidon hash of 1..16 field elements."""
    return poseidon_ex(inputs, 1)[0]


# ---------------------------------------------------------------------------
# Poseidon2 (T=3) oracle: the host twin of ops/poseidon2.py, reading the
# port's copy of constants/poseidon2_bn254_t3.npz
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _p2_consts():
    data = np.load(pathlib.Path(__file__).parent / "constants" /
                   "poseidon2_bn254_t3.npz")
    internal = [_limbs_to_int(r) for r in data["internal"]]
    external = [[_limbs_to_int(data["external"][i, j]) for j in range(3)]
                for i in range(8)]
    return internal, external


def _p2_sigma(x):
    x2 = x * x % P
    return x2 * x2 % P * x % P


def _p2_linear(s):
    tot = sum(s) % P
    return [(x + tot) % P for x in s]


def poseidon2_permutation(state):
    internal, external = _p2_consts()
    s = _p2_linear([x % P for x in state])
    for k in range(4):
        s = _p2_linear([_p2_sigma((s[j] + external[k][j]) % P)
                        for j in range(3)])
    for k in range(56):
        sg = _p2_sigma((s[0] + internal[k]) % P)
        s = [(2 * sg + s[1] + s[2]) % P,
             (sg + 2 * s[1] + s[2]) % P,
             (sg + s[1] + 3 * s[2]) % P]
    for k in range(4, 8):
        s = _p2_linear([_p2_sigma((s[j] + external[k][j]) % P)
                        for j in range(3)])
    return s


def poseidon2_compression(a, b):
    return poseidon2_permutation([a, b, 0])[0]


def poseidon2_sponge(inputs, capacity=2):
    rate = 3 - capacity
    n_blocks = ((len(inputs) + 1) + (rate - 1)) // rate
    padded = list(inputs) + [1]
    padded += [0] * (n_blocks * rate - len(padded))
    civ = (1 << 64) + 256 * 3 + rate
    state = [0, 0, civ]
    for m in range(n_blocks):
        for i in range(rate):
            state[i] = (state[i] + padded[m * rate + i]) % P
        state = poseidon2_permutation(state)
    return state[0]
