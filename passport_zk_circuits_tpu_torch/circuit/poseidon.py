"""Poseidon hash as an R1CS gadget (circomlib schedule over BN254 Fr).

Constraint twin of the reference's circuits/lib/circuits/hasher/poseidon/
poseidon.circom:80-226 (PoseidonEx with the optimized P/S partial-round
representation) and of the batched witness kernel ops/poseidon.py. All
linear layers are free (Fr linear combinations); only the x^5 S-boxes
allocate constraints (3 muls each) — ~`3*(8t + nP)` constraints per hash.

The port's copy of ``passport_zk_circuits_tpu/circuit/poseidon.py``
(host code over Python ints), with the same relative imports, which here
name the port's modules; ``tests/test_torch_copies.py`` holds its code
equal to the original's.
"""

from __future__ import annotations

from typing import List, Sequence

from ..utils import poseidon_ref as pref
from .builder import Builder, Sig


def _sigma(b: Builder, x: Sig) -> Sig:
    x2 = b.mul(x, x, "pose_x2")
    x4 = b.mul(x2, x2, "pose_x4")
    return b.mul(x4, x, "pose_x5")


def _mix(M, state: List[Sig]) -> List[Sig]:
    t = len(state)
    return [sum((state[j].scale(M[j][i]) for j in range(t)),
                state[0].b.const(0)) for i in range(t)]


def poseidon_ex(b: Builder, inputs: Sequence[Sig], n_outs: int = 1,
                initial_state: Sig = None) -> List[Sig]:
    n = len(inputs)
    t = n + 1
    nP = pref.N_ROUNDS_P[t - 2]
    C, M, Pm, S = pref.constants(t)
    state = [initial_state if initial_state is not None else b.const(0)]
    state += list(inputs)

    state = [state[i] + C[i] for i in range(t)]
    for r in range(3):
        state = [_sigma(b, x) for x in state]
        state = [state[i] + C[(r + 1) * t + i] for i in range(t)]
        state = _mix(M, state)
    state = [_sigma(b, x) for x in state]
    state = [state[i] + C[4 * t + i] for i in range(t)]
    state = _mix(Pm, state)

    for r in range(nP):
        s0 = _sigma(b, state[0]) + C[5 * t + r]
        state = [s0] + state[1:]
        row = S[(2 * t - 1) * r:(2 * t - 1) * (r + 1)]
        new0 = sum((state[i].scale(row[i]) for i in range(t)), b.const(0))
        state = [new0] + [state[i] + state[0].scale(row[t + i - 1])
                          for i in range(1, t)]

    for r in range(3):
        state = [_sigma(b, x) for x in state]
        state = [state[i] + C[5 * t + nP + r * t + i] for i in range(t)]
        state = _mix(M, state)
    state = [_sigma(b, x) for x in state]
    return [sum((state[j].scale(M[j][i]) for j in range(t)), b.const(0))
            for i in range(n_outs)]


def poseidon(b: Builder, inputs: Sequence[Sig]) -> Sig:
    return poseidon_ex(b, inputs, 1)[0]
