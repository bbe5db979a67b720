"""The port's Poseidon against the JAX package and the circomlib oracle.

The same seeded inputs go through the JAX XLA Poseidon (the path the JAX
package's fast tests run on the CPU) and the port's plain version, at the
flagship's widths t = 3 and t = 6; every other width is held against the
Python-int oracle. Exact equality throughout.
"""

import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import field as jfr
from passport_zk_circuits_tpu.ops import poseidon as jpos
from passport_zk_circuits_tpu.utils import poseidon_ref as pref
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import poseidon as pos

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(4404)
B = 3


def _cols(n):
    cols = [[rng.randrange(fr.P) for _ in range(B)] for _ in range(n)]
    cols[0][0] = fr.P - 1
    return cols


@pytest.mark.parametrize("n_in", [2, 5])
def test_poseidon_matches_jax(n_in):
    cols = _cols(n_in)
    np_in = [jfr.batch_to_limbs(c) for c in cols]
    got = pos.poseidon([bn.to_tensor(a, "cpu") for a in np_in])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpos.poseidon(np_in)))
    assert fr.batch_from_limbs(got) == \
        [pref.poseidon([c[i] for c in cols]) for i in range(B)]


@pytest.mark.parametrize("n_in", [1, 3, 16])
def test_poseidon_matches_oracle(n_in):
    cols = _cols(n_in)
    got = pos.poseidon(bn.to_tensor(
        np.stack([fr.batch_to_limbs(c) for c in cols], axis=1), "cpu"))
    assert fr.batch_from_limbs(got) == \
        [pref.poseidon([c[i] for c in cols]) for i in range(B)]


def test_poseidon_ex_multi_out_initial_state():
    cols = _cols(3)
    init = [rng.randrange(fr.P) for _ in range(B)]
    out = pos.poseidon_ex([bn.to_tensor(fr.batch_to_limbs(c), "cpu")
                           for c in cols], 3,
                          bn.to_tensor(fr.batch_to_limbs(init), "cpu"))
    for j in range(3):
        assert fr.batch_from_limbs(out[:, j]) == [
            pref.poseidon_ex([c[i] for c in cols], 3, init[i])[j]
            for i in range(B)]


def test_constants_match_jax_and_kernel_pack():
    for t in (2, 3, 6, 17):
        mine, ref = pos._consts(t), jpos._consts(t)
        for key in ("ark", "ark2", "cp", "m", "p", "s0", "s1"):
            np.testing.assert_array_equal(mine[key], ref[key])
    # the kernel's pack holds the same constants in Montgomery form
    C, M, Pm, S = pref.constants(3)
    words = cuda_poseidon._pack(3, torch.device("cpu")).numpy().view(
        np.uint32).reshape(-1, 8)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in words]
    rinv = pow(1 << 256, -1, fr.P)
    flat = list(C) + [x for r in M for x in r] + [x for r in Pm for x in r] \
        + list(S)
    assert [v * rinv % fr.P for v in vals] == flat


def test_bad_width_raises():
    x = bn.to_tensor(fr.batch_to_limbs([1]), "cpu")
    with pytest.raises(ValueError):
        pos.poseidon([x] * 17)
