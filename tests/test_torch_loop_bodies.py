"""K8's bodies (ops/cuda_loop.PLAIN_STEPS, the plain versions the kernel is
held against on the card) against the same bodies written with the JAX
package's pallas_field building blocks, as tools/microbench_kernel.py
writes them, run as plain jnp (no pallas_call), on the same seeded inputs,
bit for bit (tolerance 0: integer arithmetic).

The two modmul bodies of the port are both held against pf.modmul, the
canonical (x·c) mod P; the JAX tool's MXU bodies, whose outputs lie in
[0, 2P), have no counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import pallas_field as pf
from passport_zk_circuits_tpu_torch.ops import cuda_loop

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

B = 8
N = 3

JAX_STEPS = {
    "u32_mul_add": lambda x, c: (x * c + 1) & 0xFFFF,
    "i32_mul_add": lambda x, c: (x.astype(jnp.int32) * c.astype(jnp.int32)
                                 + 1).astype(jnp.uint32) & 0xFFFF,
    "mask_shift_add": lambda x, c: ((x & 0xFFFF) + (c >> 1)) & 0xFFFF,
    "school": lambda x, c: pf._carry16(pf.school_mul(x, c)[:16], 16),
    "modmul_barrett16": pf.modmul,
    "modmul_mont32": pf.modmul,
    "barrett_only": lambda x, c: pf.barrett_static(
        jnp.concatenate([x, x], axis=0)),
}


def test_every_body_has_a_jax_counterpart():
    assert tuple(JAX_STEPS) == cuda_loop.BODIES


@pytest.mark.parametrize("body", cuda_loop.BODIES)
def test_body_matches_jax_building_blocks(body):
    rs = np.random.RandomState(cuda_loop.BODIES.index(body))
    a = rs.randint(0, 1 << 16, (16, B)).astype(np.uint32)
    c = rs.randint(1, 1 << 16, (16, B)).astype(np.uint32)
    a[:, 0] = 0xFFFF                       # 2^256 - 1: above P
    got = cuda_loop.loop(body, torch.from_numpy(a.astype(np.int64)),
                         torch.from_numpy(c.astype(np.int64)), N)
    step = jax.jit(JAX_STEPS[body])
    x = jnp.asarray(a)
    for _ in range(N):
        x = step(x, jnp.asarray(c))
    assert np.array_equal(got.numpy(), np.asarray(x).astype(np.int64))


def test_loop_rejects_bad_arguments():
    x = torch.zeros((16, B), dtype=torch.int64)
    with pytest.raises(ValueError):
        cuda_loop.loop("modmul_mxu", x, x, 1)
    with pytest.raises(ValueError):
        cuda_loop.loop("school", x, x, 0)
