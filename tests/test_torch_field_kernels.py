"""K6 and K7 of the port (ops/cuda_field.mul, mul_chain; on the CPU their
plain versions) against the JAX package's Pallas kernels pf.mul and
pf.mul_chain, run in interpret mode as tests/test_pallas_parity.py runs
them, on the same seeded inputs, bit for bit (tolerance 0: integer
arithmetic). Inputs include values >= P up to 2^256 - 1, which both take,
and a broadcast (16, 1) column.
"""

import random

import jax
import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import pallas_field as pf
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_field
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

rng = random.Random(2602)
B = 8
EDGES = [0, 1, fr.P - 1, fr.P, (1 << 256) - 1]
XS = EDGES + [rng.getrandbits(256) for _ in range(B - len(EDGES))]
YS = EDGES[::-1] + [rng.randrange(fr.P) for _ in range(B - len(EDGES))]
C = rng.getrandbits(256)


def _np(xs):
    return bn.ints_to_limbs_batch(xs, 16)            # (16, n) uint32


def _jax_ints(x):
    return bn.limbs_to_ints_batch(np.asarray(jax.block_until_ready(x)))


def _port(xs):
    return torch.from_numpy(_np(xs).astype(np.int64))


def test_mul_matches_pallas_with_edges():
    got = cuda_field.mul(_port(XS), _port(YS))
    want = _jax_ints(pf.mul(_np(XS), _np(YS)))
    assert bn.limbs_to_ints_batch(got) == want == \
        [x * y % fr.P for x, y in zip(XS, YS)]


def test_mul_broadcast_column_matches_pallas():
    got = cuda_field.mul(_port(XS), _port([C]))
    want = _jax_ints(pf.mul(_np(XS), _np([C])))
    assert bn.limbs_to_ints_batch(got) == want == [x * C % fr.P for x in XS]


@pytest.mark.parametrize("n", [0, 1, 5])
def test_mul_chain_matches_pallas(n):
    got = cuda_field.mul_chain(_port(XS), _port([C]), n)
    want = _jax_ints(pf.mul_chain(_np(XS), _np([C]), n))
    assert bn.limbs_to_ints_batch(got) == want
    if n == 0:                       # the zero-trip loop: a, not reduced
        assert want == XS
    else:
        assert want == [x * pow(C, n, fr.P) % fr.P for x in XS]


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        cuda_field.mul(_port(XS), _port(YS)[:, :3])
    with pytest.raises(ValueError):
        cuda_field.mul_chain(_port(XS), _port([C]), -1)
