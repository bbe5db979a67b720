"""The port's ops/gadgets against the JAX package's, bit for bit
(tolerance 0), on tests/test_gadgets.py's cases and seeded ones: switcher
and force_equal_if_enabled, xor2, bin_sum, sort_checked (ascending and
descending, with ties), the matrix templates and the fixed-point ones."""

import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import field as jfr
from passport_zk_circuits_tpu.ops import gadgets as jg
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import gadgets as g

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(909)


def _t(a):
    return bn.to_tensor(a, "cpu")


def _eq(mine, theirs):
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs).astype(
        mine.numpy().dtype))


def test_switcher_and_force_equal():
    a = jfr.batch_to_limbs([1, 2, 3])
    b = jfr.batch_to_limbs([4, 5, 6])
    sel = np.array([True, False, True])
    for mine, theirs in zip(g.switcher(torch.as_tensor(sel), _t(a), _t(b)),
                            jg.switcher(sel, a, b)):
        _eq(mine, theirs)
    assert fr.batch_from_limbs(g.switcher(torch.as_tensor(sel), _t(a),
                                          _t(b))[0]) == [4, 2, 6]
    en = np.array([True, True, False])
    y = jfr.batch_to_limbs([1, 9, 9])
    ok = g.force_equal_if_enabled(torch.as_tensor(en), _t(a), _t(y))
    _eq(ok, jg.force_equal_if_enabled(en, a, y))
    assert ok.tolist() == [True, False, True]


def test_xor2_and_bin_sum():
    n, B = 20, 5
    bits = [np.array([[rng.randrange(2) for _ in range(B)]
                      for _ in range(n)], dtype=np.uint32) for _ in range(5)]
    _eq(g.xor2(_t(bits[0]), _t(bits[1])), jg.xor2(bits[0], bits[1]))
    for k in (1, 2, 3, 5):
        got = g.bin_sum([_t(b) for b in bits[:k]])
        _eq(got, jg.bin_sum(bits[:k]))
        vals = [sum(int(b[i, j]) << i for b in bits[:k] for i in range(n))
                for j in range(B)]
        assert [sum(int(got[i, j]) << i for i in range(got.shape[0]))
                for j in range(B)] == vals


@pytest.mark.parametrize("descending", [False, True])
def test_sort_checked(descending):
    B, n = 3, 8
    cols = [[rng.randrange(1 << 48) for _ in range(n)] for _ in range(B)]
    cols[1][2] = cols[1][5]                 # a tie
    cols[2] = [rng.randrange(4) << (16 * rng.randrange(4)) for _ in range(n)]
    vals = np.stack([jfr.batch_to_limbs([c[i] for c in cols])
                     for i in range(n)], axis=0)     # (n, 16, B)
    got = g.sort_checked(_t(vals), descending)
    want = jg.sort_checked(vals, descending)
    for mine, theirs in zip(got, want):
        _eq(mine, theirs)
    assert got[1].all() and got[2].all()
    for j in range(B):
        assert [fr.batch_from_limbs(got[0][i])[j] for i in range(n)] == \
            sorted(cols[j], reverse=descending)


def _mat(rows, cols, B):
    ints = [[[rng.randrange(fr.P) for _ in range(B)] for _ in range(cols)]
            for _ in range(rows)]
    limbs = np.stack([np.stack([jfr.batch_to_limbs(ints[i][j])
                                for j in range(cols)]) for i in range(rows)])
    return ints, limbs


def test_matrices():
    B, n, m, q = 2, 2, 3, 2
    A, A_l = _mat(n, m, B)
    Bm, B_l = _mat(m, q, B)
    C = g.mat_mul(_t(A_l), _t(B_l))
    _eq(C, jg.mat_mul(A_l, B_l))
    for i in range(n):
        for j in range(q):
            assert fr.batch_from_limbs(C[i, j]) == [
                sum(A[i][k][b] * Bm[k][j][b] for k in range(m)) % fr.P
                for b in range(B)]
    A2, A2_l = _mat(n, m, B)
    _eq(g.mat_add(_t(A_l), _t(A2_l)), jg.mat_add(A_l, A2_l))
    _eq(g.mat_hadamard(_t(A_l), _t(A2_l)), jg.mat_hadamard(A_l, A2_l))
    _eq(g.mat_transpose(_t(A_l)), jg.mat_transpose(A_l))


@pytest.mark.parametrize("prec", [(8, 4), (40, 8), (48, 16), (100, 3)])
def test_cut_precision(prec):
    xs = [rng.randrange(1 << 200) for _ in range(4)]
    x = jfr.batch_to_limbs(xs)
    got = g.cut_precision(_t(x), *prec)
    _eq(got, jg.cut_precision(x, *prec))
    assert fr.batch_from_limbs(got) == [v >> (prec[0] - prec[1]) for v in xs]


def test_float_mult():
    n = 8
    xs = [int(6.5 * 2 ** n), int(2.25 * 2 ** n), rng.randrange(1 << 60)]
    ys = [int(2.0 * 2 ** n), int(0.5 * 2 ** n), rng.randrange(1 << 60)]
    a, b = jfr.batch_to_limbs(xs), jfr.batch_to_limbs(ys)
    got = g.float_mult(_t(a), _t(b), n)
    _eq(got, jg.float_mult(a, b, n))
    assert fr.batch_from_limbs(got) == [x * y // 2 ** n
                                        for x, y in zip(xs, ys)]
