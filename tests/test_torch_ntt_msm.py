"""The port's NTT, MSM, G2 and curve formulas against the JAX package and
Python ints, tolerance 0 (integer arithmetic).

Live against the JAX package: ``root_of_unity``, the twiddles, the bit-
reverse index and ``ntt``/``intt`` at n = 8 and 64 (also against Python
ints). Through ``tests/fixtures/torch_port_prove_b2.npz`` (written by
``tools/make_torch_port_fixtures.py prove``: the JAX functions compile
with jit there): ``ntt``/``intt`` at n = 1024, ``msm.msm_affine`` on G1 (N
= 16) and G2 (N = 8) points with zero scalars, an infinity entry, a point
beside its negation and a repeated point, and ``g2.fixed_base_mul``. Port
only: the MSM against the host-int MSM with window groups and odd point
counts, the fixed-base mults against Python ints, and the unified addition
over G1 and G2 at P == Q, P == -Q and infinity, through the ctx's zero
test.
"""

import pathlib
import random

import jax
import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import ntt as jntt
from passport_zk_circuits_tpu_torch.groth16 import pairing as pr
from passport_zk_circuits_tpu_torch.groth16 import protocol as g16
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import g2
from passport_zk_circuits_tpu_torch.ops import msm
from passport_zk_circuits_tpu_torch.ops import ntt
from passport_zk_circuits_tpu_torch.ops import weierstrass as wst

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

CPU = torch.device("cpu")
FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_port_prove_b2.npz")


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as d:
        return dict(d)


def _t(a):
    return bn.to_tensor(a, CPU)


@pytest.mark.parametrize("log_n", [0, 1, 3, 6, 10])
def test_roots_twiddles_bit_reverse_equal_jax(log_n):
    assert ntt.root_of_unity(log_n) == jntt.root_of_unity(log_n)
    mine, theirs = ntt._twiddles(log_n, False), jntt._twiddles(log_n, False)
    assert len(mine) == len(theirs) == log_n
    for inverse in (False, True):
        for a, b in zip(ntt._twiddles(log_n, inverse),
                        jntt._twiddles(log_n, inverse)):
            assert np.array_equal(a, b)
    assert np.array_equal(ntt._bit_reverse(log_n), jntt._bit_reverse(log_n))


def _ntt_case(got, vals, n):
    """The forward transform against Python ints, lane 1: every bin for
    n <= 64, four bins otherwise; intt(ntt(a)) == a."""
    w = ntt.root_of_unity(n.bit_length() - 1)
    lane = [v[1] for v in vals]
    bins = range(n) if n <= 64 else (0, 1, n // 2 - 1, n - 1)
    for k in bins:
        assert fr.from_limbs(got[:, k, 1]) == sum(
            v * pow(w, j * k, fr.P) for j, v in enumerate(lane)) % fr.P


@pytest.mark.parametrize("n", [8, 64])
def test_ntt_intt_equal_jax_and_ints(n):
    rng = random.Random(n)
    vals = [[rng.choice([0, 1, fr.P - 1, rng.randrange(fr.P)])
             for _ in range(2)] for _ in range(n)]
    a = np.stack([fr.batch_to_limbs(v) for v in vals], axis=1)  # (16, n, 2)
    got = ntt.ntt(_t(a))
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(jntt.ntt)(a)))
    back = ntt.intt(got)
    assert np.array_equal(back.numpy(), np.asarray(jax.jit(jntt.intt)(
        got.numpy().astype(np.uint32))))
    assert torch.equal(back, _t(a))
    _ntt_case(got, vals, n)


def test_ntt_1024_equals_jax_fixture_and_ints(fx):
    a = fx["ntt_1024_in"]
    got = ntt.ntt(_t(a))
    assert np.array_equal(got.numpy(), fx["ntt_1024_out"])
    back = ntt.intt(got)
    assert np.array_equal(back.numpy(), fx["intt_1024_out"])
    assert np.array_equal(back.numpy(), a)
    vals = [bn.limbs_to_ints_batch(a[:, j]) for j in range(1024)]
    _ntt_case(got, vals, 1024)


def test_poly_mul_ntt_is_the_cyclic_product():
    rng = random.Random(3)
    n = 8
    xs = [rng.randrange(fr.P) for _ in range(n)]
    ys = [rng.randrange(fr.P) for _ in range(n)]
    got = ntt.poly_mul_ntt(_t(fr.batch_to_limbs(xs)),
                           _t(fr.batch_to_limbs(ys)))
    want = [sum(xs[i] * ys[(k - i) % n] for i in range(n)) % fr.P
            for k in range(n)]
    assert fr.batch_from_limbs(got) == want


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_equals_jax_fixture(fx, curve):
    tag = f"msm_{curve}_"
    name = "bn254_g2" if curve == "g2" else "bn254_g1"
    x, y = msm.msm_affine(_t(fx[tag + "px"]), _t(fx[tag + "py"]),
                          _t(fx[tag + "scalars"]), name)
    assert np.array_equal(x.numpy(), fx[tag + "x"])
    assert np.array_equal(y.numpy(), fx[tag + "y"])
    # lane 1: P with -P and a point twice
    sc = fx[tag + "scalars"]
    assert not (sc[:, :, -1].any() or sc[:, 0, 2].any())


def _g1_points(rng, n):
    pts = [g16._g1_mul(rng.randrange(1, pr.R)) for _ in range(n)]
    return g16._g1_points_to_limbs(pts)[0]


@pytest.mark.parametrize("n,budget", [(13, 40), (6, 3)])
def test_msm_g1_equals_host_msm(n, budget, monkeypatch):
    monkeypatch.setitem(msm.BUDGET, "bn254_g1", budget)
    rng = random.Random(n * 7 + budget)
    q = _g1_points(rng, n)
    sc = np.stack([bn.ints_to_limbs_batch(
        [rng.choice([0, 1, pr.R - 1, rng.randrange(pr.R)]) for _ in range(n)],
        16) for _ in range(2)], axis=1)                  # (16, 2, n)
    x, y = msm.msm_affine(_t(q[0]), _t(q[1]), _t(sc))
    got = [None if not (x[:, i].any() or y[:, i].any()) else
           (bn.limbs_to_int(x[:, i]), bn.limbs_to_int(y[:, i]))
           for i in range(2)]
    assert got == g16._msm_lanes_host(q, sc, 2, False)


def test_msm_g2_equals_host_msm_in_window_groups(monkeypatch):
    monkeypatch.setitem(msm.BUDGET, "bn254_g2", 20)
    rng = random.Random(5)
    n = 5
    q, _ = g2.points_to_limbs([pr.ec_mul(pr.G2, rng.randrange(1, pr.R))
                               for _ in range(n)])
    sc = np.stack([bn.ints_to_limbs_batch(
        [rng.randrange(pr.R) for _ in range(n)], 16)], axis=1)  # (16, 1, n)
    x, y = msm.msm_affine(_t(q[0]), _t(q[1]), _t(sc), "bn254_g2")
    assert g2.limbs_to_point(x[..., 0], y[..., 0]) == \
        g16._msm_lanes_host(q, sc, 1, True)[0]


def test_msm_g2_table_in_chunks_equals_host_msm(monkeypatch):
    # a budget of 2 points: the table of 5 points is built in 3 chunks,
    # each window group is one window
    monkeypatch.setitem(msm.BUDGET, "bn254_g2", 2)
    rng = random.Random(8)
    n = 5
    q, _ = g2.points_to_limbs([pr.ec_mul(pr.G2, rng.randrange(1, pr.R))
                               for _ in range(n)])
    sc = np.stack([bn.ints_to_limbs_batch(
        [rng.randrange(pr.R) for _ in range(n)], 16)], axis=1)  # (16, 1, n)
    x, y = msm.msm_affine(_t(q[0]), _t(q[1]), _t(sc), "bn254_g2")
    assert g2.limbs_to_point(x[..., 0], y[..., 0]) == \
        g16._msm_lanes_host(q, sc, 1, True)[0]


def test_fixed_base_g1_equals_ints():
    rng = random.Random(6)
    ss = [rng.randrange(pr.R) for _ in range(6)] + [1, 2, pr.R - 1]
    c = wst.ctx("bn254_g1")
    x, y = wst.to_affine(c, wst.fixed_base_mul(
        c, _t(bn.ints_to_limbs_batch(ss + [0], c.kn))))
    got = [(bn.limbs_to_int(x[:, i]), bn.limbs_to_int(y[:, i]))
           for i in range(len(ss))]
    assert got == [g16._g1_mul(s) for s in ss]
    assert not (x[:, -1].any() or y[:, -1].any())          # 0 -> infinity


def test_fixed_base_g2_equals_jax_fixture_and_pairing(fx):
    x, y = g2.to_affine(g2.fixed_base_mul(_t(fx["fb_g2_scalars"])))
    assert np.array_equal(x.numpy(), fx["fb_g2_x"])
    assert np.array_equal(y.numpy(), fx["fb_g2_y"])
    ss = bn.limbs_to_ints_batch(fx["fb_g2_scalars"])
    assert [g2.limbs_to_point(x[..., i], y[..., i]) for i in range(len(ss))] \
        == [pr.ec_mul(pr.G2, s) for s in ss]


def _jac(c, pts, to_limbs):
    """Host affine points (None = infinity) -> a Jacobian point tensor,
    each scaled by its own Z = 3 + i so no input is already affine."""
    xs, ys, zs, inf = [], [], [], []
    for i, pt in enumerate(pts):
        if pt is None:
            xs.append(1), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append(3 + i)
    tx = to_limbs(xs)
    ty = to_limbs(ys)
    tz = to_limbs(zs)
    z2 = c.mul(tz, tz)
    return c.stack(c.mul(tx, z2), c.mul(ty, c.mul(z2, tz)), tz)


def _g2_limbs(vals):
    """FQ2 values or ints (as (v, 0)) -> (k, 2, n) limbs."""
    cols = [g2.fq2_to_limbs(v if hasattr(v, "coeffs") else pr.FQ2([v, 0]))
            for v in vals]
    return _t(np.stack(cols, axis=-1))


def test_g2_jac_add_doubling_inverse_and_infinity():
    rng = random.Random(7)
    c = g2.ctx()
    p, q = (pr.ec_mul(pr.G2, rng.randrange(1, pr.R)) for _ in range(2))
    cases = [(p, q), (p, p), (p, pr.ec_neg(p)), (None, q), (p, None),
             (None, None)]
    P = _jac(c, [a for a, _ in cases], _g2_limbs)
    Q = _jac(c, [b for _, b in cases], _g2_limbs)
    x, y = wst.to_affine(c, wst.jac_add(c, P, Q))
    got = [g2.limbs_to_point(x[..., i], y[..., i]) for i in range(len(cases))]
    assert got == [pr.ec_add(a, b) for a, b in cases]
    assert wst.is_inf(c, wst.jac_add(c, P, Q)).tolist() == \
        [False, False, True, False, False, True]
    x2, y2 = wst.to_affine(c, wst.jac_double(c, P))
    assert [g2.limbs_to_point(x2[..., i], y2[..., i])
            for i in range(len(cases))] == [pr.ec_double(a) for a, _ in cases]


def test_g1_jac_add_doubling_inverse_and_infinity():
    rng = random.Random(8)
    c = wst.ctx("bn254_g1")
    p, q = (g16._g1_mul(rng.randrange(1, pr.R)) for _ in range(2))
    neg = (p[0], (g16._Q - p[1]) % g16._Q)
    cases = [(p, q), (p, p), (p, neg), (None, q), (p, None), (None, None)]

    def limbs(vals):
        return _t(bn.ints_to_limbs_batch(vals, c.k))

    P = _jac(c, [a for a, _ in cases], limbs)
    Q = _jac(c, [b for _, b in cases], limbs)
    x, y = wst.to_affine(c, wst.jac_add(c, P, Q))
    got = [None if not (x[:, i].any() or y[:, i].any()) else
           (bn.limbs_to_int(x[:, i]), bn.limbs_to_int(y[:, i]))
           for i in range(len(cases))]
    assert got == [g16._g1_add_int(a, b) for a, b in cases]


def test_fq2_field_ops_equal_pairing():
    rng = random.Random(9)
    c = g2.ctx()
    xs = [pr.FQ2([rng.randrange(g2.Q), rng.randrange(g2.Q)]) for _ in range(4)]
    ys = [pr.FQ2([rng.randrange(g2.Q), rng.randrange(g2.Q)]) for _ in range(3)]
    ys.append(pr.FQ2([0, 0]))
    X, Y = _g2_limbs(xs), _g2_limbs(ys)

    def back(t):
        return [g2.limbs_to_fq2(t[..., i]) for i in range(t.shape[-1])]

    assert back(c.mul(X, Y)) == [a * b for a, b in zip(xs, ys)]
    assert back(c.sqr(X)) == [a * a for a in xs]
    assert back(c.add(X, Y)) == [a + b for a, b in zip(xs, ys)]
    assert back(c.sub(X, Y)) == [a - b for a, b in zip(xs, ys)]
    assert back(c.inv(Y))[:3] == [pr.FQ2([1, 0]) / b for b in ys[:3]]
    assert back(c.inv(Y))[3] == pr.FQ2([0, 0])               # inv(0) = 0
    three = c.const_like(3, X)                               # broadcasts
    assert back(c.mul(X, three)) == [a * 3 for a in xs]
    assert c.is_zero_f(c.sub(X, X)).tolist() == [True] * 4


@pytest.mark.parametrize("m", [pr.Q, pr.R, (1 << 253) + 39])
def test_static_mod_at_bn254_moduli_equals_ints(m):
    rng = random.Random(m % 1000)
    f = bn.StaticMod(m, 16)
    xs = [rng.randrange(m) for _ in range(300)] + [0, 1, m - 1, m - 1, m - 2]
    ys = [rng.randrange(m) for _ in range(300)] + [m - 1, m - 1, m - 1, 1, m - 2]
    X, Y = _t(bn.ints_to_limbs_batch(xs, 16)), _t(bn.ints_to_limbs_batch(ys, 16))
    assert bn.limbs_to_ints_batch(f.mul(X, Y)) == [a * b % m
                                                   for a, b in zip(xs, ys)]
    assert bn.limbs_to_ints_batch(f.add(X, Y)) == [(a + b) % m
                                                   for a, b in zip(xs, ys)]
    assert bn.limbs_to_ints_batch(f.sub(X, Y)) == [(a - b) % m
                                                   for a, b in zip(xs, ys)]
    with pytest.raises(ValueError):
        bn.StaticMod((1 << 252) + 1, 16)
