"""The port's R1CS (``r1cs/system.py``) against the JAX package's and Python
ints, tolerance 0 (integer arithmetic).

``check_batched`` on the demo circuit of ``tests/test_groth16.py`` (a
good witness and a tampered one, every constraint's verdict),
``_sparse_matvec`` on a system with a row of 1,200 terms (live against the
JAX package and against Python ints), ``matrices`` and ``witness_matrix``
array for array, and a tampered wire failing exactly the rows whose
Python-int value it breaks.
"""

import pathlib
import random
import sys

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.r1cs import system as jr1
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.r1cs import system as r1

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import make_torch_port_fixtures as fx  # noqa: E402

CPU = torch.device("cpu")


def _demo(xs, ys):
    rows, _ = fx.demo_rows(xs, ys, fr.P)
    return (fx.demo_circuit(r1), fx.demo_circuit(jr1),
            r1.witness_matrix(rows, len(xs)), jr1.witness_matrix(rows, len(xs)))


def _row_values(cs, w_ints):
    """Python-int (A w, B w, C w) of every row, one lane."""
    out = []
    for mat in (cs.a, cs.b, cs.c):
        acc = [0] * cs.n_constraints
        for row, col, coeff in mat:
            acc[row] = (acc[row] + coeff * w_ints[col]) % fr.P
        out.append(acc)
    return out


def test_demo_check_batched_equals_jax():
    cs, jcs, w, jw = _demo([200, 7], [12345, fr.P - 3])
    assert np.array_equal(w, jw)
    for tampered in (False, True):
        if tampered:
            w = w.copy()
            w[1, 0, 1] ^= 1                      # lane 1's z off by one
        ok, per = r1.check_batched(cs, w, device=CPU)
        jok, jper = jr1.check_batched(jcs, w)
        assert ok.tolist() == np.asarray(jok).tolist() == [True, not tampered]
        assert np.array_equal(per.numpy(), np.asarray(jper))
        assert per.dtype == torch.bool and per.shape == (cs.n_constraints, 2)


def test_check_batched_row_chunks_equal_one_pass():
    cs, _, w, _ = _demo([3, 255], [9, 11])
    w[4, 0, 0] ^= 1                              # lane 0's y
    _, whole = r1.check_batched(cs, w, device=CPU)
    _, chunked = r1.check_batched(cs, w, row_chunk=3, device=CPU)
    assert torch.equal(whole, chunked)
    assert not whole[0, 0] and whole[:, 1].all()


def _wide_system(rng, n_vars=1500, n_rows=40, wide=1200):
    """Random triplets with row 7 of `wide` distinct terms."""
    cs = r1.ConstraintSystem(n_vars=n_vars)
    for row in range(n_rows):
        terms = wide if row == 7 else rng.randrange(0, 30)
        cols = rng.sample(range(n_vars), terms)
        for mat in (cs.a, cs.b, cs.c):
            mat.extend((row, c, rng.choice([1, fr.P - 1, rng.randrange(fr.P)]))
                       for c in cols)
    cs.n_constraints = n_rows
    return cs


def test_sparse_matvec_wide_row_equals_jax_and_ints():
    rng = random.Random(41)
    cs = _wide_system(rng)
    jcs = jr1.ConstraintSystem(n_vars=cs.n_vars, a=cs.a, b=cs.b, c=cs.c,
                               n_constraints=cs.n_constraints)
    vals = [[1] * 2] + [[rng.choice([0, 1, fr.P - 1, rng.randrange(fr.P)])
                         for _ in range(2)] for _ in range(cs.n_vars - 1)]
    w = r1.witness_matrix(vals, 2)
    for (rows, cols, coeffs), (jrows, jcols, jcoeffs) in zip(
            cs.matrices(), jcs.matrices()):
        assert np.array_equal(rows, jrows) and np.array_equal(cols, jcols)
        assert np.array_equal(coeffs, jcoeffs) and coeffs.dtype == jcoeffs.dtype
        got = r1._sparse_matvec(rows, cols, coeffs, bn.to_tensor(w, CPU),
                                cs.n_constraints)
        want = jr1._sparse_matvec(rows, cols, coeffs, w, cs.n_constraints)
        assert np.array_equal(got.numpy(), np.asarray(want))
    ints = [_row_values(cs, [v[lane] for v in vals]) for lane in range(2)]
    for m, (rows, cols, coeffs) in enumerate(cs.matrices()):
        got = r1._sparse_matvec(rows, cols, coeffs, bn.to_tensor(w, CPU),
                                cs.n_constraints)
        for lane in range(2):
            assert fr.batch_from_limbs(got[:, :, lane].T) == ints[lane][m]


def test_sparse_matvec_nnz_chunks_equal_one_pass(monkeypatch):
    rng = random.Random(42)
    cs = _wide_system(rng, n_vars=300, n_rows=12, wide=280)
    w = bn.to_tensor(r1.witness_matrix(
        [1] + [[rng.randrange(fr.P)] * 3 for _ in range(cs.n_vars - 1)], 3),
        CPU)
    rows, cols, coeffs = cs.matrices()[0]
    whole = r1._sparse_matvec(rows, cols, coeffs, w, cs.n_constraints)
    monkeypatch.setattr(r1, "_NNZ_CHUNK", 97)
    assert torch.equal(
        r1._sparse_matvec(rows, cols, coeffs, w, cs.n_constraints), whole)


def test_tampered_wire_fails_exactly_its_broken_rows():
    rng = random.Random(43)
    cs, _, w, _ = _demo([rng.randrange(256) for _ in range(2)],
                        [rng.randrange(fr.P) for _ in range(2)])
    wire = 3                                       # x: read by 3 + 8 rows
    w = w.copy()
    w[wire, :, 0] = fr.to_limbs(fr.from_limbs(w[wire, :, 0]) + 1)
    lane0 = [fr.from_limbs(w[i, :, 0]) for i in range(cs.n_vars)]
    az, bz, cz = _row_values(cs, lane0)
    want = [a * b % fr.P == c for a, b, c in zip(az, bz, cz)]
    ok, per = r1.check_batched(cs, w, device=CPU)
    assert per[:, 0].tolist() == want and not all(want)
    reading = {r for mat in (cs.a, cs.b, cs.c) for r, c, _ in mat
               if c == wire}
    assert {i for i, v in enumerate(want) if not v} <= reading
    assert per[:, 1].all() and ok.tolist() == [False, True]


def test_witness_matrix_equals_jax():
    rng = random.Random(44)
    vals = [1, [rng.randrange(fr.P) for _ in range(3)], 5,
            [0, 1, fr.P - 1]]
    got = r1.witness_matrix(vals, 3)
    want = jr1.witness_matrix(vals, 3)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_as_witness_places_arrays_and_keeps_tensors():
    a = np.zeros((2, 16, 1), np.uint32)
    assert r1.as_witness(a, CPU).dtype == torch.int64
    t = torch.zeros((2, 16, 1), dtype=torch.int64)
    assert r1.as_witness(t) is t


@pytest.mark.parametrize("n_con", [0, 1])
def test_check_batched_tiny_systems(n_con):
    cs = r1.ConstraintSystem()
    x = cs.new_var("x")
    if n_con:
        cs.enforce_bool(x)
    w = r1.witness_matrix([1, [0, 1]], 2)
    ok, per = r1.check_batched(cs, w, device=CPU)
    assert ok.tolist() == [True, True] and per.shape == (n_con, 2)
