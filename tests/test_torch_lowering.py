"""The port's R1CS gadgets (``circuit/bignum``, ``smt``, ``dates``,
``weierstrass``, ``ecdsa``) against the JAX package's, tolerance 0.

Each case builds the same circuit with both packages on the same seeded
inputs at batch 2 (``torch_lowering_pair``): the bignum product, modular
product, comparison and modexp (also against Python ints); the 80-level
SMT on paths with live levels; the date gadgets; ``ec_add`` and
``ec_double`` over p256 and brainpoolP256r1, and ``gen_mul`` over p256
(points also against ``ecdsa_ref``). Then the port's generator tables,
computed in memory, against the JAX package's committed
``ecdsa_gen_p256.npz`` and, on every curve of ``ops/curves``, against
``ecdsa_ref`` at four entries of four windows (the first two, one drawn,
the last), with no table file written.

The JAX package's generator mult is lowered over p256 only: on any other
curve its ``_gen_tables`` writes a table file into its own tree.
"""

import pathlib
import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu_torch.circuit import weierstrass as cw
from passport_zk_circuits_tpu_torch.ingest import identity
from passport_zk_circuits_tpu_torch.ops import curves
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)
from torch_lowering_pair import (BATCH, JAX, PORT, assert_equal_circuits,
                                 build_both, curve, mods)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONST_DIRS = (ROOT / JAX / "utils" / "constants",
              ROOT / PORT / "utils" / "constants")


def test_bignum_gadgets_equal_jax_and_ints():
    rng = random.Random(3)
    xs = [rng.getrandbits(256) for _ in range(BATCH)]
    ys = [rng.getrandbits(256) for _ in range(BATCH)]
    ms = [rng.getrandbits(255) | (1 << 255) | 1 for _ in range(BATCH)]
    vals = {}

    def make(pkg, b):
        cbn, = mods(pkg, "bignum")
        x, y, m = (cbn.from_input(b, v, 4) for v in (xs, ys, ms))
        z = cbn.mult(b, x, y)
        r = cbn.mod_mul(b, x, y, m, canonical=True)
        lt = cbn.lt(b, x, y)
        pw = cbn.pow_mod(b, x, 65537, m)
        low = cbn.from_bits(b, b.num2bits(x.limbs[0], cbn.W), xs, 1)
        k = cbn.constant(b, ms[0], 4)
        vals[pkg] = (z.vals, r.vals, lt.ints(), pw.vals, low.vals, k.vals)
        return [lt] + r.limbs

    assert_equal_circuits(build_both(make))
    z, r, lt, pw, low, k = vals[PORT]
    assert vals[PORT] == vals[JAX]
    assert z == [x * y for x, y in zip(xs, ys)]
    assert r == [x * y % m for x, y, m in zip(xs, ys, ms)]
    assert lt == [int(x < y) for x, y in zip(xs, ys)]
    assert pw == [pow(x, 65537, m) for x, m in zip(xs, ms)]
    assert low == [x % (1 << 64) for x in xs] and k == [ms[0]] * BATCH


def test_smt_gadget_equals_jax_at_depth_80_with_live_levels():
    rng = random.Random(80)
    keys = [rng.randrange(fr.P) for _ in range(BATCH)]
    values = [rng.randrange(fr.P) for _ in range(BATCH)]
    sibs = [identity.live_siblings(rng, n_live) for n_live in (5, 2)]
    roots = [identity.smt_root(k, v, s) for k, v, s in zip(keys, values,
                                                         sibs)]
    roots[1] = (roots[1] + 1) % fr.P                    # lane 1: wrong root
    verdicts = {}

    def make(pkg, b):
        csmt, = mods(pkg, "smt")
        ok = csmt.verify(b, b.input(roots, "root"), b.input(keys, "key"),
                         b.input(values, "value"),
                         [b.input([s[i] for s in sibs], f"branch{i}")
                          for i in range(80)])
        verdicts[pkg] = ok.ints()
        return [ok]

    built = build_both(make)
    assert_equal_circuits(built)
    assert verdicts[PORT] == verdicts[JAX] == [1, 0] == built[0][1][0]


def test_date_gadgets_equal_jax():
    enc = identity.enc_date
    firsts = [enc(b"900115"), enc(b"301231")]
    seconds = [enc(b"991231"), enc(b"250101")]
    current = [enc(b"250817")] * BATCH
    verdicts = {}

    def make(pkg, b):
        cdates, = mods(pkg, "dates")
        f, s, c = (b.input(v, "date") for v in (firsts, seconds, current))
        lt = cdates.encoded_date_is_less(b, f, s)
        ltn = cdates.encoded_date_is_less_normalized(b, f, s, c)
        verdicts[pkg] = (lt.ints(), ltn.ints())
        return [lt, ltn]

    assert_equal_circuits(build_both(make))
    # lane 1: 30 > 25, but 2025-01-01 is before today's 2025-08-17, so it
    # reads as 2125 against 2030 once normalized
    assert verdicts[PORT] == verdicts[JAX] == ([1, 0], [1, 1])


def _rand_points(cv, rng, n=BATCH):
    return [ecdsa_ref.scalar_mul(cv, rng.randrange(1, cv.n), (cv.gx, cv.gy))
            for _ in range(n)]


@pytest.mark.parametrize("name", ["p256", "brainpoolP256r1"])
def test_ec_add_and_double_equal_jax_and_ecdsa_ref(name):
    rng = random.Random(name)
    cv = curves.CURVES[name]
    p1s, p2s = _rand_points(cv, rng), _rand_points(cv, rng)
    pts = {}

    def make(pkg, b):
        w, = mods(pkg, "weierstrass")
        c = curve(pkg, name)
        p1, p2 = (w.input_point(b, [p[0] for p in ps], [p[1] for p in ps], c)
                  for ps in (p1s, p2s))
        s, d = w.ec_add(b, p1, p2, c), w.ec_double(b, p1, c)
        w.on_curve(b, s, c)
        pts[pkg] = (s.vals(), d.vals())
        return []

    assert_equal_circuits(build_both(make))
    assert pts[PORT] == pts[JAX] == (
        [ecdsa_ref._add(cv, p, q) for p, q in zip(p1s, p2s)],
        [ecdsa_ref._add(cv, p, p) for p in p1s])


def test_gen_mul_p256_equals_jax_and_ecdsa_ref():
    rng = random.Random(256)
    cv = curves.CURVES["p256"]
    ks = [rng.randrange(1, cv.n) for _ in range(BATCH)]
    pts = {}

    def make(pkg, b):
        w, cbn, ce = mods(pkg, "weierstrass", "bignum", "ecdsa")
        c = curve(pkg, "p256")
        bits = ce.scalar_bits(b, cbn.from_input(b, ks, w.k64(c)))
        pts[pkg] = w.remove_dummy(b, w.gen_mul(b, bits, c), c).vals()
        return []

    assert_equal_circuits(build_both(make))
    assert pts[PORT] == pts[JAX] == [
        ecdsa_ref.scalar_mul(cv, k, (cv.gx, cv.gy)) for k in ks]


def _gen_table_files():
    return sorted(p for d in CONST_DIRS for p in d.glob("ecdsa_gen_*.npz"))


def test_gen_table_p256_equals_the_jax_package_file():
    with np.load(CONST_DIRS[0] / "ecdsa_gen_p256.npz",
                 allow_pickle=True) as d:
        theirs = d["xy"]
    mine = cw._gen_tables("p256")
    assert mine.shape == theirs.shape == (32, 256, 2)
    assert mine.tolist() == theirs.tolist()


@pytest.mark.parametrize("name", list(curves.CURVES))
def test_gen_table_equals_ecdsa_ref_and_writes_no_file(name):
    files = _gen_table_files()
    cv = curves.CURVES[name]
    tbl = cw._gen_tables(name)
    assert _gen_table_files() == files
    nwin = cw.W * cw.k64(cv) // 8
    assert tbl.shape == (nwin, 256, 2)
    d0 = cw.dummy_point(name)
    rng = random.Random(name)
    for w in (0, 1, rng.randrange(2, nwin - 1), nwin - 1):
        for j in (0, 1, 255, rng.randrange(2, 255)):
            want = ecdsa_ref._add(cv, ecdsa_ref.scalar_mul(
                cv, j << (8 * w), (cv.gx, cv.gy)), d0)
            assert tuple(tbl[w, j]) == want, (w, j)
