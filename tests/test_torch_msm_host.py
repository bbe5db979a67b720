"""The Groth16 prover kernels' bodies (K10: csrc/msm.cuh, K11:
csrc/fixed_base.cuh) and the headers under them (csrc/fq_bn254.cuh,
csrc/bn254_curve.cuh), built for the host with g++ through
tests/torch_msm_host_check.cc, bit for bit (tolerance 0: integer
arithmetic):

* Fq and Fq2 mul, sqr, inv, add and sub at 0, 1, q - 1 and random values
  against Python ints and groth16/pairing's FQ2;
* the full and mixed additions and the doubling over G1 and G2, the
  operands in Jacobian form with Z != 1, at infinity on either side,
  P == Q and P == -Q, against groth16/pairing;
* K10's whole plan (``ops/cuda_msm.Schedule``, the glue, on CPU tensors,
  and ``execute``: the round, run, reduction and Horner bodies through the
  host build) against ``protocol._msm_lanes_host`` on a few hundred
  points, with a skewed sample of mostly 0 and 1 scalars, at every window
  width the schedule can pick (8..16 bits), with scalars whose signed
  digits carry into the top window (r - 1, 2^253 + small, digits of
  exactly 2^(c-1) and the carries around it), with the affine rounds, the
  runs' passes and the reduction's groups forced deep, on two lanes, over
  G1 and G2, and against the JAX package's MSM outputs in
  tests/fixtures/torch_port_prove_b2.npz;
* ``chip_smoke.msm_ops``, the least Pippenger work on an MSM's scalars
  (K10's bound), on hand-made scalars, never above the first design's
  count;
* K11's body against ``protocol._g1_mul`` and the fixture's ``fb_g2_*``;
* the K10 and K11 wrappers on CPU tensors (their plain versions);
* ``cuda_build.ptxas_report``'s names of K10's and K11's instances by
  their field (the register and spill check of chip_smoke.py).
"""

import ctypes
import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu_torch.groth16 import pairing as pr
from passport_zk_circuits_tpu_torch.groth16 import protocol as g16
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_build
from passport_zk_circuits_tpu_torch.ops import cuda_fixed_base
from passport_zk_circuits_tpu_torch.ops import cuda_msm
from passport_zk_circuits_tpu_torch.ops import g2
from passport_zk_circuits_tpu_torch.ops import msm

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_prove_b2.npz"
CPU = torch.device("cpu")
Q = pr.Q
_P64 = ctypes.POINTER(ctypes.c_int64)
ENTRIES = ("pzk_msm_points", "pzk_msm_round", "pzk_msm_sum",
           "pzk_msm_reduce", "pzk_msm_horner", "pzk_fixed_base")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    so = tmp_path_factory.mktemp("msm_host") / "libmsmhost.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
         "-I", str(ROOT / "passport_zk_circuits_tpu_torch" / "csrc"),
         "-o", str(so), str(ROOT / "tests" / "torch_msm_host_check.cc")],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name in ENTRIES:             # the card entries' argument types
        getattr(lib, name).argtypes = cuda_build._SIGNATURES[name]
    return lib


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as d:
        return dict(d)


def host_call(lib):
    """ops/cuda_msm.execute's call over the host build: CPU tensors by
    pointer, the stream argument None."""
    def call(entry, *args):
        assert getattr(lib, entry)(*(
            a.data_ptr() if torch.is_tensor(a) else a for a in args),
            None) == 0
    return call


def _ptr(a):
    return a.ctypes.data_as(_P64)


def _fq(v):
    return bn.int_to_limbs(v % Q, 16).astype(np.int64)


def _fq2(v):
    """pairing.FQ2 or an int -> (16, 2) limbs, limb-major."""
    v = v if hasattr(v, "coeffs") else pr.FQ2([v, 0])
    return g2.fq2_to_limbs(v).astype(np.int64)


def _from_fq2(a):
    return pr.FQ2([bn.limbs_to_int(a[:, 0]), bn.limbs_to_int(a[:, 1])])


rng = random.Random(1313)
FQ_EDGES = [0, 1, Q - 1, 2]


def test_fq_ops_edges_equal_ints(lib):
    xs = FQ_EDGES + [rng.randrange(Q) for _ in range(3)]
    for a in xs:
        for b in xs:
            for op, want in ((0, a * b % Q), (1, a * a % Q),
                             (2, pow(a, Q - 2, Q)), (3, (a + b) % Q),
                             (4, (a - b) % Q)):
                out = np.zeros(16, np.int64)
                assert lib.host_field_op(0, op, _ptr(_fq(a)), _ptr(_fq(b)),
                                         _ptr(out)) == 0
                assert bn.limbs_to_int(out) == want, (op, a, b)


def test_fq2_ops_edges_equal_pairing(lib):
    vals = [pr.FQ2([a, b]) for a in (0, 1, Q - 1) for b in (0, 1, Q - 1)]
    vals += [pr.FQ2([rng.randrange(Q), rng.randrange(Q)]) for _ in range(2)]
    zero = pr.FQ2([0, 0])
    for a in vals:
        for b in vals[::3]:
            inv = zero if a == zero else pr.FQ2([1, 0]) / a
            for op, want in ((0, a * b), (1, a * a), (2, inv), (3, a + b),
                             (4, a - b)):
                out = np.zeros((16, 2), np.int64)
                assert lib.host_field_op(1, op, _ptr(_fq2(a)), _ptr(_fq2(b)),
                                         _ptr(out)) == 0
                assert _from_fq2(out) == want, (op, a, b)


def _point_limbs(pt, is_g2):
    if pt is None:
        return np.zeros(64 if is_g2 else 32, np.int64)
    enc = _fq2 if is_g2 else (lambda v: _fq(int(v.coeffs[0])))
    return np.concatenate([enc(c).reshape(-1) for c in pt])


def _read_point(out, is_g2):
    if not out.any():
        return None
    if is_g2:
        return (_from_fq2(out[:32].reshape(16, 2)),
                _from_fq2(out[32:].reshape(16, 2)))
    return (pr.FQ1([bn.limbs_to_int(out[:16])]),
            pr.FQ1([bn.limbs_to_int(out[16:])]))


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_point_formulas_edges_equal_pairing(lib, is_g2):
    gen = pr.G2 if is_g2 else pr.G1
    P = pr.ec_mul(gen, rng.randrange(1, pr.R))
    Q_ = pr.ec_mul(gen, rng.randrange(1, pr.R))
    z = np.ascontiguousarray(_fq2(pr.FQ2([7, 3])) if is_g2 else _fq(7))
    cases = [(P, Q_), (P, P), (P, pr.ec_neg(P)), (None, Q_), (P, None),
             (None, None)]
    for a, b in cases:
        for op in (0, 1, 2):
            if op == 1 and b is None:
                continue                    # a mixed add's Q is never inf
            out = np.zeros(64 if is_g2 else 32, np.int64)
            assert lib.host_point_op(
                int(is_g2), op, _ptr(_point_limbs(a, is_g2)), int(a is None),
                _ptr(_point_limbs(b, is_g2)), int(b is None), _ptr(z),
                _ptr(out)) == 0
            want = pr.ec_double(a) if op == 2 and a is not None else (
                None if op == 2 else pr.ec_add(a, b))
            assert _read_point(out, is_g2) == want, (op, a is None, b is None)


def _g1_query(n, seed):
    r = random.Random(seed)
    return g16._g1_points_to_limbs(
        [g16._g1_mul(r.randrange(1, pr.R)) for _ in range(n)])[0]


def _scalars(r, n, lanes, skewed):
    """(16, lanes, n) limbs: full-width scalars, or a witness-like sample
    (mostly 0 and 1, a few small and full-width values)."""
    def draw():
        if skewed:
            return r.choice([0, 0, 1, 1, 1, 1, 2, r.randrange(1 << 20),
                             r.randrange(pr.R)])
        return r.choice([0, 1, pr.R - 1, r.randrange(pr.R),
                         r.randrange(pr.R)])
    return np.stack([bn.ints_to_limbs_batch([draw() for _ in range(n)], 16)
                     for _ in range(lanes)], axis=1).astype(np.int64)


def _host_points(x, y, lanes):
    return [None if not (x[:, i].any() or y[:, i].any()) else
            (bn.limbs_to_int(x[:, i]), bn.limbs_to_int(y[:, i]))
            for i in range(lanes)]


@pytest.mark.parametrize("n,skewed", [(300, False), (333, True)],
                         ids=["full-width", "skewed-0-1"])
def test_msm_plan_g1_equals_host_msm(lib, n, skewed):
    r = random.Random(n)
    q = _g1_query(n, n + 1)
    sc = _scalars(r, n, 2, skewed)
    if skewed:                  # one bucket over several runs and passes
        sc[:, 0, :] = 0
        sc[0, 0, :] = 1
    px, py = torch.from_numpy(q[0].astype(np.int64)), \
        torch.from_numpy(q[1].astype(np.int64))
    mont = torch.zeros((n, 16), dtype=torch.int32)
    host_call(lib)("pzk_msm_points", 0, px, py, n, mont)
    assert torch.equal(mont, cuda_msm.points_plain(px, py, False))
    x, y = cuda_msm.execute(cuda_msm.Schedule(torch.from_numpy(sc), False),
                            mont, host_call(lib))
    assert _host_points(x.numpy(), y.numpy(), 2) == \
        g16._msm_lanes_host(q, sc, 2, False)


def test_window_bits_switch_at_each_power_of_two():
    """c = log2(n) - 3, clamped to 8..16: the point counts on both sides of
    each switch."""
    assert cuda_msm.window_bits(1) == cuda_msm.window_bits(4095) == 8
    for c in range(cuda_msm.C_MIN + 1, cuda_msm.C_MAX + 1):
        assert cuda_msm.window_bits((1 << (c + 3)) - 1) == c - 1
        assert cuda_msm.window_bits(1 << (c + 3)) == c
    assert cuda_msm.window_bits((1 << 21) - 1) == cuda_msm.window_bits(
        1 << 30) == 16


def _edge_scalars(c):
    """Scalars whose signed c-bit digits reach the ends of their range and
    carry: r - 1, 2^253 + small, a digit of exactly 2^(c-1) (no carry),
    2^(c-1) + 1 (digit -(2^(c-1) - 1) and a carry), c-bit runs of ones (a
    carry through every window), every window 2^(c-1)."""
    half = 1 << (c - 1)
    every = sum(half << (c * w) for w in range(-(-255 // c))) % pr.R
    return [pr.R - 1, (1 << 253) + 5, half, half + 1, (half << c) + half - 1,
            (1 << (4 * c)) - 1, (1 << 252) - 1, every, 0, 1]


@pytest.mark.parametrize("c", range(cuda_msm.C_MIN, cuda_msm.C_MAX + 1))
def test_signed_digits_rebuild_the_scalar(c):
    r = random.Random(c)
    ss = _edge_scalars(c) + [r.randrange(pr.R) for _ in range(20)]
    sc = torch.from_numpy(bn.ints_to_limbs_batch(ss, 16).astype(np.int64))
    d = cuda_msm.signed_digits(sc[:, None], c)
    nwin = -(-255 // c)
    assert d.shape == (1, nwin, len(ss)) and d.dtype == torch.int32
    half = 1 << (c - 1)
    assert int(d.max()) <= half and int(d.min()) >= -(half - 1)
    got = [sum(int(d[0, w, j]) << (c * w) for w in range(nwin))
           for j in range(len(ss))]
    assert got == ss
    assert int(d[0, 0, 2]) == half and int(d[0, 0, 3]) == -(half - 1)


@pytest.mark.parametrize("c", range(cuda_msm.C_MIN, cuda_msm.C_MAX + 1))
def test_msm_plan_every_window_width(lib, monkeypatch, c):
    """The plan at each width the schedule can pick (forced here: the
    points it takes to pick 16 bits are too many for the host build), on
    the edge scalars and full-width ones, two lanes, against host ints."""
    monkeypatch.setattr(cuda_msm, "window_bits", lambda n: c)
    r = random.Random(100 + c)
    n = 24
    q = _g1_query(n, 7)
    lanes = [_edge_scalars(c) + [r.randrange(pr.R) for _ in range(n - 10)]]
    lanes.append([r.choice([0, 1, pr.R - 1, r.randrange(pr.R)])
                  for _ in range(n)])
    sc = np.stack([bn.ints_to_limbs_batch(v, 16) for v in lanes],
                  axis=1).astype(np.int64)
    px, py = (torch.from_numpy(t.astype(np.int64)) for t in q)
    sched = cuda_msm.Schedule(torch.from_numpy(sc), False)
    assert (sched.c, sched.nwin) == (c, -(-255 // c))
    x, y = cuda_msm.execute(sched, cuda_msm.points_plain(px, py, False),
                            host_call(lib))
    assert _host_points(x.numpy(), y.numpy(), 2) == \
        g16._msm_lanes_host(q, sc, 2, False)


@pytest.mark.parametrize("round_min,group", [(1, 2), (40, 3), (1 << 30, 1)],
                         ids=["all-rounds", "rounds-then-runs", "runs-only"])
def test_msm_plan_rounds_passes_and_groups(lib, monkeypatch, round_min,
                                           group):
    """A skewed sample (lane 0 all 1 but a few: one bucket of ~300 points)
    with the affine rounds run to the end, stopped part way, or only the
    first, so that the bucket's tail goes through several passes of runs;
    the reduction's groups cut small, joined in passes too."""
    monkeypatch.setattr(cuda_msm, "ROUND_MIN_ADDS", round_min)
    monkeypatch.setattr(cuda_msm, "GROUP", group)
    r = random.Random(round_min + group)
    n = 301
    q = _g1_query(n, 5)
    sc = _scalars(r, n, 2, True)
    sc[:, 0, :] = 0
    sc[0, 0, :] = 1
    sc[:, 0, :3] = bn.ints_to_limbs_batch([pr.R - 1, 2, 1 << 200], 16)
    px, py = (torch.from_numpy(t.astype(np.int64)) for t in q)
    sched = cuda_msm.Schedule(torch.from_numpy(sc), False)
    assert all(a.dtype == torch.int32 and a.is_contiguous()
               for _, args in sched.steps[:-1] for a in args
               if torch.is_tensor(a))          # the kernels' int32 words
    if round_min == 1:
        assert sched.rounds >= 9                    # ceil(log2(~300))
    else:
        assert sched.passes >= 4 and sched.rounds <= 3
    x, y = cuda_msm.execute(sched, cuda_msm.points_plain(px, py, False),
                            host_call(lib))
    assert _host_points(x.numpy(), y.numpy(), 2) == \
        g16._msm_lanes_host(q, sc, 2, False)


def test_msm_plan_g2_rounds_and_passes(lib, fx, monkeypatch):
    """G2: the fixture's points and scalars five times over (each bucket
    then holds its points five times: the tangent case of the affine
    rounds), the rounds and groups forced deep, 8-bit windows: five times
    the JAX package's MSM."""
    monkeypatch.setattr(cuda_msm, "ROUND_MIN_ADDS", 1)
    monkeypatch.setattr(cuda_msm, "GROUP", 2)
    px, py, sc = (torch.from_numpy(fx["msm_g2_" + k].astype(np.int64))
                  .repeat(1, 1, 5) for k in ("px", "py", "scalars"))
    sched = cuda_msm.Schedule(sc, True)
    assert sched.rounds >= 3 and sched.c == 8
    x, y = cuda_msm.execute(sched, cuda_msm.points_plain(px, py, True),
                            host_call(lib))
    for i in range(2):
        want = g2.limbs_to_point(fx["msm_g2_x"][..., i],
                                 fx["msm_g2_y"][..., i])
        assert g2.limbs_to_point(x[..., i], y[..., i]) == \
            (None if want is None else pr.ec_mul(want, 5))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_plan_equals_jax_fixture(lib, fx, curve):
    """The fixture's points hold zero scalars, an infinity entry (its
    scalar zeroed, as the prover masks it), a point beside its negation and
    a repeated point."""
    tag = f"msm_{curve}_"
    is_g2 = curve == "g2"
    px, py = (torch.from_numpy(fx[tag + k].astype(np.int64))
              for k in ("px", "py"))
    sc = torch.from_numpy(fx[tag + "scalars"].astype(np.int64))
    mont = cuda_msm.points_plain(px, py, is_g2)
    x, y = cuda_msm.execute(cuda_msm.Schedule(sc, is_g2), mont,
                            host_call(lib))
    assert np.array_equal(x.numpy(), fx[tag + "x"])
    assert np.array_equal(y.numpy(), fx[tag + "y"])


def test_msm_plan_zero_scalars_give_infinity(lib):
    q = _g1_query(5, 9)
    px, py = (torch.from_numpy(c.astype(np.int64)) for c in q)
    x, y = cuda_msm.execute(
        cuda_msm.Schedule(torch.zeros((16, 3, 5), dtype=torch.int64), False),
        cuda_msm.points_plain(px, py, False), host_call(lib))
    assert x.shape == (16, 3) and not (x.any() or y.any())


def test_msm_points_g2_equal_plain(lib):
    pts, _ = g2.points_to_limbs([pr.ec_mul(pr.G2, rng.randrange(1, pr.R))
                                 for _ in range(3)])
    px, py = (torch.from_numpy(c.astype(np.int64)) for c in pts)
    mont = torch.zeros((3, 32), dtype=torch.int32)
    host_call(lib)("pzk_msm_points", 1, px, py, 3, mont)
    assert torch.equal(mont, cuda_msm.points_plain(px, py, True))


def _fixed_base(lib, scalars, is_g2):
    sc = torch.from_numpy(np.ascontiguousarray(scalars, dtype=np.int64))
    b = sc.shape[1]
    coord = (16, 2) if is_g2 else (16,)
    x = torch.zeros(coord + (b,), dtype=torch.int64)
    y = torch.zeros_like(x)
    tbl = cuda_fixed_base.table("bn254_g2" if is_g2 else "bn254_g1", CPU)
    host_call(lib)("pzk_fixed_base", int(is_g2), sc, b, tbl, x, y)
    return x, y


def test_fixed_base_g1_equals_ints(lib):
    ss = [0, 1, 2, pr.R - 1] + [rng.randrange(pr.R) for _ in range(6)]
    x, y = _fixed_base(lib, bn.ints_to_limbs_batch(ss, 16), False)
    assert _host_points(x.numpy(), y.numpy(), len(ss)) == \
        [None if s == 0 else g16._g1_mul(s) for s in ss]


def test_fixed_base_g2_equals_jax_fixture(lib, fx):
    x, y = _fixed_base(lib, fx["fb_g2_scalars"], True)
    assert np.array_equal(x.numpy(), fx["fb_g2_x"])
    assert np.array_equal(y.numpy(), fx["fb_g2_y"])
    ss = [0, 1, pr.R - 1]
    x, y = _fixed_base(lib, bn.ints_to_limbs_batch(ss, 16), True)
    assert [g2.limbs_to_point(x[..., i], y[..., i]) for i in range(3)] == \
        [None if s == 0 else pr.ec_mul(pr.G2, s) for s in ss]


def test_wrappers_take_the_plain_versions_on_the_cpu(fx):
    px, py = (torch.from_numpy(fx["msm_g1_" + k].astype(np.int64))
              for k in ("px", "py"))
    sc = torch.from_numpy(fx["msm_g1_scalars"].astype(np.int64))
    before = cuda_msm.msm_g1.launches
    x, y = cuda_msm.msm_affine(px, py, sc)
    assert np.array_equal(x.numpy(), fx["msm_g1_x"])
    want = msm.msm_affine(px, py, sc)
    assert torch.equal(x, want[0]) and torch.equal(y, want[1])
    ss = bn.to_tensor(bn.ints_to_limbs_batch([0, 5, pr.R - 1], 16), CPU)
    x, y = cuda_fixed_base.mul_g2(ss)
    assert [g2.limbs_to_point(x[..., i], y[..., i]) for i in range(3)] == \
        [None] + [pr.ec_mul(pr.G2, s) for s in (5, pr.R - 1)]
    assert cuda_msm.msm_g1.launches == before
    assert cuda_fixed_base.mul_g2.launches == 0


def test_msm_needs_its_points_off_a_card(fx):
    """Only a CUDA call may give K10 a key's Montgomery points alone: the
    plain version needs the affine limbs, so a CPU call without them
    raises."""
    px, py = (torch.from_numpy(fx["msm_g1_" + k].astype(np.int64))
              for k in ("px", "py"))
    sc = torch.from_numpy(fx["msm_g1_scalars"].astype(np.int64))
    mont = cuda_msm.points(px, py)
    with pytest.raises(ValueError, match="px and py are needed"):
        cuda_msm.msm_g1(None, None, sc, mont=mont)
    x, y = cuda_msm.msm_g1(px, py, sc, mont=mont)
    assert np.array_equal(x.numpy(), fx["msm_g1_x"])
    assert np.array_equal(y.numpy(), fx["msm_g1_y"])


def test_schedule_refuses_what_its_int32_plan_cannot_hold(monkeypatch):
    """The plan's index arrays are int32, the kernels' words: an MSM of
    more than MAX_ITEMS non-zero digits over its lanes (4 of them must fit
    an int32), or of more than 2^31 buckets, raises instead of wrapping;
    one at the limit plans."""
    assert 4 * cuda_msm.MAX_ITEMS <= 1 << 31
    sc = torch.from_numpy(bn.ints_to_limbs_batch([1, 2, 3, 0, 5], 16)
                          .astype(np.int64))[:, None].repeat(1, 2, 1)
    monkeypatch.setattr(cuda_msm, "MAX_ITEMS", 8)   # 4 digits a lane
    assert cuda_msm.Schedule(sc, False).items == 8
    monkeypatch.setattr(cuda_msm, "MAX_ITEMS", 7)
    with pytest.raises(ValueError, match="split the lanes"):
        cuda_msm.Schedule(sc, False)
    monkeypatch.setattr(cuda_msm, "window_bits", lambda n: 16)
    many = torch.zeros((16, 4097, 1), dtype=torch.int64)  # 4097 * 2^19
    with pytest.raises(ValueError, match="split the lanes"):
        cuda_msm.Schedule(many, False)
    assert cuda_msm.Schedule(many[:, :4096], False).items == 0


def _least_work(lanes, is_g2, e):
    """msm_ops's count over Python ints: the least over widths 4..20 and
    unsigned or signed digits of the bucket adds (items less non-empty
    buckets), the running sums and the Horner chains."""
    best = None
    for c in range(4, 21):
        for signed in (False, True):
            half, ops = 1 << (c - 1), 0
            for ss in lanes:
                nwin = -(-(255 if signed else 254) // c)
                digits = [[0] * nwin for _ in ss]
                for j, s in enumerate(ss):
                    carry = 0
                    for w in range(nwin):
                        d = ((s >> (c * w)) & ((1 << c) - 1)) + carry
                        carry = int(signed and d > half)
                        digits[j][w] = d - (carry << c)
                live = []
                for w in range(nwin):
                    mags = [abs(dj[w]) for dj in digits if dj[w]]
                    ops += (len(mags) - len(set(mags))) * min(
                        e["madd"], e["batch_add"])
                    ops += 2 * max(max(mags, default=1) - 1, 0) * e["add"]
                    live.append(bool(mags))
                if any(live):
                    top = max(w for w in range(nwin) if live[w])
                    ops += (top * c * e["dbl"] + (sum(live) - 1) * e["add"]
                            + e["affine"])
            best = ops if best is None else min(best, ops)
    return best


@pytest.mark.parametrize("kind", ["zero", "one-point", "mostly-0-1",
                                  "uniform"])
def test_msm_ops_counts_the_least_pippenger_work(kind):
    """chip_smoke.msm_ops (K10's bound): on hand-made scalars over two
    lanes, the least work over window widths and digit signs counted again
    over Python ints, never above the first design's count (16-bit
    unsigned windows, msm_ops_16bit)."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    r = random.Random(kind)
    n = 40

    def draw(j):
        if kind == "zero":
            return 0
        if kind == "one-point":
            return 0 if j != 7 else r.randrange(pr.R)
        if kind == "mostly-0-1":
            return r.choice([0, 0, 1, 1, 1, 2, r.randrange(pr.R)])
        return r.randrange(pr.R)
    lanes = [[draw(j) for j in range(n)] for _ in range(2)]
    sc = torch.from_numpy(np.stack([bn.ints_to_limbs_batch(v, 16)
                                    for v in lanes], 1).astype(np.int64))
    for is_g2 in (False, True):
        e = cs.EC_OPS[is_g2]
        got = cs.msm_ops(sc, is_g2)
        assert got == _least_work(lanes, is_g2, e)
        assert got <= cs.msm_ops_16bit(sc, is_g2)
        if kind == "zero":
            assert got == 0
        if kind == "one-point":        # the zero scalars cost nothing
            assert got == cs.msm_ops(sc[..., 5:10], is_g2)
    one = torch.from_numpy(bn.ints_to_limbs_batch([1], 16).astype(np.int64))
    assert cs.msm_ops(one, False) == cs.EC_OPS[False]["affine"]


def test_ptxas_report_names_the_prover_kernels_by_field():
    """chip_smoke.py's register and spill check reads K10's and K11's
    instances by their template argument (fq::F1, fq::F2): the names come
    from the mangled entries of nvcc's -Xptxas -v report."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z14msm_sum_kernelIN2fq2F2EEvPKjPKlS5_S5_S5_lPj' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z14msm_sum_kernelIN2fq2F2EEvPKjPKlS5_S5_S5_lPj",
        "    164 bytes stack frame, 164 bytes spill stores, 184 bytes spill "
        "loads",
        "ptxas info    : Used 255 registers, 420 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z17fixed_base_kernelIN2fq2F1EEvPKllPKjPlS5_' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z17fixed_base_kernelIN2fq2F1EEvPKllPKjPlS5_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z15poseidon_kernelILi6EEvPKlPKjPll' for 'sm_90a'",
        "ptxas info    : Used 90 registers, 400 bytes cmem[0]"])
    assert cuda_build.ptxas_report(log) == {
        "msm_sum_kernel<fq::F2>": (255, 164, 184),
        "fixed_base_kernel<fq::F1>": (128, 0, 0),
        "poseidon_kernel<6>": (90, 0, 0)}
    assert cuda_build.kernel_name(
        "_Z16loop_limb_kernelIN5loopb9U32MulAddEEvPKlS3_Plii") == \
        "loop_limb_kernel<loopb::U32MulAdd>"
