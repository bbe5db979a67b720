"""The Groth16 prover's kernels on the card, K10 (ops/cuda_msm: the MSM
over G1 and G2) and K11 (ops/cuda_fixed_base: [s]G over G1 and G2), each
bit-equal to its plain PyTorch version on the same CUDA tensors (and to
the host's ints on small cases): mostly 0 and 1 scalars, N not a power of
two, all scalars zero, a masked infinity point, B = 2 lanes, G2, K10 at
every window width its schedule picks (8..16 bits) on points and on a
key's Montgomery words alone; 0, 1 and r - 1 for K11. Then Groth16 on
RegisterIdentityLight at its real size (batch 2): the Light forward on
the card gives the public values, the circuit (55,438 wires, 55,805
constraints) passes ``check_batched``, and
both lanes' proofs from ``setup`` (K11) and ``prove`` (K10) verify, while
a wrong public input fails. Needs a CUDA device and skips without one;
the Light prove is a whole-system test, so also slow. The machine with
the card has no JAX, so run it without the repository's conftest:

    python -m pytest tests/test_torch_cuda_prove.py --noconftest -q

On the CPU the same prove takes over an hour (plain PyTorch MSMs over
55,438 points); there the proving path is held to the JAX package on
small circuits (tests/test_torch_groth16.py), and K10's and K11's bodies
through a host build (tests/test_torch_msm_host.py).
"""

import random

import pytest
import torch

from passport_zk_circuits_tpu_torch.circuit import register_light
from passport_zk_circuits_tpu_torch.groth16 import protocol as g16
from passport_zk_circuits_tpu_torch.ingest import identity
from passport_zk_circuits_tpu_torch.models import register_identity_light as ril
from passport_zk_circuits_tpu_torch.groth16 import pairing as pr
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_fixed_base
from passport_zk_circuits_tpu_torch.ops import cuda_msm
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import g2
from passport_zk_circuits_tpu_torch.ops import msm
from passport_zk_circuits_tpu_torch.r1cs import system as r1

pytestmark = pytest.mark.cuda

OUTS = ("dg1_commitment", "pk_identity_hash", "dg1_hash")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (README)")
    return torch.device("cuda:0")


def _limbs(ints, dev):
    return bn.to_tensor(fr.batch_to_limbs(ints), dev)


def _scalars(rng, n, lanes, kind, dev):
    """(16, lanes, n): "skewed" mostly 0 and 1 (lane 0 all 1 but a few),
    "full" uniform below r with 0, 1 and r - 1 among them, "zero"."""
    def draw(lane):
        if kind == "zero":
            return 0
        if kind == "full":
            return rng.choice((0, 1, fr.P - 1, rng.randrange(fr.P),
                               rng.randrange(fr.P)))
        if lane == 0:
            return 1 if rng.random() < 0.98 else rng.randrange(fr.P)
        return rng.choice((0, 0, 1, 1, 1, 2, rng.randrange(1 << 20),
                           rng.randrange(fr.P)))
    return torch.stack([_limbs([draw(lane) for _ in range(n)], dev)
                        for lane in range(lanes)], 1)


def _points(rng, n, is_g2, dev):
    """n affine points [k]G of random k, made by the plain fixed-base
    mult on the card."""
    return cuda_fixed_base.mul_plain(
        _limbs([rng.randrange(1, fr.P) for _ in range(n)], dev), is_g2)


@pytest.mark.parametrize("n,kind", [(2000, "skewed"), (1531, "full"),
                                    (700, "zero")])
def test_k10_g1_equals_the_plain_msm(dev, n, kind):
    rng = random.Random(n)
    px, py = _points(rng, n, False, dev)
    sc = _scalars(rng, n, 2, kind, dev)
    if kind == "full":                       # point 3 infinity, masked
        px[:, 3] = py[:, 3] = sc[:, :, 3] = 0
    before = cuda_msm.msm_g1.launches
    got = cuda_msm.msm_g1(px, py, sc)
    assert cuda_msm.msm_g1.launches == before + 1
    want = msm.msm_affine(px, py, sc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "zero":
        assert not (got[0].any() or got[1].any())


def test_k10_g1_equals_host_ints_with_a_key_point_cache(dev):
    rng = random.Random(5)
    n = 97
    px, py = _points(rng, n, False, dev)
    sc = _scalars(rng, n, 2, "full", dev)
    mont = cuda_msm.points(px, py)
    assert torch.equal(mont, cuda_msm.points_plain(px, py, False))
    x, y = (t.cpu().numpy() for t in cuda_msm.msm_g1(px, py, sc, mont=mont))
    query = torch.stack([px, py]).cpu().numpy()
    want = g16._msm_lanes_host(query, sc.cpu().numpy(), 2, False)
    got = [None if not (x[:, i].any() or y[:, i].any()) else
           (bn.limbs_to_int(x[:, i]), bn.limbs_to_int(y[:, i]))
           for i in range(2)]
    assert got == want


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_k10_on_a_key_s_montgomery_points_alone(dev, is_g2):
    """A card's proving key keeps its points on the card only in
    Montgomery words (``ProvingKey.mont``); K10 given those alone equals
    the plain MSM on the affine limbs."""
    rng = random.Random(13)
    n = 257
    px, py = _points(rng, n, is_g2, dev)
    sc = _scalars(rng, n, 2, "full", dev)
    curve = "bn254_g2" if is_g2 else "bn254_g1"
    mont = cuda_msm.points(px, py, curve)
    got = cuda_msm.msm_affine(None, None, sc, curve, mont=mont)
    want = msm.msm_affine(px, py, sc, curve)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the plan's constants (ROUND_MIN_ADDS, GROUP) as K10 ships them, then
# forced so that every affine round runs, then so that rounds stop part
# way and the bucket tails and the reduction's groups go through several
# passes: the later rounds (each reading the one before from the other
# buffer) and the deep passes run only at the p256 shapes otherwise
PLANS = ((), ((("ROUND_MIN_ADDS", 1), ("GROUP", 2))),
         ((("ROUND_MIN_ADDS", 40), ("GROUP", 3))))


def _plans(monkeypatch):
    """Set each of PLANS in turn on cuda_msm (monkeypatch undoes them at
    the test's end), yielding it."""
    for plan in PLANS:
        for name, value in plan:
            monkeypatch.setattr(cuda_msm, name, value)
        yield plan


@pytest.mark.parametrize("c", range(cuda_msm.C_MIN, cuda_msm.C_MAX + 1))
def test_k10_g1_at_every_window_width(dev, monkeypatch, c):
    """K10 at each window width the schedule can pick (forced: 2^(c+3)
    points pick c), full-width and mostly 0 and 1 lanes, on the card's
    points and on the same points as a key's Montgomery words alone,
    against the plain MSM, with the plan as shipped and with its rounds,
    passes and groups forced deep (PLANS), and its first 40 points
    against the host's ints."""
    monkeypatch.setattr(cuda_msm, "window_bits", lambda n: c)
    rng = random.Random(200 + c)
    n = 1500
    px, py = _points(rng, n, False, dev)
    sc = torch.cat([_scalars(rng, n, 1, "full", dev),
                    _scalars(rng, n, 2, "skewed", dev)[:, 1:]], 1)
    want = msm.msm_affine(px, py, sc)
    mont = cuda_msm.points(px, py)
    for plan in _plans(monkeypatch):
        sched = cuda_msm.Schedule(sc, False)
        if plan:                     # the deep plans take effect
            assert sched.rounds >= 3
        for got in (cuda_msm.msm_g1(px, py, sc),
                    cuda_msm.msm_g1(None, None, sc, mont=mont)):
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1])
    m = 40
    x, y = (t.cpu().numpy() for t in cuda_msm.msm_g1(
        px[:, :m].contiguous(), py[:, :m].contiguous(),
        sc[..., :m].contiguous()))
    query = torch.stack([px[:, :m], py[:, :m]]).cpu().numpy()
    assert [None if not (x[:, i].any() or y[:, i].any()) else
            (bn.limbs_to_int(x[:, i]), bn.limbs_to_int(y[:, i]))
            for i in range(2)] == g16._msm_lanes_host(
                query, sc[..., :m].cpu().numpy(), 2, False)


@pytest.mark.parametrize("c", [8, 12, 16])
def test_k10_g2_at_window_widths(dev, monkeypatch, c):
    """K10 over G2 (an Fq2 element over two threads) at the narrowest,
    a middle and the widest window, against the plain MSM, on the points
    and on a key's Montgomery words alone, with the plan as shipped and
    forced deep (PLANS), and its first 8 points against the host's
    ints."""
    monkeypatch.setattr(cuda_msm, "window_bits", lambda n: c)
    rng = random.Random(300 + c)
    n = 300
    px, py = _points(rng, n, True, dev)
    sc = _scalars(rng, n, 2, "full" if c != 12 else "skewed", dev)
    want = msm.msm_affine(px, py, sc, "bn254_g2")
    mont = cuda_msm.points(px, py, "bn254_g2")
    for plan in _plans(monkeypatch):
        sched = cuda_msm.Schedule(sc, True)
        if plan:
            assert sched.rounds >= 3
        for got in (cuda_msm.msm_g2(px, py, sc),
                    cuda_msm.msm_g2(None, None, sc, mont=mont)):
            assert torch.equal(got[0], want[0]) and \
                torch.equal(got[1], want[1])
    m = 8
    small = cuda_msm.msm_g2(px[..., :m].contiguous(), py[..., :m].contiguous(),
                            sc[..., :m].contiguous())
    query = torch.stack([px[..., :m], py[..., :m]]).cpu().numpy()
    assert [g2.limbs_to_point(small[0][..., i], small[1][..., i])
            for i in range(2)] == g16._msm_lanes_host(
                query, sc[..., :m].cpu().numpy(), 2, True)


def test_k10_picks_its_width_from_the_point_count(dev):
    """On both sides of the switch at 2^12 points (8 and 9-bit windows),
    the width K10 picks itself, against the plain MSM."""
    rng = random.Random(4096)
    px, py = _points(rng, 4097, False, dev)
    sc = _scalars(rng, 4097, 2, "full", dev)
    for n in (4095, 4096):
        assert cuda_msm.Schedule(sc[..., :n], False).c == (8 if n < 4096
                                                           else 9)
        p, q, s = (t[..., :n].contiguous() for t in (px, py, sc))
        got, want = cuda_msm.msm_g1(p, q, s), msm.msm_affine(p, q, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k10_g2_equals_the_plain_msm_and_host_ints(dev):
    rng = random.Random(9)
    n = 301
    px, py = _points(rng, n, True, dev)
    sc = _scalars(rng, n, 2, "skewed", dev)
    got = cuda_msm.msm_g2(px, py, sc)
    want = msm.msm_affine(px, py, sc, "bn254_g2")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(cuda_msm.points(px, py, "bn254_g2"),
                       cuda_msm.points_plain(px, py, True))
    m = 12
    small = cuda_msm.msm_g2(px[..., :m], py[..., :m], sc[..., :m])
    query = torch.stack([px[..., :m], py[..., :m]]).cpu().numpy()
    assert [g2.limbs_to_point(small[0][..., i], small[1][..., i])
            for i in range(2)] == g16._msm_lanes_host(
                query, sc[..., :m].cpu().numpy(), 2, True)


@pytest.mark.parametrize("is_g2", [False, True], ids=["g1", "g2"])
def test_k11_equals_the_plain_fixed_base_and_host_ints(dev, is_g2):
    rng = random.Random(11)
    ss = [0, 1, fr.P - 1] + [rng.randrange(fr.P) for _ in range(1997)]
    sc = _limbs(ss, dev)
    fn = cuda_fixed_base.mul_g2 if is_g2 else cuda_fixed_base.mul_g1
    x, y = fn(sc)
    want = cuda_fixed_base.mul_plain(sc, is_g2)
    assert torch.equal(x, want[0]) and torch.equal(y, want[1])
    for i, s in enumerate(ss[:5]):
        if is_g2:
            assert g2.limbs_to_point(x[..., i], y[..., i]) == \
                pr.ec_mul(pr.G2, s)
        else:
            got = None if s == 0 else (bn.limbs_to_int(x[:, i]),
                                       bn.limbs_to_int(y[:, i]))
            assert got == (None if s == 0 else g16._g1_mul(s))


@pytest.mark.slow
def test_light_proofs_verify_on_the_card(dev):
    rng = random.Random(71)
    dg1s = [identity.make_dg1(rng, 3) for _ in range(2)]
    sks = [rng.randrange(1, fr.P) for _ in range(2)]
    out = ril.forward(identity.light_inputs(dg1s, sks, 256, dev), 256, 3)
    b, outs = register_light.build(dg1s, sks)
    pub = b.finalize([outs[k] for k in OUTS])
    assert (b.cs.n_vars, b.cs.n_constraints) == (55438, 55805)
    assert [fr.batch_from_limbs(out[k]) for k in OUTS] == pub
    w = bn.to_tensor(b.witness_matrix(), dev)
    ok, _ = r1.check_batched(b.cs, w)
    assert ok.tolist() == [True, True]
    counters = (cuda_msm.points, cuda_msm.msm_g1, cuda_msm.msm_g2,
                cuda_fixed_base.mul_g1, cuda_fixed_base.mul_g2)
    before = [f.launches for f in counters]
    pk, vk = g16.setup(b.cs, b.n_public, seed=5, device=dev)
    mid = [f.launches for f in counters]
    # on the card the key's points are Montgomery words only
    assert set(pk.mont) == set(g16.QUERIES)
    assert all(pk.queries[n][:2] == (None, None) for n in g16.QUERIES)
    proofs = g16.prove(pk, b.cs, w, seed=2)
    after = [f.launches for f in counters]
    # setup: K11 over G1 and G2 and the key's points converted (no MSM);
    # prove: K10 over G1 and G2 on those points (no conversion, no K11)
    assert [m > b_ for m, b_ in zip(mid, before)] == [True, False, False,
                                                       True, True]
    assert [a > m for a, m in zip(after, mid)] == [False, True, True,
                                                   False, False]
    lanes = [[pub[j][lane] for j in range(b.n_public)] for lane in range(2)]
    for lane in range(2):
        assert g16.verify(vk, proofs[lane], lanes[lane])
    wrong = [(lanes[1][0] + 1) % fr.P] + lanes[1][1:]
    assert not g16.verify(vk, proofs[1], wrong)
