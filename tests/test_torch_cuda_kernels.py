"""The hand-written kernels on the card, each against its plain
PyTorch version on the same CUDA tensors (bit for bit: tolerance 0), at
small and ragged batches, and the K9 probe battery probe by probe and in
one launch. Needs a CUDA device and skips without one. The machine with
the card has no JAX, so run these without the repository's conftest:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q
"""

import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu_torch.utils import babyjubjub_ref as bref
from passport_zk_circuits_tpu_torch.utils import poseidon_ref as pref
from passport_zk_circuits_tpu_torch.ops import babyjubjub as bjj
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_babyjubjub
from passport_zk_circuits_tpu_torch.ops import cuda_field
from passport_zk_circuits_tpu_torch.ops import cuda_loop
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import cuda_probe
from passport_zk_circuits_tpu_torch.ops import cuda_rsa
from passport_zk_circuits_tpu_torch.ops import cuda_sha2
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import smt

pytestmark = pytest.mark.cuda

rng = random.Random(7707)
B = 37                          # not a multiple of a block: ragged edge


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card (README)")
    return torch.device("cuda:0")


def _fr(dev, n=B):
    return bn.to_tensor(fr.batch_to_limbs(
        [rng.randrange(fr.P) for _ in range(n)]), dev)


def _same(a, b):
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("algo", [224, 256])
def test_sha_kernel(dev, nb, algo):
    words = torch.tensor(np.array([[rng.randrange(1 << 32) for _ in range(B)]
                                   for _ in range(16 * nb)]), device=dev)
    assert words.dtype == torch.int64 and (words >= 1 << 31).any()
    before = cuda_sha2.sha2_32_chunks.launches
    out = cuda_sha2.sha2_32_chunks(words, algo)
    assert cuda_sha2.sha2_32_chunks.launches == before + 1
    _same(out, cuda_sha2.sha2_32_chunks_plain(words, algo))


@pytest.mark.parametrize("n_lanes", [1, 33, 1024])
@pytest.mark.parametrize("nbs,algos", [
    ((3,), (224,)),                                   # a list of one
    ((2, 4, 2), (256, 256, 224)),                     # no dg15; SA SHA-224
    ((2, 3, 4, 2), (256, 256, 256, 256)),             # the flagship step
    ((1, 4, 0, 4), (224, 256, 256, 224))])            # ties, an empty one
def test_sha_many_kernel(dev, nbs, algos, n_lanes):
    """K1's many-message entry: one launch for the list, each digest
    bit-equal to the plain version, the per-message entry not launched."""
    g = np.random.default_rng(n_lanes + len(nbs))
    words = [torch.tensor(g.integers(0, 1 << 32, (16 * nb, n_lanes)),
                          device=dev) for nb in nbs]
    before = (cuda_sha2.sha2_32_chunks_many.launches,
              cuda_sha2.sha2_32_chunks.launches)
    out = cuda_sha2.sha2_32_chunks_many(words, algos)
    assert (cuda_sha2.sha2_32_chunks_many.launches,
            cuda_sha2.sha2_32_chunks.launches) == (before[0] + 1, before[1])
    want = cuda_sha2.sha2_32_chunks_many_plain(words, algos)
    assert [o.shape for o in out] == [(a // 32, n_lanes) for a in algos]
    for o, w in zip(out, want):
        _same(o, w)


def test_sha_empty_batch_launches_nothing(dev):
    """B = 0: both K1 entries return empty digests and, launching no
    kernel, leave their counters where they were."""
    words = torch.zeros((32, 0), dtype=torch.int64, device=dev)
    before = (cuda_sha2.sha2_32_chunks_many.launches,
              cuda_sha2.sha2_32_chunks.launches)
    out = cuda_sha2.sha2_32_chunks_many([words, words], [256, 224])
    one = cuda_sha2.sha2_32_chunks(words, 224)
    assert [o.shape for o in out] == [(8, 0), (7, 0)] and one.shape == (7, 0)
    assert (cuda_sha2.sha2_32_chunks_many.launches,
            cuda_sha2.sha2_32_chunks.launches) == before


E_RAND = random.Random(64).getrandbits(64) | 1 | (1 << 63)   # odd, 64 bits


def _rsa_batch(dev, k, n_lanes, even_lane=None):
    """n_lanes odd k-limb moduli with the top bit set (one made even);
    signatures 0, 1 and n - 1 in lanes 0-2 of a batch of three or more, the
    rest random below n."""
    mods = [rng.getrandbits(16 * k - 1) | (1 << (16 * k - 1)) | 1
            for _ in range(n_lanes)]
    if even_lane is not None:
        mods[even_lane] ^= 1
    sigs = [rng.randrange(m) for m in mods]
    if n_lanes >= 3:
        sigs[:3] = [0, 1, mods[2] - 1]
    args = [bn.to_tensor(a, dev) for a in (
        bn.ints_to_limbs_batch(sigs, k), bn.ints_to_limbs_batch(mods, k),
        bn.barrett_mu_batch(mods, k))]
    return sigs, mods, args


def _check_rsa(dev, k, exp, n_lanes, even_lane=None):
    sigs, mods, args = _rsa_batch(dev, k, n_lanes, even_lane)
    before = cuda_rsa.pow_mod.launches
    out = cuda_rsa.pow_mod(*args, exp)
    assert cuda_rsa.pow_mod.launches == before + 1
    _same(out, cuda_rsa.pow_mod_plain(*args, exp))
    assert bn.limbs_to_ints_batch(out) == \
        [pow(s, exp, m) for s, m in zip(sigs, mods)]


@pytest.mark.parametrize("exp", [3, 65537, 37187, E_RAND])
@pytest.mark.parametrize("k", [16, 32, 128, 192, 256, 308, 512])
def test_rsa_kernel(dev, k, exp):
    """Every k and exponent on 33 lanes (a ragged batch), sig 0, 1 and
    n - 1 among them and lane 7's modulus even (Barrett on one thread of
    its warp), against the plain version and Python pow; k = 192 is 96
    words, three a thread, k = 308 154 words, five a thread with the last
    outer step part-full and the top thread empty, and k = 512 (RSA-8192)
    the widest the kernel takes, eight a thread."""
    _check_rsa(dev, k, exp, 33, even_lane=7)


@pytest.mark.parametrize("n_lanes", [1, 33, 1024])
@pytest.mark.parametrize("k", [16, 32, 128, 192, 256])
def test_rsa_kernel_batch_sizes(dev, k, n_lanes):
    """B = 1, 33 and 1024 at e = 65537, the even lane in the larger
    batches."""
    _check_rsa(dev, k, 65537, n_lanes,
               even_lane=None if n_lanes == 1 else 3)


def test_rsa_kernel_even_modulus_alone_and_e1(dev):
    """A batch of one even-modulus lane; e = 1 gives sig back as it is,
    reduced or not, as bn.mod_pow does."""
    _check_rsa(dev, 128, 65537, 1, even_lane=0)
    sigs, mods, args = _rsa_batch(dev, 32, 5, even_lane=2)
    args[0][:, 4] = args[1][:, 4]                     # sig = n: not reduced
    out = cuda_rsa.pow_mod(*args, 1)
    _same(out, cuda_rsa.pow_mod_plain(*args, 1))
    _same(out, args[0])


@pytest.mark.parametrize("n_lanes", [1, 5, 1025])
@pytest.mark.parametrize("t", list(range(2, 18)))
def test_poseidon_kernel_every_width(dev, t, n_lanes):
    """Every width at B = 1, 5 and 1025 (the last warp partial for every
    number of lanes a warp), n_outs = t, against the plain version, and on
    three lanes against poseidon_ref."""
    inputs = torch.stack([_fr(dev, n_lanes) for _ in range(t - 1)], 1)
    before = cuda_poseidon.poseidon_ex.launches
    out = cuda_poseidon.poseidon_ex(inputs, t)
    assert cuda_poseidon.poseidon_ex.launches == before + 1
    _same(out, cuda_poseidon.poseidon_ex_plain(inputs, t))
    for i in range(min(n_lanes, 3)):
        ins = fr.batch_from_limbs(inputs[:, :, i])
        assert fr.batch_from_limbs(out[:, :, i]) == pref.poseidon_ex(ins, t)


def test_poseidon_kernel_initial_state_and_oracle(dev):
    cols = [[rng.randrange(fr.P) for _ in range(B)] for _ in range(2)]
    init = [rng.randrange(fr.P) for _ in range(B)]
    ins = [bn.to_tensor(fr.batch_to_limbs(c), dev) for c in cols]
    init_t = bn.to_tensor(fr.batch_to_limbs(init), dev)
    out = cuda_poseidon.poseidon_ex(ins, 3, init_t)
    _same(out, cuda_poseidon.poseidon_ex_plain(ins, 3, init_t))
    for j in range(3):
        assert fr.batch_from_limbs(out[:, j, :3]) == [
            pref.poseidon_ex([c[i] for c in cols], 3, init[i])[j]
            for i in range(3)]


def _smt_sibs(dev, profile, n=80):
    """(16, n, B) sibling paths, index 0 root-most. flagship: all zero (no
    live level); mixed: every third lane non-zero down to depths 1-29;
    full: every sibling but the topmost (zero in a proof) non-zero, 79 live
    levels of 80 (the deepest level holds the leaf), except lanes 0-3, one
    warp of the kernel, which mix 0, 1, 24 and 79 live levels."""
    sibs = torch.zeros((16, n, B), dtype=torch.int64, device=dev)
    if profile == "mixed":
        for lane in range(1, B, 3):
            depth = rng.randrange(1, 30)
            sibs[:, :depth, lane] = _fr(dev, depth)
    elif profile == "full":
        for lane in range(1, B):
            depth = {1: 1, 2: 24}.get(lane, n - 1)
            sibs[:, :depth, lane] = _fr(dev, depth)
    return sibs


@pytest.mark.parametrize("profile", ["flagship", "mixed", "full"])
def test_smt_climb_kernel(dev, profile):
    sibs = _smt_sibs(dev, profile)
    key, value = _fr(dev), _fr(dev)
    args = (*smt.climb_inputs(key, sibs), key, value)
    live = args[2].sum(0).tolist()
    if profile == "full":
        assert live[:4] == [0, 1, 24, 79] and set(live[4:]) == {79}
    before = cuda_poseidon.smt_climb.launches
    out = cuda_poseidon.smt_climb(*args)
    assert cuda_poseidon.smt_climb.launches == before + 1
    _same(out, cuda_poseidon.smt_climb_plain(*args))


@pytest.mark.parametrize("base8", [False, True])
def test_ladder_kernel(dev, base8):
    """Both K5 entries against their plain versions, with sk 0, 1 and P-1
    in lanes 0-2; any field elements as the base (same formulas), or
    Base8."""
    sk = _fr(dev)
    sk[:, :3] = bn.to_tensor(fr.batch_to_limbs([0, 1, fr.P - 1]), dev)
    bits = fr.to_bits(sk, 254)
    if base8:
        bx = fr.const(bjj.BASE8_X, (B,), dev)
        by = fr.const(bjj.BASE8_Y, (B,), dev)
    else:
        bx, by = _fr(dev), _fr(dev)
    for a, b in zip(cuda_babyjubjub.ladder(bits, bx, by),
                    cuda_babyjubjub.ladder_plain(bits, bx, by)):
        _same(a, b)
    before = cuda_babyjubjub.ladder_affine.launches
    aff = cuda_babyjubjub.ladder_affine(bits, bx, by)
    assert cuda_babyjubjub.ladder_affine.launches == before + 1
    for a, b in zip(aff, cuda_babyjubjub.ladder_affine_plain(bits, bx, by)):
        _same(a, b)
    if base8:
        got = list(zip(fr.batch_from_limbs(aff[0][:, :3]),
                       fr.batch_from_limbs(aff[1][:, :3])))
        assert got == [bref.base8_mul(s % (1 << 254))
                       for s in (0, 1, fr.P - 1)]


def test_scalar_mul_goes_through_ladder_affine(dev):
    sk = _fr(dev)
    before = (cuda_babyjubjub.ladder_affine.launches,
              cuda_babyjubjub.ladder.launches)
    x, y = bjj.base8_mul(sk)
    assert (cuda_babyjubjub.ladder_affine.launches,
            cuda_babyjubjub.ladder.launches) == (before[0] + 1, before[1])
    assert bool(bjj.on_curve(x, y).all())


def test_wrappers_reject_wrong_dtype(dev):
    words = torch.zeros((16, 4), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cuda_sha2.sha2_32_chunks(words)


def _wide(dev, n=B):
    """n lanes of 256-bit values, the first five 0, 1, P-1, P, 2^256-1."""
    xs = [0, 1, fr.P - 1, fr.P, (1 << 256) - 1]
    xs += [rng.getrandbits(256) for _ in range(n - len(xs))]
    return xs, bn.to_tensor(bn.ints_to_limbs_batch(xs, 16), dev)


@pytest.mark.parametrize("n_lanes", [1, 7, B, 1024, 1025])
@pytest.mark.parametrize("bcast", [False, True])
def test_field_mul_kernel(dev, bcast, n_lanes):
    """K6 (a lane on a team of threads, two products) against the plain
    product and Python ints on lanes 0, 1, P-1, P, 2^256-1 and random ones
    on both operands, with a team past the batch at odd B; broadcast: a
    (16, 1) column of each edge value and of a random one."""
    xs, a = _wide(dev, max(n_lanes, 5))
    ys, b = _wide(dev, max(n_lanes, 5))
    xs, a = xs[:n_lanes], a[:, :n_lanes].contiguous()
    ys, b = ys[::-1][:n_lanes], b.flip(1)[:, :n_lanes].contiguous()
    if bcast:
        cols = [([y] * n_lanes, bn.to_tensor(bn.ints_to_limbs_batch([y], 16),
                                             dev))
                for y in [0, 1, fr.P - 1, fr.P, (1 << 256) - 1, ys[0]]]
    else:
        cols = [(ys, b)]
    for ys, b in cols:
        before = cuda_field.mul.launches
        out = cuda_field.mul(a, b)
        assert cuda_field.mul.launches == before + 1
        _same(out, cuda_field.mul_plain(a, b))
        assert fr.batch_from_limbs(out) == \
            [x * y % fr.P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n_lanes", [1, B, 1024])
@pytest.mark.parametrize("n", [0, 1, 5, 256])
@pytest.mark.parametrize("bcast", [False, True])
def test_field_mul_chain_kernel(dev, n, bcast, n_lanes):
    """K7 (a lane's chain on a team of threads) against the plain chain and
    Python ints on lanes 0, 1, P-1, P, 2^256-1 and random ones, including a
    team past the batch (B = 1, 37) and the field-muls/s width (1024)."""
    xs, a = _wide(dev, max(n_lanes, 5))
    ys, c = _wide(dev, max(n_lanes, 5))
    xs, a = xs[:n_lanes], a[:, :n_lanes].contiguous()
    ys, c = ys[:n_lanes], c[:, :n_lanes].contiguous()
    if bcast:
        ys, c = [ys[-1]] * n_lanes, c[:, -1:].contiguous()
    before = cuda_field.mul_chain.launches
    out = cuda_field.mul_chain(a, c, n)
    assert cuda_field.mul_chain.launches == before + 1
    _same(out, cuda_field.mul_chain_plain(a, c, n))
    want = xs if n == 0 else [x * pow(y, n, fr.P) % fr.P
                              for x, y in zip(xs, ys)]
    assert bn.limbs_to_ints_batch(out) == want


@pytest.mark.parametrize("n_lanes", [1, 33, B, 1024, 1025])
@pytest.mark.parametrize("body", cuda_loop.BODIES)
def test_loop_kernel_every_body(dev, body, n_lanes):
    """Every K8 body against its plain version and, lane by lane, Python
    ints (body_ints), at batches whose last block, team or limb row is
    ragged."""
    a = torch.tensor(np.array([[rng.randrange(1 << 16)
                                for _ in range(n_lanes)]
                               for _ in range(16)]), device=dev)
    c = torch.tensor(np.array([[rng.randrange(1, 1 << 16)
                                for _ in range(n_lanes)]
                               for _ in range(16)]), device=dev)
    xs, cs = bn.limbs_to_ints_batch(a), bn.limbs_to_ints_batch(c)
    for n in (1, 7):
        before = cuda_loop.loop.launches
        out = cuda_loop.loop(body, a, c, n)
        assert cuda_loop.loop.launches == before + 1
        _same(out, cuda_loop.loop_plain(body, a, c, n))
        assert bn.limbs_to_ints_batch(out) == \
            [cuda_loop.body_ints(body, x, y, n) for x, y in zip(xs, cs)]


@pytest.mark.parametrize("name", cuda_probe.PROBES)
def test_probe(dev, name):
    cuda_probe.run(name, dev)


def _probe_inputs(dev):
    ins = {n: cuda_probe.inputs(n, dev) for n in cuda_probe.BATTERY}
    return ins, {n: cuda_probe.plain(n, *pair) for n, pair in ins.items()}


def test_probe_battery(dev):
    """The kernel probes in one launch: the battery's counter moves by one
    and the per-probe entry's not at all; every output bit-equal to its
    plain version."""
    ins, want = _probe_inputs(dev)
    before = (cuda_probe.battery.launches, cuda_probe.probe.launches)
    got = cuda_probe.battery(ins)
    assert (cuda_probe.battery.launches, cuda_probe.probe.launches) == (
        before[0] + 1, before[1])
    torch.cuda.synchronize()
    assert list(got) == list(cuda_probe.BATTERY)
    assert cuda_probe.mismatches(got, want) == []
    cuda_probe.run_battery(dev)


@pytest.mark.parametrize("name", cuda_probe.BATTERY)
def test_probe_battery_names_a_changed_input(dev, name):
    """One probe's input changed in the battery: only its output differs
    from the plain versions of the unchanged inputs, so a mismatch names
    its probe."""
    ins, want = _probe_inputs(dev)
    in0, in1 = ins[name]
    changed = in0.clone()
    changed.view(-1)[5] ^= 1
    ins[name] = (changed, in1)
    got = cuda_probe.battery(ins)
    torch.cuda.synchronize()
    assert cuda_probe.mismatches(got, want) == [name]
