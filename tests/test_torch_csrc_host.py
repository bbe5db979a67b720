"""The CUDA kernels' per-lane arithmetic, compiled for the host with g++.

The headers under passport_zk_circuits_tpu_torch/csrc/ are __host__
__device__ and free of CUDA intrinsics, so g++ builds them (through
tests/torch_csrc_host_check.cc) into a small host library. Each check here
holds one piece of kernel arithmetic against the port's plain PyTorch
version and the Python-int oracle, bit for bit (tolerance 0: everything is
integer arithmetic). The code that splits a lane over several threads,
joined by shuffles and ballots, runs here with those threads as coroutines
that take turns at every exchange: the team arithmetic of fr_team.cuh (K4,
K5: eight threads a lane), K3's split permutation (warp.cuh groups of 2 to
32 threads), K6's product and K7's chain on a team of 8 / W threads and
K2's Montgomery modexp across a warp (32 threads). K1's many-message entry
runs every thread of its launch, its plan of thread blocks checked lane by
lane, and so do K8's elementwise bodies, one thread a (limb, lane). This
catches arithmetic faults before they reach the card; the kernels
themselves are built and compared on the card by chip_smoke.py.
"""

import ctypes
import hashlib
import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu_torch.ops import babyjubjub as bjj
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_babyjubjub
from passport_zk_circuits_tpu_torch.ops import cuda_loop
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import cuda_sha2
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import poseidon as pos
from passport_zk_circuits_tpu_torch.ops import sha2
from passport_zk_circuits_tpu_torch.ops import smt
from passport_zk_circuits_tpu.utils import babyjubjub_ref as bref
from passport_zk_circuits_tpu.utils import poseidon_ref as pref

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_P64 = ctypes.POINTER(ctypes.c_int64)
_PU32 = ctypes.POINTER(ctypes.c_uint32)
_PI32 = ctypes.POINTER(ctypes.c_int32)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    so = tmp_path_factory.mktemp("csrc_host") / "libhostcheck.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
         "-I", str(ROOT / "passport_zk_circuits_tpu_torch" / "csrc"),
         "-o", str(so), str(ROOT / "tests" / "torch_csrc_host_check.cc")],
        check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray, typ=_P64):
    return a.ctypes.data_as(typ)


def _limbs(x: int, k: int = 16) -> np.ndarray:
    return bn.int_to_limbs(x, k).astype(np.int64)


def _int(a) -> int:
    return bn.limbs_to_int(a)


def _t(xs, k=16):
    return bn.to_tensor(bn.ints_to_limbs_batch(xs, k), "cpu")


rng = random.Random(404)
EDGES = [0, 1, fr.P - 1]


def test_fr_mul_sqr_add_sub_edges(lib):
    xs = EDGES + [rng.randrange(fr.P) for _ in range(3)]
    pairs = [(a, b) for a in xs for b in xs]
    plain_mul = fr.batch_from_limbs(fr.mul(_t([a for a, _ in pairs]),
                                           _t([b for _, b in pairs])))
    for (a, b), want in zip(pairs, plain_mul):
        out, s, d = (np.zeros(16, np.int64) for _ in range(3))
        lib.host_fr_mul(_ptr(_limbs(a)), _ptr(_limbs(b)), _ptr(out))
        lib.host_fr_add_sub(_ptr(_limbs(a)), _ptr(_limbs(b)), _ptr(s),
                            _ptr(d))
        assert _int(out) == want == a * b % fr.P
        assert _int(s) == (a + b) % fr.P and _int(d) == (a - b) % fr.P
    plain_sqr = fr.batch_from_limbs(fr.sqr(_t(xs)))
    for a, want in zip(xs, plain_sqr):
        out = np.zeros(16, np.int64)
        lib.host_fr_sqr(_ptr(_limbs(a)), _ptr(out))
        assert _int(out) == want == a * a % fr.P


def test_sha256_compression(lib):
    msg = bytes(rng.randrange(256) for _ in range(40))
    block = sha2.bytes_to_words32(sha2.pad_message(msg, 512))
    st = sha2.H256.copy()
    lib.host_sha256_compress(_ptr(st, _PU32), _ptr(block, _PU32))
    state = [torch.tensor([int(v)]) for v in sha2.H256]
    plain = sha2._sha256_block(state, bn.to_tensor(block[:, None], "cpu"))
    assert [int(v) for v in st] == [int(v) for v in plain]
    assert b"".join(int(v).to_bytes(4, "big") for v in st) == \
        hashlib.sha256(msg).digest()


def test_poseidon_t3_permutation(lib):
    ins = [rng.randrange(fr.P) for _ in range(2)]
    state = np.concatenate([_limbs(0)] + [_limbs(x) for x in ins])
    pack = cuda_poseidon._pack(3, torch.device("cpu")).numpy().view(np.uint32)
    out = np.zeros(16, np.int64)
    lib.host_poseidon3(_ptr(state), _ptr(np.ascontiguousarray(pack), _PU32),
                       pos.N_ROUNDS_P[1], _ptr(out))
    plain = fr.batch_from_limbs(pos.poseidon([_t([x]) for x in ins]))
    assert [_int(out)] == plain == [pref.poseidon(ins)]


def test_barrett_modmul_and_pow_k16(lib):
    k = 16
    mods = [rng.getrandbits(255) | (1 << 255) | 1 for _ in range(3)]
    for m in mods:
        x, y = rng.randrange(m), rng.randrange(m)
        mu = bn.barrett_mu(m, k).astype(np.int64)
        out = np.zeros(k, np.int64)
        lib.host_barrett_mulmod(_ptr(_limbs(x, k)), _ptr(_limbs(y, k)),
                                _ptr(_limbs(m, k)), _ptr(mu), k, _ptr(out))
        plain = bn.mod_mul(_t([x], k), _t([y], k), _t([m], k),
                           bn.to_tensor(mu[:, None], "cpu"))
        assert _int(out) == bn.limbs_to_ints_batch(plain)[0] == x * y % m
        for e in (3, 65537, 37187):
            lib.host_pow_mod(_ptr(_limbs(x, k)), _ptr(_limbs(m, k)),
                             _ptr(mu), k, ctypes.c_ulonglong(e), _ptr(out))
            assert _int(out) == pow(x, e, m), e


@pytest.mark.parametrize("bit", [0, 1])
def test_ladder_step(lib, bit):
    x, y = bref.base8_mul(rng.randrange(1, 1 << 40))
    base = bjj.to_extended(_t([x]), _t([y]))
    acc = bjj.double(bjj.double(base))          # a point with Z, T != 1
    acc_np = np.concatenate([c[:, 0].numpy() for c in acc]).astype(np.int64)
    base_np = np.concatenate([c[:, 0].numpy() for c in base]).astype(
        np.int64)
    lib.host_ladder_step(_ptr(acc_np), _ptr(base_np), bit)
    want_acc = bjj.add(acc, base) if bit else acc
    want_base = bjj.double(base)
    for i in range(4):
        assert _int(acc_np[16 * i:16 * i + 16]) == \
            fr.batch_from_limbs(want_acc[i])[0]
        assert _int(base_np[16 * i:16 * i + 16]) == \
            fr.batch_from_limbs(want_base[i])[0]


@pytest.mark.parametrize("body", cuda_loop.BODIES)
def test_loop_body(lib, body):
    """Each K8 body, compiled by g++, against its plain PyTorch version and
    the Python-int oracle, on lanes that include 0, P, 2^256 - 1 and random
    values (most of them >= P)."""
    n = 3
    xs = [0, fr.P, (1 << 256) - 1] + [rng.getrandbits(256) for _ in range(3)]
    cs = [(1 << 256) - 1, fr.P - 1, fr.P + 5] + [rng.getrandbits(256)
                                                 for _ in range(3)]
    a, c = _t(xs), _t(cs)
    plain = cuda_loop.loop_plain(body, a, c, n)
    for lane, (x, y) in enumerate(zip(xs, cs)):
        out = np.zeros(16, np.int64)
        assert lib.host_loop(cuda_loop.BODIES.index(body), _ptr(_limbs(x)),
                             _ptr(_limbs(y)), n, _ptr(out)) == 0
        assert _int(out) == _int(plain[:, lane]) == \
            cuda_loop.body_ints(body, x, y, n)


def _pack3():
    pack = cuda_poseidon._pack(3, torch.device("cpu")).numpy().view(np.uint32)
    return np.ascontiguousarray(pack)


def test_fr_inv_per_thread_and_team(lib):
    """fr::inv (Fermat, a^(P-2)) with one thread a lane and with a team,
    against Python's pow; inv(0) = 0 as in ops/field.inv."""
    for a in EDGES + [2, rng.randrange(fr.P)]:
        want = pow(a, fr.P - 2, fr.P)
        out = np.zeros(16, np.int64)
        lib.host_fr_inv(_ptr(_limbs(a)), _ptr(out))
        assert _int(out) == want
        out = np.zeros(16, np.int64)
        lib.host_team_op(4, _ptr(_limbs(a)), _ptr(_limbs(0)), _ptr(out))
        assert _int(out) == want
    assert _int(out) * a % fr.P == 1


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "mont"])
def test_team_field_ops(lib, op):
    """The team's mul, sqr, add, sub and Montgomery round trip against the
    port's plain field ops and Python ints, on 0, 1, P-1, P-2 and seeded
    values (carries and borrows through all-ones and all-zero words)."""
    xs = EDGES + [fr.P - 2, (1 << 224) - 1] + [rng.randrange(fr.P)
                                                for _ in range(3)]
    pairs = [(a, b) for a in xs for b in xs]
    code = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "mont": 5}[op]
    a_t, b_t = _t([a for a, _ in pairs]), _t([b for _, b in pairs])
    plain = {"mul": lambda: fr.mul(a_t, b_t), "sqr": lambda: fr.sqr(a_t),
             "add": lambda: fr.add(a_t, b_t), "sub": lambda: fr.sub(a_t, b_t),
             "mont": lambda: a_t}[op]()
    want = {"mul": lambda a, b: a * b, "sqr": lambda a, b: a * a,
            "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
            "mont": lambda a, b: a}[op]
    for (a, b), p in zip(pairs, fr.batch_from_limbs(plain)):
        out = np.zeros(16, np.int64)
        lib.host_team_op(code, _ptr(_limbs(a)), _ptr(_limbs(b)), _ptr(out))
        assert _int(out) == p == want(a, b) % fr.P


def test_team_poseidon3(lib):
    ins = [rng.randrange(fr.P) for _ in range(2)]
    state = np.concatenate([_limbs(0)] + [_limbs(x) for x in ins])
    out = np.zeros(16, np.int64)
    lib.host_team_poseidon3(_ptr(state), _ptr(_pack3(), _PU32),
                            pos.N_ROUNDS_P[1], _ptr(out))
    assert [_int(out)] == [pref.poseidon(ins)]


@pytest.mark.parametrize("team", [0, 1])
def test_smt_climb_body(lib, team):
    """K4's per-lane climb (poseidon::smt_climb), one thread a lane and a
    team a lane, against smt_climb_plain on lanes with 0, 1, 3 and 5 live
    levels of 6: each lane skips exactly the levels off its top path."""
    n, depths = 6, [0, 1, 3, 5]
    B = len(depths)
    cols = [[rng.randrange(1, fr.P) if i < d else 0 for i in range(n)]
            for d in depths]
    sibs = bn.to_tensor(np.stack([fr.batch_to_limbs(c) for c in cols],
                                 axis=-1), "cpu")
    key, value = _t([rng.randrange(fr.P) for _ in range(B)]), \
        _t([rng.randrange(fr.P) for _ in range(B)])
    args = smt.climb_inputs(key, sibs)
    assert args[2].sum(0).tolist() == depths
    leaf = cuda_poseidon.poseidon_ex_plain(cuda_poseidon._leaf(key, value))
    flat = [np.ascontiguousarray(a.numpy()) for a in args]
    leaf_np = np.ascontiguousarray(leaf[:, 0].numpy())
    out = np.zeros((16, B), np.int64)
    lib.host_smt_climb(team, *[_ptr(a) for a in flat], _ptr(leaf_np),
                       _ptr(_pack3(), _PU32), pos.N_ROUNDS_P[1], n, B,
                       _ptr(out))
    want = cuda_poseidon.smt_climb_plain(*args, key, value)
    np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("affine", [0, 1])
def test_team_ladder(lib, affine):
    """K5's per-lane ladder with a team a lane, both entries, against the
    plain versions on 12-bit scalars 0, 1, 4095 and a seeded one."""
    nbits = 12
    sks = [0, 1, (1 << nbits) - 1, rng.randrange(1 << nbits)]
    B = len(sks)
    pt = bref.base8_mul(rng.randrange(1, 1 << 40))
    bits = fr.to_bits(_t(sks), nbits)
    bx, by = _t([pt[0]] * B), _t([pt[1]] * B)
    out = np.zeros((4 - 2 * affine, 16, B), np.int64)
    lib.host_team_ladder(affine, _ptr(np.ascontiguousarray(bits.numpy())),
                         _ptr(bx.numpy()), _ptr(by.numpy()), nbits, B,
                         _ptr(out))
    plain = (cuda_babyjubjub.ladder_affine_plain if affine
             else cuda_babyjubjub.ladder_plain)(bits, bx, by)
    np.testing.assert_array_equal(out, torch.stack(plain).numpy())
    if affine:
        assert list(zip(fr.batch_from_limbs(torch.tensor(out[0])),
                        fr.batch_from_limbs(torch.tensor(out[1])))) == \
            [bref.scalar_mul(s, pt) for s in sks]


@pytest.mark.parametrize("t", [2, 3, 6, 12, 17])
def test_poseidon_split_lane(lib, t):
    """K3's lane body (poseidon::poseidon_lane: the permutation split over
    a group of threads, each state element over a team of 4, 4, 4, 2 and 1
    threads at these widths) on three lanes with n_outs = t and a non-zero
    initial state, against the plain version and poseidon_ref; a fourth
    lane past the batch runs on the last one and stores nothing."""
    B = 3
    cols = [[rng.randrange(fr.P) for _ in range(B)] for _ in range(t)]
    cols[1][0] = 0
    state = np.ascontiguousarray(np.concatenate(
        [fr.batch_to_limbs(c) for c in cols]).astype(np.int64))
    pack = np.ascontiguousarray(cuda_poseidon._pack(
        t, torch.device("cpu")).numpy().view(np.uint32))
    out = np.zeros((16 * t, B), np.int64)
    assert lib.host_poseidon_split(_ptr(state), _ptr(pack, _PU32), t,
                                   pos.N_ROUNDS_P[t - 2], t, B,
                                   _ptr(out)) == 0
    ins = [_t(c) for c in cols[1:]]
    plain = cuda_poseidon.poseidon_ex_plain(ins, t, _t(cols[0]))
    np.testing.assert_array_equal(out.reshape(t, 16, B).transpose(1, 0, 2),
                                  plain.numpy())
    for i in range(B):
        assert [_int(out[16 * j:16 * j + 16, i]) for j in range(t)] == \
            pref.poseidon_ex([c[i] for c in cols[1:]], t, cols[0][i])


def _rsa_lanes(k, B):
    """B odd k-limb moduli with the top bit set, lane 2 made even; sigs 0,
    1, n - 1 in lanes 0, 1, 3, the rest random below n."""
    mods = [rng.getrandbits(16 * k - 1) | (1 << (16 * k - 1)) | 1
            for _ in range(B)]
    mods[2] ^= 1
    sigs = [rng.randrange(m) for m in mods]
    sigs[0], sigs[1], sigs[3] = 0, 1, mods[3] - 1
    arrs = [np.ascontiguousarray(a.astype(np.int64)) for a in (
        bn.ints_to_limbs_batch(sigs, k), bn.ints_to_limbs_batch(mods, k),
        bn.barrett_mu_batch(mods, k))]
    return sigs, mods, arrs


@pytest.mark.parametrize("k", [16, 128, 308])
def test_warp_r2_mod_n(lib, k):
    """R^2 mod n = (-mu * n) mod R, R = 2^(16k), from the Barrett constant
    alone (bnw::r2_mod_n across a warp), against Python ints."""
    _, mods, (_, n, mu) = _rsa_lanes(k, 5)
    for i, m in enumerate(mods):
        if not m & 1:
            continue
        out = np.zeros(k, np.int64)
        assert lib.host_warp_r2(_ptr(np.ascontiguousarray(n[:, i])),
                                _ptr(np.ascontiguousarray(mu[:, i])), k,
                                _ptr(out)) == 0
        assert _int(out) == pow(2, 32 * k, m)


@pytest.mark.parametrize("k,exps", [(16, (1, 3, 65537, 37187, None)),
                                    (128, (65537, None)), (308, (3,))])
def test_warp_pow_mod(lib, k, exps):
    """K2's lane body (bnw::pow_lane: Montgomery across a warp of 32
    threads) on five lanes, one with an even modulus (Barrett on one
    thread), sig 0, 1 and n - 1 among them, against the plain version and
    Python pow; None is a seeded odd 64-bit exponent."""
    B = 5
    sigs, mods, (s, n, mu) = _rsa_lanes(k, B)
    for e in exps:
        e = e or rng.getrandbits(64) | 1 | (1 << 63)
        out = np.zeros((k, B), np.int64)
        assert lib.host_warp_pow_mod(_ptr(s), _ptr(n), _ptr(mu), k, B,
                                     ctypes.c_ulonglong(e), _ptr(out)) == 0
        assert bn.limbs_to_ints_batch(out) == \
            [pow(x, e, m) for x, m in zip(sigs, mods)], e
        if e < 1 << 17:
            plain = bn.mod_pow(bn.to_tensor(s, "cpu"), e,
                               bn.to_tensor(n, "cpu"), bn.to_tensor(mu, "cpu"))
            np.testing.assert_array_equal(out, plain.numpy())


SHA_NB = (2, 3, 4, 2)           # the flagship step's dg1, dg15, ec and sa


def _i32(xs):
    return _ptr(np.array(xs, np.int32), _PI32)


@pytest.mark.parametrize("B", [1, 31, 33, 1024])
def test_sha_many_block_map(lib, B):
    """K1's many-message plan (sha::plan_many, sha::block_chunk) for the
    step's four messages and for three (no dg15): every lane of every
    message hashed by exactly one thread, no thread block spanning two
    messages, the messages with the most SHA blocks first (equal counts in
    the caller's order)."""
    for nbs in (SHA_NB, SHA_NB[:1] + SHA_NB[2:]):
        n, chunks = len(nbs), -(-B // 32)
        msg_of = np.full(n * chunks * 32, -2, np.int32)
        lane_of = np.zeros(n * chunks * 32, np.int64)
        blocks = lib.host_sha_many_map(n, _i32(nbs), B, _ptr(msg_of, _PI32),
                                       _ptr(lane_of))
        assert blocks == n * chunks
        covered = np.zeros((n, B), np.int64)
        order = []
        for msgs, lanes in zip(msg_of.reshape(blocks, 32),
                               lane_of.reshape(blocks, 32)):
            live = msgs >= 0
            assert len(set(msgs[live].tolist())) == 1
            assert (lanes[~live] >= B).all() and (lanes[live] < B).all()
            np.add.at(covered[msgs[live][0]], lanes[live], 1)
            if not order or order[-1] != msgs[live][0]:
                order.append(int(msgs[live][0]))
        assert (covered == 1).all()
        assert order == sorted(range(n), key=lambda i: -nbs[i])


def test_sha_many_lanes(lib):
    """K1's many-message entry (sha::many_thread over every thread of the
    launch) on 33 lanes of the step's four messages, the last one SHA-224
    (SIG_ALGO 24 hashes SA with SHA-224), against the plain version and
    hashlib."""
    B, algos = 33, (256, 256, 256, 224)
    texts = [[bytes(rng.randrange(256) for _ in range(
        64 * nb - 9 - rng.randrange(40))) for _ in range(B)] for nb in SHA_NB]
    words = [np.ascontiguousarray(np.stack(
        [sha2.bytes_to_words32(sha2.pad_message(m, 512)) for m in ms],
        axis=-1).astype(np.int64)) for ms in texts]
    outs = [np.zeros((8, B), np.int64) for _ in words]
    ptrs = ctypes.c_void_p * len(words)
    lib.host_sha_many(len(words), ptrs(*[w.ctypes.data for w in words]),
                      ptrs(*[o.ctypes.data for o in outs]), _i32(SHA_NB),
                      _i32([a == 224 for a in algos]), B)
    for w, out, algo, ms in zip(words, outs, algos, texts):
        k = algo // 32
        plain = cuda_sha2.sha2_32_chunks_plain(torch.from_numpy(w), algo)
        np.testing.assert_array_equal(out[:k], plain.numpy())
        assert [b"".join(int(v).to_bytes(4, "big") for v in col)
                for col in out[:k].T.tolist()] == \
            [hashlib.new(f"sha{algo}", m).digest() for m in ms]


@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_fr_mul_chain_team(lib, W):
    """K7's lane body (frs::mul_chain_lane) on a team of 8 / W threads a
    lane, n = 0, 1, 5, with a (16, B) c and with a broadcast (16, 1)
    column, on lanes 0, 1, P-1, P and 2^256-1 (taken unreduced) against
    Python pow; n = 0 gives a as it is; the lane past the batch stores
    nothing (a sentinel row after the output stays)."""
    xs = [0, 1, fr.P - 1, fr.P, (1 << 256) - 1]
    cs = xs[::-1]
    B = len(xs)
    a = np.ascontiguousarray(bn.ints_to_limbs_batch(xs, 16).astype(np.int64))
    c = np.ascontiguousarray(bn.ints_to_limbs_batch(cs, 16).astype(np.int64))
    col = np.ascontiguousarray(c[:, :1])
    for n in (0, 1, 5):
        for bcast, cc, ys in ((0, c, cs), (1, col, cs[:1] * B)):
            out = np.full((17, B), -1, np.int64)
            assert lib.host_fr_chain(W, _ptr(a), _ptr(cc), bcast, _ptr(out),
                                     n, B) == 0
            assert (out[16] == -1).all()
            if n == 0:
                np.testing.assert_array_equal(out[:16], a)
            assert bn.limbs_to_ints_batch(out[:16]) == \
                [x * pow(y, n, fr.P) % fr.P if n else x
                 for x, y in zip(xs, ys)], (n, bcast)


@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_fr_mul_team(lib, W):
    """K6's lane body (frs::mul_lane: mont(a, R^2), then mont(b, a R)) on
    a team of 8 / W threads a lane, against Python ints: every pair of the
    edge values 0, 1, P-1, P and 2^256-1 (taken unreduced) and random
    256-bit lanes, with a (16, B) b and with a broadcast (16, 1) column of
    each edge value; the lane past the batch stores nothing (a sentinel row
    after the output stays)."""
    edges = [0, 1, fr.P - 1, fr.P, (1 << 256) - 1]
    pairs = [(x, y) for x in edges for y in edges]
    pairs += [(rng.getrandbits(256), rng.getrandbits(256)) for _ in range(3)]
    xs, ys = [x for x, _ in pairs], [y for _, y in pairs]
    B = len(xs)
    a = np.ascontiguousarray(bn.ints_to_limbs_batch(xs, 16).astype(np.int64))
    b = np.ascontiguousarray(bn.ints_to_limbs_batch(ys, 16).astype(np.int64))
    cols = [(0, b, ys)] + [
        (1, np.ascontiguousarray(_limbs(y)[:, None]), [y] * B) for y in edges]
    for bcast, bb, want_ys in cols:
        out = np.full((17, B), -1, np.int64)
        assert lib.host_fr_mul_team(W, _ptr(a), _ptr(bb), bcast, _ptr(out),
                                    B) == 0
        assert (out[16] == -1).all()
        assert bn.limbs_to_ints_batch(out[:16]) == \
            [x * y % fr.P for x, y in zip(xs, want_ys)], bcast


@pytest.mark.parametrize("B", [1, 31, 33])
@pytest.mark.parametrize("body", cuda_loop.PER_LIMB)
def test_loop_limb_threads(lib, body, B):
    """K8's map of an elementwise body, one thread a (limb, lane): every
    thread of the launch (whole blocks) run on the host, each lane against
    body_ints; the threads past the batch store nothing (a sentinel row
    after the output stays)."""
    n = 5
    xs = [rng.getrandbits(256) for _ in range(B)]
    cs = [rng.getrandbits(256) for _ in range(B)]
    a = np.ascontiguousarray(bn.ints_to_limbs_batch(xs, 16).astype(np.int64))
    c = np.ascontiguousarray(bn.ints_to_limbs_batch(cs, 16).astype(np.int64))
    out = np.full((17, B), -1, np.int64)
    assert lib.host_loop_limbs(cuda_loop.BODIES.index(body), _ptr(a), _ptr(c),
                               n, _ptr(out), B) == 0
    assert (out[16] == -1).all()
    assert bn.limbs_to_ints_batch(out[:16]) == \
        [cuda_loop.body_ints(body, x, y, n) for x, y in zip(xs, cs)]
    assert lib.host_loop_limbs(cuda_loop.BODIES.index("school"), _ptr(a),
                               _ptr(c), n, _ptr(out), B) == -1
