"""The port's Keccak, Poseidon2 and ecrecover on the CPU.

* ``ops/keccak``: Keccak-256 and SHA3-256 on lengths across the 136-byte
  rate, bit-equal to the JAX package live, to ``hashlib.sha3_256``, to the
  legacy-Keccak vectors of ``tests/test_keccak.py`` and to the port's
  pure-Python oracle ``utils/keccak_ref``; the Ethereum address.
* ``ops/poseidon2``: the permutation and the Merkle root bit-equal to the
  JAX package live (jitted once each: a Poseidon2 graph takes seconds to
  compile), compression and the sponge over 1-5 inputs to the port's
  oracle (``utils/poseidon_ref``, held equal to the JAX package's oracle
  here and in ``test_torch_copies.py``).
* ``ops/ecrecover``: batch 2 over secp256k1 against ``ecdsa_ref``: every
  signer recovered; s + 1 recovers another key; r = 0, s = 0, r >= n and
  s >= n are refused. The JAX package's ``recover`` is slow-tier there and
  here (its jit takes minutes).
"""

import hashlib
import random

import jax
import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import ecrecover as jecrecover
from passport_zk_circuits_tpu.ops import keccak as jkeccak
from passport_zk_circuits_tpu.ops import poseidon2 as jposeidon2
from passport_zk_circuits_tpu.utils import poseidon_ref as jpref
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import ecrecover
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.ops import keccak
from passport_zk_circuits_tpu_torch.ops import poseidon2
from passport_zk_circuits_tpu_torch.ops.curves import CURVES
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref
from passport_zk_circuits_tpu_torch.utils import keccak_ref
from passport_zk_circuits_tpu_torch.utils import poseidon_ref as pref

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

CPU = torch.device("cpu")
LENGTHS = (0, 1, 55, 135, 136, 137, 271, 272, 300)


def _rows(msgs):
    """Equal-length messages -> (n, B) int64 byte rows."""
    return torch.tensor([list(m) for m in msgs],
                        dtype=torch.int64).T.reshape(len(msgs[0]), len(msgs))


def _digests(out):
    d = torch.stack(out)
    return [bytes(d[:, j].tolist()) for j in range(d.shape[1])]


@pytest.mark.parametrize("n", LENGTHS)
def test_keccak_and_sha3_against_hashlib_the_oracle_and_jax(n):
    rng = random.Random(500 + n)
    msgs = [bytes(rng.randrange(256) for _ in range(n)) for _ in range(3)]
    rows = _rows(msgs)
    sha3 = _digests(keccak.keccak256_bytes(rows, sha3=True))
    kec = _digests(keccak.keccak256_bytes(rows))
    assert sha3 == [hashlib.sha3_256(m).digest() for m in msgs]
    assert sha3 == [keccak_ref.keccak256(m, sha3=True) for m in msgs]
    assert kec == [keccak_ref.keccak256(m) for m in msgs]
    jrows = [np.asarray(r, dtype=np.uint32) for r in rows.numpy()]
    for flag, got in ((False, kec), (True, sha3)):
        jout = jkeccak.keccak256_bytes(jrows, flag, bshape=(3,))
        assert got == [bytes(int(np.asarray(o)[j]) for o in jout)
                       for j in range(3)]


def test_keccak256_known_vectors():
    assert _digests(keccak.keccak256_bytes(
        torch.zeros((0, 1), dtype=torch.int64)))[0].hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    got = _digests(keccak.keccak256_bytes(_rows([b"abc", b"abc"])))
    assert got == [bytes.fromhex("4e03657aea45a94fc7d47ba826c8d667"
                                 "c0d1e6e33a64a036ec44f58fa12d6c45")] * 2
    assert keccak_ref.keccak256(b"abc") == got[0]


def test_keccak_f_against_the_oracle():
    rng = random.Random(502)
    lanes = [[rng.randrange(1 << 64) for _ in range(25)] for _ in range(2)]
    st = torch.tensor([[[[(lanes[b][x + 5 * y] >> 32) & 0xFFFFFFFF,
                          lanes[b][x + 5 * y] & 0xFFFFFFFF]
                         for y in range(5)] for x in range(5)]
                       for b in range(2)], dtype=torch.int64)
    out = keccak.keccak_f(st.permute(1, 2, 3, 0))
    for b in range(2):
        want = keccak_ref.keccak_f(lanes[b])
        got = [(int(out[x, y, 0, b]) << 32) | int(out[x, y, 1, b])
               for y in range(5) for x in range(5)]
        assert got == want


def test_eth_address():
    cv = CURVES["secp256k1"]
    rng = random.Random(503)
    pks = []
    for _ in range(3):
        _, (qx, qy) = ecdsa_ref.keygen(cv, rng)
        pks.append(qx.to_bytes(32, "big") + qy.to_bytes(32, "big"))
    got = _digests(keccak.eth_address_from_pubkey(_rows(pks)))
    assert got == [keccak_ref.eth_address(pk) for pk in pks]
    assert all(len(a) == 20 for a in got)
    jout = jkeccak.eth_address_from_pubkey(
        [np.asarray(r, dtype=np.uint32) for r in _rows(pks).numpy()])
    assert got == [bytes(int(np.asarray(o)[j]) for o in jout)
                   for j in range(3)]


def _fr(xs):
    return bn.to_tensor(fr.batch_to_limbs(xs), CPU)


def test_poseidon2_permutation_and_merkle_root_against_jax():
    rng = random.Random(510)
    cols = [[rng.randrange(pref.P) for _ in range(3)] for _ in range(3)]
    state = [_fr(c) for c in cols]
    got = [fr.batch_from_limbs(s) for s in poseidon2.permutation(*state)]
    jout = jax.jit(jposeidon2.permutation)(
        *[fr.batch_to_limbs(c) for c in cols])
    assert got == [fr.batch_from_limbs(np.asarray(o)) for o in jout]
    assert got == [list(v) for v in zip(*[pref.poseidon2_permutation(
        [cols[0][j], cols[1][j], cols[2][j]]) for j in range(3)])]
    leaves = np.stack([fr.batch_to_limbs([rng.randrange(pref.P)
                                          for _ in range(2)])
                       for _ in range(2)], 1)               # (16, 2, 2)
    root = poseidon2.merkle_root(bn.to_tensor(leaves, CPU))
    jroot = jax.jit(jposeidon2.merkle_root)(leaves)
    assert fr.batch_from_limbs(root) == fr.batch_from_limbs(np.asarray(jroot))


def _merkle_ref(leaves):
    while len(leaves) > 1:
        leaves = [pref.poseidon2_compression(a, b)
                  for a, b in zip(leaves[0::2], leaves[1::2])]
    return leaves[0]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_poseidon2_sponge_against_the_oracle(n):
    rng = random.Random(520 + n)
    xs = [[rng.randrange(pref.P) for _ in range(2)] for _ in range(n)]
    want = [pref.poseidon2_sponge([x[j] for x in xs]) for j in range(2)]
    assert want == [jpref.poseidon2_sponge([x[j] for x in xs])
                    for j in range(2)]
    if n == 2:                          # one (16, n, B) tensor
        got = poseidon2.sponge_hash(torch.stack([_fr(x) for x in xs], 1))
    else:
        got = poseidon2.sponge_hash([_fr(x) for x in xs])
    assert fr.batch_from_limbs(got) == want


def test_poseidon2_compression_and_merkle_root_against_the_oracle():
    rng = random.Random(525)
    leaves = [[rng.randrange(pref.P) for _ in range(2)] for _ in range(8)]
    a, b = leaves[0], leaves[1]
    assert fr.batch_from_limbs(poseidon2.compression(_fr(a), _fr(b))) == [
        pref.poseidon2_compression(a[j], b[j]) for j in range(2)]
    root = poseidon2.merkle_root(torch.stack([_fr(v) for v in leaves], 1))
    assert fr.batch_from_limbs(root) == [
        _merkle_ref([v[j] for v in leaves]) for j in range(2)]
    with pytest.raises(ValueError):
        poseidon2.merkle_root(torch.stack([_fr(v) for v in leaves[:3]], 1))


def _signatures(rng, n):
    """n secp256k1 keys and one signature each over a SHA-256 digest:
    (keys, r, s, v_odd, digests), r taken with R's x below n."""
    cv = CURVES["secp256k1"]
    keys, rs, ss, vs, digs = [], [], [], [], []
    for i in range(n):
        d, Q = ecdsa_ref.keygen(cv, rng)
        dg = hashlib.sha256(bytes([i]) * 7).digest()
        h = int.from_bytes(dg, "big")
        while True:
            k = rng.randrange(1, cv.n)
            R = ecdsa_ref.scalar_mul(cv, k, (cv.gx, cv.gy))
            r = R[0] % cv.n
            s = pow(k, -1, cv.n) * (h + r * d) % cv.n
            if r and s and R[0] < cv.n:
                break
        keys.append(Q), rs.append(r), ss.append(s), vs.append(R[1] & 1)
        digs.append(dg)
    return keys, rs, ss, vs, digs


def _recover_args(rs, ss, vs, digs):
    lim = lambda xs: bn.to_tensor(bn.ints_to_limbs_batch(xs, 16), CPU)  # noqa: E731
    bits = torch.tensor([[(int.from_bytes(dg, "big") >> (255 - i)) & 1
                          for dg in digs] for i in range(256)])
    return lim(rs), lim(ss), torch.tensor(vs, dtype=torch.bool), bits


def _ints(t):
    return bn.limbs_to_ints_batch(t)


def test_ecrecover_recovers_every_signer():
    keys, rs, ss, vs, digs = _signatures(random.Random(530), 2)
    qx, qy, ok = ecrecover.recover(*_recover_args(rs, ss, vs, digs))
    assert ok.tolist() == [True, True]
    assert list(zip(_ints(qx), _ints(qy))) == keys


def test_ecrecover_refuses_bad_signatures():
    """One call: lane 0 as signed; lane 1 s + 1 (valid, another key); then
    r = 0, s = 0, r = n and s = n, each refused."""
    cv = CURVES["secp256k1"]
    keys, rs, ss, vs, digs = _signatures(random.Random(531), 2)
    r, s = rs[1], ss[1]
    cases = [(rs[0], ss[0]), (r, s + 1), (0, s), (r, 0), (cv.n, s),
             (r, cv.n)]
    qx, qy, ok = ecrecover.recover(*_recover_args(
        [c[0] for c in cases], [c[1] for c in cases], [vs[0]] + [vs[1]] * 5,
        [digs[0]] + [digs[1]] * 5))
    assert ok.tolist() == [True, True, False, False, False, False]
    assert (_ints(qx)[0], _ints(qy)[0]) == keys[0]
    assert (_ints(qx)[1], _ints(qy)[1]) != keys[1]


@pytest.mark.slow
def test_ecrecover_equals_the_jax_package():
    """Every output bit-equal to the JAX package's recover (slow: its jit
    takes minutes on the CPU), on a valid lane and an s + 1 lane."""
    keys, rs, ss, vs, digs = _signatures(random.Random(532), 2)
    ss[1] += 1
    args = _recover_args(rs, ss, vs, digs)
    got = ecrecover.recover(*args)
    want = jax.jit(jecrecover.recover)(*[np.asarray(a).astype(
        np.uint32 if a.dtype != torch.bool else bool) for a in args])
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w).astype(
            np.asarray(g).dtype))
