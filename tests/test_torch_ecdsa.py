"""The port's Weierstrass arithmetic and ECDSA against the oracles and the
JAX package.

The JAX ECDSA tests are slow-tier (XLA compiles of whole scalar mults), so
the fast tier holds the port's scalar mults and verdicts against the
pure-Python oracle (``utils/ecdsa_ref``), its modular arithmetic against
Python ints; a slow-tier test holds its group formulas against the JAX
package's own functions, called eagerly (no jit, about 20 s of op compiles)
on a few lanes: the same formulas give the same Jacobian coordinates.
Exact equality throughout.
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ops import weierstrass as jwst
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import bitops
from passport_zk_circuits_tpu_torch.ops import ecdsa
from passport_zk_circuits_tpu_torch.ops import weierstrass as wst
from passport_zk_circuits_tpu_torch.ops.curves import CURVES
from passport_zk_circuits_tpu_torch.tools import count_ops
from passport_zk_circuits_tpu_torch.utils import ecdsa_ref as ref

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

rng = random.Random(6406)
REGISTRY = ("p256", "secp192r1", "secp224r1", "brainpoolP256r1",
            "brainpoolP320r1", "brainpoolP384r1")


def _t(ints, k):
    return bn.to_tensor(bn.ints_to_limbs_batch(ints, k), "cpu")


def _affine(c, P):
    x, y = wst.to_affine(c, P)
    return list(zip(bn.limbs_to_ints_batch(x), bn.limbs_to_ints_batch(y)))


@pytest.mark.parametrize("name", REGISTRY)
def test_static_mod_matches_python_ints(name):
    """StaticMod mod p and mod n: products of any values below b^k (edge
    lanes 0, 1, m-1, m, b^k - 1), sums, differences, inverses, one
    grouped call against one call each."""
    cv = CURVES[name]
    for m in (cv.p, cv.n):
        k = bn.nlimbs_for_bits(m.bit_length())
        f = bn.StaticMod(m, k)
        top = (1 << (16 * k)) - 1
        xs = [0, 1, m - 1, m, top] + [rng.randrange(m) for _ in range(27)]
        ys = [m - 1, top, m - 1, 1, top] + [rng.randrange(m)
                                            for _ in range(27)]
        a, b = _t(xs, k), _t(ys, k)
        assert bn.limbs_to_ints_batch(f.mul(a, b)) == \
            [x * y % m for x, y in zip(xs, ys)]
        assert bn.limbs_to_ints_batch(f.reduce(b)) == [y % m for y in ys]
        xr, yr = xs[5:], ys[5:]
        ar, br = _t(xr, k), _t(yr, k)
        assert bn.limbs_to_ints_batch(f.add(ar, br)) == \
            [(x + y) % m for x, y in zip(xr, yr)]
        assert bn.limbs_to_ints_batch(f.sub(ar, br)) == \
            [(x - y) % m for x, y in zip(xr, yr)]
        assert bn.limbs_to_ints_batch(f.sub(br, br)) == [0] * len(yr)
        assert bn.limbs_to_ints_batch(f.inv(ar[:, :4])) == \
            [pow(x, m - 2, m) for x in xr[:4]]
        grouped = f.mul(torch.stack([a, b], 1), torch.stack([b, b], 1))
        assert torch.equal(grouped[:, 0], f.mul(a, b))
        assert torch.equal(grouped[:, 1], f.mul(b, b))


def test_static_mod_rejects_unsized_modulus():
    with pytest.raises(ValueError):
        bn.StaticMod(3, 16)
    with pytest.raises(ValueError):
        bn.StaticMod((1 << 400) + 1, 26)


def _points(cv, n):
    return [ref.scalar_mul(cv, rng.randrange(1, cv.n), (cv.gx, cv.gy))
            for _ in range(n)]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["p256", "brainpoolP256r1"])
def test_group_formulas_equal_jax_coordinates(name):
    """jac_double, jac_add (P + Q, P + P, P + (-P), infinity on either
    side) and jac_add_affine: the port's Jacobian coordinates equal the JAX
    package's, lane for lane."""
    c, jc = wst.ctx(name), jwst.ctx(name)
    cv = c.curve
    ps = _points(cv, 5)
    qs = _points(cv, 1) + [ps[1], (ps[2][0], cv.p - ps[2][1])] + _points(cv, 2)
    # make Z != 1: double first, then add
    P = wst.jac_double(c, c.stack(_t([p[0] for p in ps], c.k),
                                   _t([p[1] for p in ps], c.k),
                                   _t([1] * 5, c.k)))
    Q = wst.jac_double(c, c.stack(_t([q[0] for q in qs], c.k),
                                   _t([q[1] for q in qs], c.k),
                                   _t([1] * 5, c.k)))
    inf = wst.infinity_like(c, P[:, 0])
    lanes = torch.tensor([True, True, True, True, False])
    Q = torch.where(lanes, Q, inf)                    # lane 4: P + inf
    jP = tuple(np.asarray(P[:, i]).astype(np.uint32) for i in range(3))
    jQ = tuple(np.asarray(Q[:, i]).astype(np.uint32) for i in range(3))

    def same(got, want):
        for i in range(3):
            np.testing.assert_array_equal(got[:, i].numpy(),
                                          np.asarray(want[i]).astype(np.int64))
    same(wst.jac_double(c, P), jwst.jac_double(jc, jP))
    same(wst.jac_add(c, P, Q), jwst.jac_add(jc, jP, jQ))
    same(wst.jac_add(c, Q, P), jwst.jac_add(jc, jQ, jP))
    qx, qy = _t([q[0] for q in qs], c.k), _t([q[1] for q in qs], c.k)
    qinf = torch.tensor([False, False, False, True, False])
    same(wst.jac_add_affine(c, P, qx, qy, qinf),
         jwst.jac_add_affine(jc, jP, np.asarray(qx).astype(np.uint32),
                             np.asarray(qy).astype(np.uint32),
                             np.asarray(qinf)))
    assert _affine(c, wst.jac_add(c, P, Q))[:2] == [
        ref._add(cv, ref._add(cv, p, p), ref._add(cv, q, q))
        for p, q in zip(ps[:2], qs[:2])]


@pytest.mark.parametrize("name", ["p256", "secp192r1"])
def test_scalar_mul_window_matches_oracle(name):
    c = wst.ctx(name)
    cv = c.curve
    scalars = [0, 1, 2, cv.n - 1] + [rng.randrange(1, cv.n)
                                     for _ in range(2)]
    pts = _points(cv, len(scalars))
    got = _affine(c, wst.scalar_mul_window(
        c, _t(scalars, c.kn), _t([p[0] for p in pts], c.k),
        _t([p[1] for p in pts], c.k)))
    want = [ref.scalar_mul(cv, s, p) or (0, 0) for s, p in zip(scalars, pts)]
    assert got == want


@pytest.mark.parametrize("name", ["p256", "secp192r1"])
def test_fixed_base_mul_matches_oracle(name):
    c = wst.ctx(name)
    cv = c.curve
    scalars = [0, 1, 2, 255, 256, cv.n - 1, rng.randrange(1, cv.n)]
    got = _affine(c, wst.fixed_base_mul(c, _t(scalars, c.kn)))
    want = [ref.scalar_mul(cv, s, (cv.gx, cv.gy)) or (0, 0)
            for s in scalars]
    assert got == want


def test_fixed_base_table_is_read_not_written(tmp_path, monkeypatch):
    xs, ys, infs = wst.fixed_base_table("p256", torch.device("cpu"))
    assert xs.shape == (32, 16, 256) and infs.shape == (32, 256)
    assert wst.fixed_base_table("p256", torch.device("cpu"))[0] is xs
    monkeypatch.setattr(wst, "CONST_DIR", tmp_path)
    wst.fixed_base_table.cache_clear()
    try:
        with pytest.raises(FileNotFoundError):
            wst.fixed_base_table("p256", torch.device("cpu"))
    finally:
        wst.fixed_base_table.cache_clear()
    assert not list(tmp_path.iterdir())


def _verify_case(name, hash_name):
    """Lanes: valid, r + 1, s + 1, r = 0, s = n, key off the curve, valid
    with another key -> (inputs, expected verdicts)."""
    cv = CURVES[name]
    c = wst.ctx(name)
    keys = [ref.keygen(cv, rng) for _ in range(2)]
    digests = [hashlib.new(hash_name, bytes([i])).digest() for i in range(7)]
    sigs = [ref.sign(cv, keys[0][0], d, rng) for d in digests[:6]]
    sigs.append(ref.sign(cv, keys[1][0], digests[6], rng))
    sigs[1] = ((sigs[1][0] + 1) % cv.n, sigs[1][1])
    sigs[2] = (sigs[2][0], (sigs[2][1] + 1) % cv.n)
    sigs[3] = (0, sigs[3][1])
    sigs[4] = (sigs[4][0], cv.n)
    pubs = [keys[0][1]] * 6 + [keys[1][1]]
    pubs[5] = (pubs[5][0], (pubs[5][1] + 1) % cv.p)
    want = [ref.verify(cv, q, d, r, s) if i != 5 else False
            for i, (q, d, (r, s)) in enumerate(zip(pubs, digests, sigs))]
    assert want == [True, False, False, False, False, False, True]
    hash_len = len(digests[0]) * 8
    words = bn.to_tensor(np.stack([np.frombuffer(d, ">u4").astype(np.uint32)
                                   for d in digests], -1), "cpu")
    sig = torch.cat([_t([s[0] for s in sigs], c.kn),
                     _t([s[1] for s in sigs], c.kn)])
    return (_t([q[0] for q in pubs], c.k), _t([q[1] for q in pubs], c.k),
            sig, bitops.get_bits(words, 0, hash_len)), want


def test_verify_p256_true_and_false_lanes():
    args, want = _verify_case("p256", "sha256")
    assert ecdsa.verify("p256", *args).tolist() == want
    c = wst.ctx("p256")
    assert ecdsa.on_curve(c, args[0], args[1]).tolist() == \
        [True] * 5 + [False, True]


def test_verify_rejects_key_coordinates_not_below_p():
    """A key's coordinates must lie in [0, p-1] (SEC 1 v2, 3.2.2.1): with
    x + p or y + p (still below 2^256 on brainpoolP256r1) the same valid
    signature is rejected, although the residues are the signer's key."""
    name = "brainpoolP256r1"
    cv, c = CURVES[name], wst.ctx(name)
    d, (x, y) = ref.keygen(cv, rng)
    while max(x, y) + cv.p >= 1 << 256:
        d, (x, y) = ref.keygen(cv, rng)
    digest = hashlib.sha256(b"range").digest()
    r, s = ref.sign(cv, d, digest, rng)
    assert ref.verify(cv, (x, y), digest, r, s)
    words = bn.to_tensor(np.frombuffer(digest, ">u4").astype(np.uint32)
                         [:, None].repeat(3, 1), "cpu")
    args = (_t([x, x, x + cv.p], c.k), _t([y, y + cv.p, y], c.k),
            torch.cat([_t([r] * 3, c.kn), _t([s] * 3, c.kn)]),
            bitops.get_bits(words, 0, 256))
    assert ecdsa.verify(name, *args).tolist() == [True, False, False]


def test_count_ops_tool_on_the_cpu(capsys):
    """tools/count_ops counts a StaticMod product in fewer launching ops
    than a Barrett mod_mul, and its op counter counts one verify's ops
    (the tool's own verify run takes tens of seconds under the CPU
    profiler: slow tier)."""
    count_ops.main(["--device", "cpu", "--batch", "1", "--curves", ""])
    counts = {line.split(":")[0]: int(line.split(":")[1].split()[0])
              for line in capsys.readouterr().out.splitlines()}
    assert counts["StaticMod.mul"] < counts["bignum.mod_mul (Barrett)"]
    assert counts["StaticMod.add"] < counts["bignum.add_mod"]
    c = wst.ctx("p256")
    a = _t([3, 5], c.k)
    n, names = count_ops.launching_ops(lambda: c.fp.mul(a, a))
    assert n == counts["StaticMod.mul"] and "aten::slice" not in names


@pytest.mark.slow
def test_count_ops_tool_verify(capsys):
    count_ops.main(["--device", "cpu", "--batch", "1",
                    "--curves", "secp192r1"])
    out = capsys.readouterr().out
    assert "ecdsa.verify secp192r1, B = 1:" in out
    assert "verdicts [True]" in out


def test_hash_wider_than_order_keeps_leftmost_bits():
    bits = torch.tensor([[1, 0, 1] * 128]).T                  # 384 bits
    limbs = ecdsa.hash_bits_to_limbs(bits, 16)
    want = int("".join(str(b) for b in bits[:256, 0].tolist()), 2)
    assert bn.limbs_to_ints_batch(limbs) == [want]


@pytest.mark.slow
@pytest.mark.parametrize("name,hash_name", [
    ("secp192r1", "sha1"), ("secp224r1", "sha224"),
    ("brainpoolP256r1", "sha256"), ("brainpoolP320r1", "sha256"),
    ("brainpoolP384r1", "sha384")])
def test_verify_other_curves(name, hash_name):
    args, want = _verify_case(name, hash_name)
    assert ecdsa.verify(name, *args).tolist() == want


@pytest.mark.slow
@pytest.mark.parametrize("name", ["secp224r1", "brainpoolP256r1",
                                  "brainpoolP320r1", "brainpoolP384r1"])
def test_scalar_mults_other_curves(name):
    c = wst.ctx(name)
    cv = c.curve
    scalars = [1, cv.n - 1, rng.randrange(1, cv.n)]
    pts = _points(cv, 3)
    assert _affine(c, wst.scalar_mul_window(
        c, _t(scalars, c.kn), _t([p[0] for p in pts], c.k),
        _t([p[1] for p in pts], c.k))) == \
        [ref.scalar_mul(cv, s, p) for s, p in zip(scalars, pts)]
    assert _affine(c, wst.fixed_base_mul(c, _t(scalars, c.kn))) == \
        [ref.scalar_mul(cv, s, (cv.gx, cv.gy)) for s in scalars]
