"""The port's Groth16 (``groth16/protocol.py``) against the JAX package,
tolerance 0: keys and proofs are integers.

Live against the JAX package: ``setup`` on the demo circuit of
``tests/test_groth16.py``, every key field equal, and the JAX key carried
across (``protocol.keys_from``). Through
``tests/fixtures/torch_port_prove_b2.npz`` (the JAX prover compiles its
device programs with jit there): ``h_coefficients`` on the demo and the
1,766-wire gadget circuits, and the proofs made with the JAX package's own
keys, which the port's prover, with its device MSMs forced (host cutoff
0), must equal bit for bit (the gadget circuit's in the slow tier). Port
only: each lane's proof verifies, and a wrong public input, a tampered A
(A + G1) and an unsatisfied witness each fail; the snarkjs export of a
port proof equals the JAX package's export of its proof.
"""

import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu import groth16 as jg16
from passport_zk_circuits_tpu.groth16 import export as jexport
from passport_zk_circuits_tpu.groth16 import pairing as jpr
from passport_zk_circuits_tpu.r1cs import system as jr1
from passport_zk_circuits_tpu_torch.groth16 import export
from passport_zk_circuits_tpu_torch.groth16 import pairing as pr
from passport_zk_circuits_tpu_torch.groth16 import protocol as g16
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.r1cs import system as r1

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "tools"))
import make_torch_port_fixtures as fx  # noqa: E402

CPU = torch.device("cpu")
FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_port_prove_b2.npz")
DEMO_SEEDS = (7, 3)            # the fixture's setup and prove seeds
GADGET_SEEDS = (3, 4)


@pytest.fixture(scope="module")
def d():
    with np.load(FIXTURE) as f:
        return dict(f)


def _point(a):
    """Fixture limbs -> a G1 int point, a port G2 point or None."""
    if (a == 0xFFFF).all():
        return None
    if a.ndim == 3:
        return tuple(pr.FQ2([bn.limbs_to_int(e[:, 0]), bn.limbs_to_int(e[:, 1])])
                     for e in a)
    return (bn.limbs_to_int(a[0]), bn.limbs_to_int(a[1]))


def _circuit(d, name):
    """(ConstraintSystem from the fixture's triplets, witness, public
    values per lane)."""
    tag = f"{name}_"
    mats = []
    for m in ("a", "b", "c"):
        coeffs = bn.limbs_to_ints_batch(d[f"{tag}{m}_coeff"].T) \
            if len(d[f"{tag}{m}_coeff"]) else []
        mats.append([(int(r), int(c), v) for (r, c), v in
                     zip(d[f"{tag}{m}_rc"], coeffs)])
    cs = r1.ConstraintSystem(n_vars=int(d[tag + "n_vars"]), a=mats[0],
                             b=mats[1], c=mats[2],
                             n_constraints=int(d[tag + "n_constraints"]))
    pub = np.asarray([bn.limbs_to_ints_batch(p.T) for p in d[tag + "public"]])
    return cs, d[tag + "witness"], [list(map(int, pub[:, lane]))
                                    for lane in range(pub.shape[1])]


def _fixture_keys(d, name):
    """The JAX setup's keys, as stored, carried into the port on the CPU."""
    tag = f"{name}_"
    pk = types.SimpleNamespace(
        n_public=int(d[tag + "n_public"]),
        domain_size=int(d[tag + "domain_size"]),
        **{f: _point(d[f"{tag}pk_{f}"])
           for f in ("alpha1", "beta1", "delta1", "beta2", "delta2")},
        **{f: d[f"{tag}pk_{f}"]
           for f in ("a_query", "b1_query", "k_query", "h_query", "b2_query",
                     "a_inf", "b1_inf", "k_inf", "b2_inf")})
    vk = types.SimpleNamespace(
        n_public=pk.n_public, ic=[_point(p) for p in d[tag + "vk_ic"]],
        **{f: _point(d[f"{tag}vk_{f}"])
           for f in ("alpha1", "beta2", "gamma2", "delta2")})
    return g16.keys_from(pk, vk, CPU)


def _proofs(d, name):
    tag = f"{name}_"
    return [g16.Proof(a=_point(a), b=_point(b), c=_point(c)) for a, b, c in
            zip(d[tag + "proof_a"], d[tag + "proof_b"], d[tag + "proof_c"])]


def _same(p, q):
    assert (p.a, p.c) == (q.a, q.c)
    assert [int(c) for e in p.b for c in e.coeffs] == \
        [int(c) for e in q.b for c in e.coeffs]


@pytest.fixture(scope="module")
def demo_setups():
    """The JAX package's and the port's setup of the demo circuit."""
    jpk, jvk = jg16.setup(fx.demo_circuit(jr1), n_public=2,
                          seed=DEMO_SEEDS[0])
    pk, vk = g16.setup(fx.demo_circuit(r1), 2, seed=DEMO_SEEDS[0],
                       device=CPU)
    return (jpk, jvk), (pk, vk)


@pytest.fixture(scope="module")
def demo_proofs(d, demo_setups):
    """The port's proofs of the fixture's demo witness with the JAX
    package's key, device MSMs forced."""
    (jpk, jvk), _ = demo_setups
    pk, vk = g16.keys_from(jpk, jvk, CPU)
    cs, w, pub = _circuit(d, "demo")
    return vk, pub, g16.prove(pk, cs, w, seed=DEMO_SEEDS[1], host_cutoff=0)


def _g2_ints(pt):
    return [int(c) for e in pt for c in e.coeffs]


def test_demo_setup_equals_jax_field_by_field(d, demo_setups):
    (jpk, jvk), (pk, vk) = demo_setups
    for f in ("n_public", "domain_size", "alpha1", "beta1", "delta1"):
        assert getattr(pk, f) == getattr(jpk, f), f
    for f in ("beta2", "delta2"):
        assert _g2_ints(getattr(pk, f)) == _g2_ints(getattr(jpk, f)), f
    for f in ("a_query", "b1_query", "k_query", "h_query", "b2_query",
              "a_inf", "b1_inf", "k_inf", "b2_inf"):
        mine, theirs = getattr(pk, f), np.asarray(getattr(jpk, f))
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs), f
        assert np.array_equal(mine, d[f"demo_pk_{f}"]), f
    assert (vk.n_public, vk.alpha1, vk.ic) == (jvk.n_public, jvk.alpha1,
                                               jvk.ic)
    for f in ("beta2", "gamma2", "delta2"):
        assert _g2_ints(getattr(vk, f)) == _g2_ints(getattr(jvk, f)), f
    # the key's queries live on its device, infinity masks beside them
    assert pk.device == CPU and set(pk.queries) == set(g16.QUERIES)
    qx, qy, inf = pk.queries["b2"]
    assert torch.equal(qx, bn.to_tensor(pk.b2_query[0], CPU))
    assert inf.tolist() == pk.b2_inf.tolist() and pk.queries["h"][2] is None


@pytest.mark.parametrize("name", ["demo", "gadget"])
def test_h_coefficients_equal_jax_fixture(d, name):
    cs, w, _ = _circuit(d, name)
    h = g16.h_coefficients(cs, w, device=CPU)
    assert h.shape == d[f"{name}_h"].shape
    assert np.array_equal(h.numpy(), d[f"{name}_h"])


def test_demo_proofs_forced_to_the_device_msm_equal_jax(d, demo_proofs):
    _, _, proofs = demo_proofs
    for p, q in zip(proofs, _proofs(d, "demo")):
        _same(p, q)


def test_demo_proofs_verify_and_tampering_fails(demo_proofs):
    vk, pub, proofs = demo_proofs
    for lane in range(2):
        assert g16.verify(vk, proofs[lane], pub[lane])
    assert not g16.verify(vk, proofs[0], [(pub[0][0] + 1) % fr.P, pub[0][1]])
    a = pr.ec_add((pr.FQ1([proofs[0].a[0]]), pr.FQ1([proofs[0].a[1]])),
                  pr.G1)
    tampered = g16.Proof(a=(a[0].coeffs[0], a[1].coeffs[0]), b=proofs[0].b,
                         c=proofs[0].c)
    assert not g16.verify(vk, tampered, pub[0])


def test_unsatisfied_witness_yields_a_proof_that_fails(d):
    pk, vk = _fixture_keys(d, "demo")
    cs, w, pub = _circuit(d, "demo")
    w = w.copy()
    w[1, :, 0] = fr.to_limbs(pub[0][0] + 1)           # claim a wrong z
    ok, _ = r1.check_batched(cs, w, device=CPU)
    assert ok.tolist() == [False, True]
    proofs = g16.prove(pk, cs, w, seed=DEMO_SEEDS[1])  # host MSMs: tiny
    assert not g16.verify(vk, proofs[0], [(pub[0][0] + 1) % fr.P, pub[0][1]])


def test_prove_needs_a_key_on_a_device(d):
    pk, _ = _fixture_keys(d, "demo")
    cs, w, _ = _circuit(d, "demo")
    bare = g16.ProvingKey(**{f: getattr(pk, f) for f in (
        "n_public", "domain_size", "alpha1", "beta1", "delta1", "beta2",
        "delta2", "a_query", "b1_query", "k_query", "h_query", "b2_query",
        "a_inf", "b1_inf", "k_inf", "b2_inf")})
    with pytest.raises(ValueError):
        g16.prove(bare, cs, w)


def test_prove_and_setup_hand_back_their_device_inputs(d, demo_proofs):
    """prove(inputs=) gets each device MSM's scalars: the witness with the
    query's infinity points masked, and the h coefficients; the proofs are
    the same as without it. setup's fixed-base lists past the host cutoff
    (inputs=) get their limb tensor."""
    pk, _ = _fixture_keys(d, "demo")
    cs, w, _ = _circuit(d, "demo")
    inputs = {}
    proofs = g16.prove(pk, cs, w, seed=DEMO_SEEDS[1], host_cutoff=0,
                       inputs=inputs)
    for p, q in zip(proofs, demo_proofs[2]):
        _same(p, q)
    w_s = torch.from_numpy(w.astype(np.int64)).permute(1, 2, 0)
    assert set(inputs) == {n for n in g16.QUERIES
                           if getattr(pk, f"{n}_query").shape[-1]}
    assert torch.equal(inputs["a"], w_s.masked_fill(
        torch.from_numpy(pk.a_inf), 0))
    assert torch.equal(inputs["b2"], w_s.masked_fill(
        torch.from_numpy(pk.b2_inf), 0))
    assert torch.equal(inputs["h"], g16.h_coefficients(
        cs, w, device=CPU).transpose(1, 2))
    ss = [0, 1, fr.P - 1, fr.P + 5] + list(range(2, 511))
    got = {}
    (x, inf) = g16._g1_mul_many(ss, CPU, got, "a")
    assert torch.equal(got["a"], bn.to_tensor(
        bn.ints_to_limbs_batch([s % fr.P for s in ss], 16), CPU))
    assert inf.tolist() == [True] + [False] * (len(ss) - 1)
    assert [(bn.limbs_to_int(x[0][:, i]), bn.limbs_to_int(x[1][:, i]))
            for i in (1, 2, 3)] == [g16._g1_mul(s) for s in (1, -1, 5)]


def test_export_of_a_port_proof_equals_the_jax_export(d, demo_proofs):
    vk, pub, proofs = demo_proofs
    jproofs = _proofs(d, "demo")

    def jpoint(p):
        return tuple(jpr.FQ2([int(c) for c in e.coeffs]) for e in p)

    jp = jg16.Proof(a=jproofs[0].a, b=jpoint(jproofs[0].b), c=jproofs[0].c)
    jvk = jg16.VerifyingKey(n_public=vk.n_public, alpha1=vk.alpha1,
                            beta2=jpoint(vk.beta2), gamma2=jpoint(vk.gamma2),
                            delta2=jpoint(vk.delta2), ic=vk.ic)
    assert export.proof_to_json(proofs[0]) == jexport.proof_to_json(jp)
    assert export.vk_to_json(vk) == jexport.vk_to_json(jvk)
    assert export.solidity_calldata(proofs[0], pub[0]) == \
        jexport.solidity_calldata(jp, pub[0])
    cs, w, _ = _circuit(d, "demo")
    jcs = jr1.ConstraintSystem(n_vars=cs.n_vars, a=cs.a, b=cs.b, c=cs.c,
                               n_constraints=cs.n_constraints)
    data = export.export_r1cs(cs, 2)
    assert data == jexport.export_r1cs(jcs, 2)
    back = export.import_r1cs(data)
    assert (back.n_vars, back.n_constraints) == (cs.n_vars, cs.n_constraints)
    vals = [bn.limbs_to_int(w[i, :, 0]) for i in range(cs.n_vars)]
    assert export.import_wtns(export.export_wtns(vals)) == vals


@pytest.mark.slow
def test_gadget_proofs_forced_to_the_device_msm_equal_jax(d):
    """The 1,766-wire gadget circuit: the port's proofs with the JAX
    package's key and the device MSMs forced equal the JAX package's, and
    verify (the port's MSMs over 1,766-2,047 points run for minutes on
    the CPU)."""
    pk, vk = _fixture_keys(d, "gadget")
    cs, w, pub = _circuit(d, "gadget")
    proofs = g16.prove(pk, cs, w, seed=GADGET_SEEDS[1], host_cutoff=0)
    for p, q in zip(proofs, _proofs(d, "gadget")):
        _same(p, q)
    for lane in range(2):
        assert g16.verify(vk, proofs[lane], pub[lane])
        assert not g16.verify(vk, proofs[lane], [(pub[lane][0] + 1) % fr.P])


@pytest.mark.slow
def test_gadget_setup_equals_jax_fixture(d):
    """The port's setup of the gadget circuit on the CPU (its fixed-base
    mults past 512 G1 and 256 G2 points) equals the JAX package's key."""
    cs, _, _ = _circuit(d, "gadget")
    pk, vk = g16.setup(cs, 1, seed=GADGET_SEEDS[0], device=CPU)
    for f in ("a_query", "b1_query", "k_query", "h_query", "b2_query",
              "a_inf", "b1_inf", "k_inf", "b2_inf"):
        assert np.array_equal(getattr(pk, f), d[f"gadget_pk_{f}"]), f
    for f in ("alpha1", "beta1", "delta1"):
        assert getattr(pk, f) == _point(d[f"gadget_pk_{f}"]), f
    for f in ("beta2", "delta2"):
        assert _g2_ints(getattr(pk, f)) == \
            _g2_ints(_point(d[f"gadget_pk_{f}"])), f
    assert vk.ic == [_point(p) for p in d["gadget_vk_ic"]]
