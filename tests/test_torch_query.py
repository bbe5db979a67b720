"""The port's QueryIdentity (TD3 and TD1) against the JAX package's and the
Python-int oracles.

The fast tests hold the port's forward against the JAX forward's outputs
and checks saved in ``tests/fixtures/torch_port_query_b2.npz``
(``tools/make_torch_port_fixtures.py query``: lane 0 a valid witness on an
identity-state path of 6 live levels, lane 1 on 3 live levels with one
check broken), bit for bit, and against ``ingest/identity``'s oracles on
the same inputs. The parts the JAX package runs quickly on the CPU (dg1
field extraction, the citizenship check) are compared live on seeded
inputs. The identity-state proof is also checked on a real multi-leaf tree,
the JAX package's ``ingest/masterlist.SparseMerkleTree``. A slow-tier test
runs the JAX forward live.
"""

import dataclasses
import pathlib
import random

import numpy as np
import pytest
import torch

from passport_zk_circuits_tpu.ingest.masterlist import SparseMerkleTree
from passport_zk_circuits_tpu.models import query_identity as jqi
from passport_zk_circuits_tpu_torch.ingest import identity
from passport_zk_circuits_tpu_torch.ingest import synthetic
from passport_zk_circuits_tpu_torch.models import query_identity as qi
from passport_zk_circuits_tpu_torch.ops import bignum as bn
from passport_zk_circuits_tpu_torch.ops import cuda_poseidon
from passport_zk_circuits_tpu_torch.ops import field as fr
from passport_zk_circuits_tpu_torch.utils.constants.countries import \
    COUNTRIES

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

torch.set_num_threads(1)

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures"
           / "torch_port_query_b2.npz")
# the check each fixture's lane 1 breaks
BROKEN = {3: "identity_state", 1: "citizenship_not_blacklisted"}

rng = random.Random(9191)


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as d:
        return {k: d[k] for k in d.files}


def _arrays(fixture, doc, kind):
    tag = f"query_td{doc}_{kind}_"
    return {k[len(tag):]: v for k, v in fixture.items() if k.startswith(tag)}


def _inputs(fixture, doc):
    return identity.query_inputs(_arrays(fixture, doc, "in"), "cpu")


def _lanes(arrays, doc):
    """The fixture's inputs back as QueryLanes (dg1 bytes, Python ints)."""
    n = arrays["selector"].shape[0]
    ints = {f.name: fr.batch_from_limbs(arrays[f.name])
            for f in dataclasses.fields(identity.QueryLane)
            if f.name not in ("dg1", "siblings", "selector", "root")}
    sibs = [fr.batch_from_limbs(arrays["id_state_siblings"][:, i])
            for i in range(arrays["id_state_siblings"].shape[1])]
    roots = fr.batch_from_limbs(arrays["id_state_root"])
    words = arrays["dg1_words"].T.tolist()
    return [identity.QueryLane(
        dg1=b"".join(int(w).to_bytes(4, "big") for w in words[j])
        [:identity.DG1_BYTES[doc]],
        siblings=[s[j] for s in sibs], selector=int(arrays["selector"][j]),
        root=roots[j], **{k: v[j] for k, v in ints.items()})
        for j in range(n)]


@pytest.mark.parametrize("doc", [3, 1])
def test_forward_matches_jax_fixture_and_oracles(fixture, doc):
    before = (cuda_poseidon.poseidon_ex.launches,
              cuda_poseidon.smt_climb.launches)
    out, checks = qi.forward(_inputs(fixture, doc), doc, 80)
    assert (cuda_poseidon.poseidon_ex.launches,
            cuda_poseidon.smt_climb.launches) == before
    want_out = _arrays(fixture, doc, "out")
    want_checks = _arrays(fixture, doc, "check")
    assert sorted(out) == sorted(want_out)
    assert sorted(checks) == sorted(want_checks)
    for k, v in want_out.items():
        np.testing.assert_array_equal(out[k].numpy(), v.astype(np.int64),
                                      err_msg=k)
    for k, v in want_checks.items():
        np.testing.assert_array_equal(checks[k].numpy(), v, err_msg=k)
    # lane 0 holds every check, lane 1 fails exactly the one it breaks
    assert all(bool(v[0]) for v in checks.values())
    assert [k for k, v in checks.items() if not v[1]] == [BROKEN[doc]]
    lanes = _lanes(_arrays(fixture, doc, "in"), doc)
    for j, lane in enumerate(lanes):
        oracle = identity.expected_query_outputs(lane, doc)
        assert {k: fr.batch_from_limbs(v)[j] for k, v in out.items()} == \
            oracle
    # the paths' live levels: 6 and 3 non-zero siblings, then zeros
    assert [sum(1 for s in lane.siblings if s) for lane in lanes] == [6, 3]


@pytest.mark.parametrize("doc", [3, 1])
def test_extract_dg1_fields_matches_jax(doc):
    dg1s = [identity.make_dg1(rng, doc, citizenship=bytes(
        rng.choice(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ") for _ in range(3)))
        for _ in range(5)]
    w = identity.words(dg1s, identity.QUERY_WORDS)
    got = qi.extract_dg1_fields(bn.to_tensor(w, "cpu"), doc)
    want = jqi.extract_dg1_fields(w, doc)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
        assert fr.batch_from_limbs(got[k]) == [
            identity.field_value(d, *identity.LAYOUT[doc][k]) for d in dg1s]


def test_citizenship_check_matches_jax():
    # table entries, their neighbours (not in the table) and 0
    picks = [rng.choice(COUNTRIES) for _ in range(24)]
    cz = picks + [COUNTRIES[0] - 1, COUNTRIES[-1] + 1, 0, COUNTRIES[5] + 1]
    masks = [rng.randrange(1 << 240) for _ in cz[:-2]] + [0, (1 << 240) - 1]
    # a lane whose own entry is masked, and one whose entry alone is not
    idx = COUNTRIES.index(picks[0])
    masks[0] = 1 << (239 - idx)
    masks[1] = ((1 << 240) - 1) ^ (1 << (239 - COUNTRIES.index(picks[1])))
    czl, ml = fr.batch_to_limbs(cz), fr.batch_to_limbs(masks)
    got = qi.citizenship_check(bn.to_tensor(czl, "cpu"),
                               bn.to_tensor(ml, "cpu"))
    want = jqi.citizenship_check(czl, ml)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    in_table, not_black = (g.tolist() for g in got)
    assert in_table == [True] * 24 + [False] * 4
    assert not not_black[0] and not_black[1]


def test_identity_state_on_a_multi_leaf_tree():
    """Eight registered identities in one 80-level tree (the JAX package's
    SparseMerkleTree): each leaf's proof verifies, a wrong sk does not."""
    n = 8
    tree = SparseMerkleTree(80)
    lanes = []
    for j in range(n):
        lane = identity.QueryLane(
            dg1=identity.make_dg1(rng, 3), sk_identity=rng.randrange(1, fr.P),
            pk_passport_hash=rng.randrange(fr.P), event_id=0, event_data=0,
            siblings=[], identity_counter=j, timestamp=1716482295 + 7 * j)
        commit = synthetic.dg1_commitment_oracle(lane.dg1, 3,
                                                 lane.sk_identity)
        tree.insert(identity.identity_key(lane.sk_identity,
                                          lane.pk_passport_hash),
                    identity.identity_value(commit, lane.identity_counter,
                                            lane.timestamp))
        lanes.append((lane, commit))
    proofs = [tree.prove(identity.identity_key(ln.sk_identity,
                                               ln.pk_passport_hash))
              for ln, _ in lanes]
    assert len({root for root, _ in proofs}) == 1
    assert max(max((i + 1 for i, s in enumerate(sibs) if s), default=0)
               for _, sibs in proofs) >= 3          # live levels
    assert all(identity.smt_root(*k, sibs) == root for k, (root, sibs) in
               zip(tree.leaves.items(), (tree.prove(k) for k in tree.leaves)))

    def t(xs):
        return bn.to_tensor(fr.batch_to_limbs(xs), "cpu")

    args = dict(
        pk_pass_hash=t([ln.pk_passport_hash for ln, _ in lanes]),
        dg_commit=t([c for _, c in lanes]),
        identity_counter=t([ln.identity_counter for ln, _ in lanes]),
        timestamp=t([ln.timestamp for ln, _ in lanes]),
        root=t([root for root, _ in proofs]),
        siblings=bn.to_tensor(np.stack(
            [fr.batch_to_limbs(level) for level in
             zip(*(sibs for _, sibs in proofs))], axis=1), "cpu"))
    sks = [ln.sk_identity for ln, _ in lanes]
    both = {k: torch.cat([v, v], -1) for k, v in args.items()}
    ok = qi.identity_state_verify(t(sks + [s + 1 for s in sks]), **both)
    assert ok.tolist() == [True] * n + [False] * n


@pytest.mark.slow
@pytest.mark.parametrize("doc", [3, 1])
def test_fixture_matches_the_live_jax_forward(fixture, doc):
    import jax
    inp = jqi.QueryInputs(**_arrays(fixture, doc, "in"))
    out, checks = jax.jit(lambda i: jqi.forward(i, doc, 80))(inp)
    for kind, got in (("out", out), ("check", checks)):
        want = _arrays(fixture, doc, kind)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
