"""The port's QueryIdentity R1CS lowering (``circuit/query_identity``)
against the JAX package's, tolerance 0: TD3 and TD1 at batch 2, built by
both packages on the same lanes (``ingest/identity``: identity-state paths
of 6 and 3 live levels, the lowering's inputs from ``lowering_inputs``;
``torch_lowering_pair``), whose public values also equal the port's Query
forward on the CPU (every check of which holds) and the oracles.
"""

import random

import pytest
import torch

from passport_zk_circuits_tpu_torch.ingest import identity
from passport_zk_circuits_tpu_torch.models import query_identity as qi
from passport_zk_circuits_tpu_torch.ops import field as fr

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)
from torch_lowering_pair import assert_equal_circuits, build_both, mods

torch.set_num_threads(1)


@pytest.mark.parametrize("doc", [3, 1])
def test_query_lowering_equals_jax_and_the_port_forward(doc):
    rng = random.Random(300 + doc)
    lanes = identity.with_roots([identity.QueryLane(
        dg1=identity.make_dg1(rng, doc), sk_identity=rng.randrange(1, fr.P),
        pk_passport_hash=rng.randrange(fr.P), event_id=rng.randrange(fr.P),
        event_data=rng.randrange(fr.P),
        siblings=identity.live_siblings(rng, n_live),
        selector=(1 << 16) - 1 if doc == 3 else (1 << 18) - 1,
        timestamp=1716482295 + j, identity_counter=3 + j)
        for j, n_live in enumerate((6, 3))], doc)
    inp = identity.lowering_inputs(lanes)
    names = list(identity.expected_query_outputs(lanes[0], doc))

    def make(pkg, b):
        cqi, = mods(pkg, "query_identity")
        outs = cqi.build(b, inp, doc)
        assert sorted(outs) == sorted(names)
        return [outs[k] for k in names]

    built = build_both(make)
    assert_equal_circuits(built)
    (b, pub), _ = built
    out, checks = qi.forward(identity.query_inputs(
        identity.query_arrays(lanes), "cpu"), doc, 80)
    assert [fr.batch_from_limbs(out[k]) for k in names] == pub
    assert pub == [[identity.expected_query_outputs(lane, doc)[k]
                    for lane in lanes] for k in names]
    assert all(bool(v.all()) for v in checks.values())


def test_lowering_inputs_need_roots():
    rng = random.Random(5)
    lane = identity.QueryLane(
        dg1=identity.make_dg1(rng, 3), sk_identity=1, pk_passport_hash=2,
        event_id=3, event_data=4, siblings=[0] * 80)
    with pytest.raises(ValueError):
        identity.lowering_inputs([lane])
    inp = identity.lowering_inputs(identity.with_roots([lane, lane], 3))
    assert inp["sk"] == [1, 1] and inp["dg1"] == [lane.dg1] * 2
    assert len(inp["siblings"]) == 80 and inp["siblings"][0] == [0, 0]
