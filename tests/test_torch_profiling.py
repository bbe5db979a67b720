"""The port's utils/profiling against the JAX package's: the same
field-multiply cost model for every signature algorithm of the registry,
with and without active authentication; and the stage timer."""

import pytest
import torch

from passport_zk_circuits_tpu.models import params as jparams
from passport_zk_circuits_tpu.utils import profiling as jprof
from passport_zk_circuits_tpu_torch.models import params
from passport_zk_circuits_tpu_torch.utils import profiling

from jax_xla_route import jax_xla_route  # noqa: F401  (autouse)

NAMES = [f"registerIdentity_{sig}_256_3_4_600_248_{aa}_1496_3_256"
         for sig in sorted(jparams.SIG_ALGOS) for aa in (0, 1, 20)]


@pytest.mark.parametrize("name", NAMES)
def test_field_mul_cost_matches_jax(name):
    p = params.CircuitParams.from_name(name)
    jp = jparams.CircuitParams.from_name(name)
    assert profiling.field_mul_cost(p) == jprof.field_mul_cost(jp)
    assert profiling.witnesses_to_field_muls(p, 12.5) == \
        jprof.witnesses_to_field_muls(jp, 12.5)


def test_stage_timer_accumulates():
    t = profiling.StageTimer()
    for _ in range(2):
        with t.stage("mul", block_on=torch.zeros(1)):
            pass
    assert list(t.times) == ["mul"] and t.times["mul"] >= 0
    assert '"mul"' in t.report()


def test_chain_time_chains_calls():
    seen = []

    def step(x):
        seen.append(int(x))
        return x + 1

    s = profiling.chain_time(step, torch.tensor(0), iters=4)
    assert seen == [0, 1, 2, 3, 4] and s >= 0


def test_trace_writes_a_profile(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64).mul_(2)
    assert list(tmp_path.glob("*.pt.trace.json"))
    assert any(e.key == "aten::mul_" for e in prof.key_averages())
