"""K9 of the port (ops/cuda_probe: the probe battery; on the CPU its plain
versions) against the JAX battery's own probe body and numpy, and the role
table of csrc/probe.cu's one kernel.

The ``basic`` probe's body is restated from ``tools/probe_mosaic.py``'s
``p_basic`` (that module sets JAX's compilation cache when imported) and
run through ``pl.pallas_call(..., interpret=True)``, as the JAX package's
tests run Pallas on the CPU. Integer arithmetic: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from passport_zk_circuits_tpu_torch.ops import cuda_probe

SMS = 132                       # an H100 SXM's streaming multiprocessors


def _cpu_inputs(names):
    return {n: cuda_probe.inputs(n, "cpu") for n in names}


def test_basic_matches_the_jax_battery_body():
    """probe_mosaic.py's p_basic, (a * a + (a >> 3)) & 0xFFFF on uint32,
    on seeded 32-bit words, against the port's plain basic probe."""
    a = np.random.RandomState(5).randint(0, 1 << 32, (16, cuda_probe.B),
                                         dtype=np.uint64).astype(np.uint32)

    def k(a_ref, o_ref):
        x = a_ref[:]
        o_ref[:] = (x * x + (x >> 3)) & 0xFFFF
    got = pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct(a.shape, jnp.uint32),
        interpret=True)(a)
    want = cuda_probe.plain("basic", torch.from_numpy(a.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  want.numpy())


def test_mma_s8_matches_numpy_matmul():
    in0, in1 = cuda_probe.inputs("mma_s8", "cpu", seed=3)
    got = cuda_probe.plain("mma_s8", in0, in1)
    assert got.shape == (cuda_probe.MMA_TILES, 16, 8)
    np.testing.assert_array_equal(got.numpy(), np.matmul(in0.numpy(),
                                                         in1.numpy()))


# threads of work a probe's body maps onto its blocks: a thread a word, 16
# threads a number (shfl_carry), a warp a 16x8x32 tile (mma_s8); the
# one-block probes need their one block
WORK = {"basic": lambda a: a.numel(), "refused_launch": lambda a: a.numel(),
        "mul_wide": lambda a: a.numel(),
        "shfl_carry": lambda a: 16 * a.shape[1],
        "mma_s8": lambda a: 32 * a.shape[0],
        "cluster_dsmem": lambda a: a.numel()}


def _check_plan(ins):
    plan = cuda_probe.battery_plan(ins)
    assert [name for name, *_ in plan] == list(ins)
    end = 0
    for name, n, first, blocks in plan:
        in0 = ins[name][0]
        assert first == end, f"{name}: not back to back with the last role"
        assert first % 2 == 0 and blocks % 2 == 0 and blocks >= 2, name
        if name in cuda_probe.ONE_BLOCK:
            assert n == in0.numel()
        else:
            work = WORK[name](in0)
            assert blocks * cuda_probe.THREADS >= work, name
            assert (blocks - 2) * cuda_probe.THREADS < work, name
        end = first + blocks
    return plan, end


def test_battery_plan_of_the_battery():
    """The kernel probes in one launch: roles back to back from block 0, on
    even blocks with even counts, each covering its work; every block holds
    the largest role's 200 KB of shared memory, so one block an SM: the
    launch fits on the card at once. cluster_dsmem's pairs of chunks are
    pairs of blocks."""
    ins = _cpu_inputs(cuda_probe.BATTERY)
    plan, blocks = _check_plan(ins)
    assert len(plan) == len(cuda_probe.BATTERY) == 8
    assert "refused_launch" not in cuda_probe.BATTERY
    assert blocks <= SMS
    assert ins["cluster_dsmem"][0].numel() % (2 * cuda_probe.THREADS) == 0
    assert 4 * cuda_probe.SMEM_WORDS <= 227 * 1024


@pytest.mark.parametrize("name", cuda_probe.KERNEL_PROBES)
def test_battery_plan_of_each_probe_alone(name):
    plan, _ = _check_plan(_cpu_inputs([name]))
    assert plan[0][2] == 0


def test_battery_plan_of_a_reordered_battery():
    _check_plan(_cpu_inputs(cuda_probe.BATTERY[::-1]))


def test_plain_battery_equals_each_plain_probe():
    ins = _cpu_inputs(cuda_probe.BATTERY)
    got = cuda_probe.battery(ins)
    assert list(got) == list(cuda_probe.BATTERY)
    assert cuda_probe.mismatches(got, {n: cuda_probe.plain(n, *pair)
                                       for n, pair in ins.items()}) == []
    assert cuda_probe.battery.launches == 0
    cuda_probe.run_battery("cpu")


def test_mismatches_names_the_changed_probe():
    ins = _cpu_inputs(cuda_probe.BATTERY)
    want = {n: cuda_probe.plain(n, *pair) for n, pair in ins.items()}
    in0, in1 = ins["shfl_carry"]
    changed = in0.clone()
    changed[3, 5] ^= 1
    ins["shfl_carry"] = (changed, in1)
    assert cuda_probe.mismatches(cuda_probe.battery(ins), want) == [
        "shfl_carry"]


@pytest.mark.parametrize("ins", [
    {}, {"refused_launch": (torch.zeros(4, dtype=torch.int64), None)},
    {"field_mul": (torch.zeros(4, dtype=torch.int64), None)}])
def test_battery_refuses_what_it_does_not_run(ins):
    with pytest.raises(ValueError):
        cuda_probe.battery(ins)


@pytest.mark.parametrize("name", cuda_probe.KERNEL_PROBES)
def test_each_kernel_probe_on_the_cpu(name):
    cuda_probe.run(name, "cpu")
    assert cuda_probe.probe.launches == 0
