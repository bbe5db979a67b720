"""Profiling helpers: stage timers fenced on the device, a chained-call
timer, a torch.profiler trace, and the cost model in field multiplies.

Counterpart of ``passport_zk_circuits_tpu/utils/profiling.py``. The cost
model is the same static count, copied, so that the port's field-muls/s
figures use the JAX package's denominator (``BASELINE.json``'s second
metric is BN254 field-muls/s).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict

import torch


class StageTimer:
    """Wall-clock per-stage timing, fenced with torch.cuda.synchronize()
    on the device of the tensor given as block_on."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return json.dumps({k: round(v, 6) for k, v in self.times.items()})


def chain_time(step, x0, iters: int = 3) -> float:
    """Seconds per call of step: one warm call, then iters calls chained,
    each on the previous call's output, so that none can be skipped or
    overlapped. Timed with CUDA events on a CUDA tensor, with the host
    clock on the CPU."""
    x = step(x0)
    if not x.is_cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            x = step(x)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(x.device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = step(x)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace (CPU and CUDA activities) into
    log_dir, viewable in TensorBoard or Perfetto. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


# -- field-multiply cost model ----------------------------------------------

def field_mul_cost(p) -> int:
    """Static estimate of BN254 field-muls per RegisterIdentity witness for
    a given CircuitParams: the denominator for field-muls/sec reporting.

    Counts: Poseidon (~(t+3) muls x 65 rounds), SMT climb (80 Poseidon2-ary),
    BabyJubJub ladder (254 x ~27), RSA modexp (bits(e) squarings in k-limb
    units normalized to Fr-mul equivalents), SHA ignored (integer ops)."""
    sig = p.sig
    pose = {2: 250, 3: 330, 4: 400, 5: 470, 6: 540}

    def pose_cost(t):
        return pose.get(t, 540)

    cost = 0
    cost += pose_cost(6) * 2          # pubkey hash + dg1 commitment
    cost += pose_cost(2) * 2          # passport hash + sk hash
    cost += pose_cost(3)              # pk identity hash
    cost += 80 * pose_cost(3) + pose_cost(4)   # SMT climb + leaf
    cost += 254 * 27                  # BabyJubJub ladder
    if p.aa_signature_algo:
        cost += pose_cost(6)
    k_ratio = (sig.key_bits // 256) ** 2
    if sig.family in ("rsa", "rsapss"):
        nmuls = bin(sig.exp).count("1") + sig.exp.bit_length() - 1
        cost += nmuls * k_ratio
    else:
        cost += (64 * 27 + 32 * 16 + 300) * 2   # windowed + fixed-base
    return cost


def witnesses_to_field_muls(p, witnesses_per_sec: float) -> float:
    return witnesses_per_sec * field_mul_cost(p)
