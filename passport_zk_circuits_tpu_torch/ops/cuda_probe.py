"""K9: the probe battery (csrc/probe.cu), each probe checked bit for bit
against its plain PyTorch version.

Replaces ``run_kernel`` of ``tools/probe_mosaic.py``, a battery that found
what the Pallas TPU compiler accepts. The card's battery checks what the
port's kernels rely on (int64 limb I/O, wide products, large dynamic shared
memory, a refused launch raising) and what their redesigns will need
(warp shuffles, cp.async, bulk copies on an mbarrier, int8 mma.sync, thread
block clusters). The last three probes run K6, K3 and K4 at B = 128 against
the Python-int oracles, as ``probe_mosaic.py``'s field_mul, poseidon_t3 and
smt_climb do.

One kernel runs every kernel probe: a block takes the role of one probe
from a table that ``battery_plan`` computes. ``probe`` launches one probe
(its own launch, so a hang names it); ``battery`` launches the kernel
probes of ``BATTERY`` at once, one output each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import bignum as bn
from . import cuda_build
from . import cuda_field
from . import cuda_poseidon
from . import field as fr
from . import smt
from ..utils import poseidon_ref as pref

B = 128
THREADS = 1024                      # csrc/probe.cu kThreads: every block
ASYNC_WORDS = 2048                  # csrc/probe.cu kAsyncWords
SMEM_WORDS = 51200                  # 200 KB of 32-bit words
MMA_TILES = 8

# csrc/probe.cu's ids are the positions in this tuple
KERNEL_PROBES = ("basic", "mul_wide", "smem_dynamic_large", "refused_launch",
                 "shfl_carry", "cp_async", "bulk_copy_mbarrier", "mma_s8",
                 "cluster_dsmem")
ORACLE_PROBES = ("field_mul", "poseidon_t3", "smt_climb")
PROBES = KERNEL_PROBES + ORACLE_PROBES
# the kernel probes of one battery launch: a refused launch runs alone
BATTERY = tuple(n for n in KERNEL_PROBES if n != "refused_launch")
# probes whose work is one block's shared memory
ONE_BLOCK = ("smem_dynamic_large", "cp_async", "bulk_copy_mbarrier")


def inputs(name: str, device, seed: int = 0):
    """(in0, in1 or None) of a kernel probe, from a seeded numpy RNG."""
    rs = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    if name in ("basic", "refused_launch"):
        return t(np.arange(16 * B).reshape(16, B) % 0xFFFF), None
    if name == "mul_wide":
        return (t(rs.randint(0, 1 << 32, 16 * B, dtype=np.uint64)),
                t(rs.randint(0, 1 << 32, 16 * B, dtype=np.uint64)))
    if name == "smem_dynamic_large":
        return t(rs.randint(0, 1 << 32, SMEM_WORDS, dtype=np.uint64)), None
    if name == "shfl_carry":             # limbs < 2^17: carries of 0 or 1
        a = rs.randint(0, 1 << 17, (16, B))
        a[:, 0], a[:, 1], a[:, 2] = 0x1FFFF, 0xFFFF, 0x10000  # long runs
        a[0, 1] = 0x10000
        return t(a), None
    if name in ("cp_async", "bulk_copy_mbarrier"):
        return t(rs.randint(-(1 << 62), 1 << 62, ASYNC_WORDS)), None
    if name == "mma_s8":
        return (t(rs.randint(-128, 128, (MMA_TILES, 16, 32))),
                t(rs.randint(-128, 128, (MMA_TILES, 32, 8))))
    if name == "cluster_dsmem":
        return t(rs.randint(-(1 << 62), 1 << 62, 8 * 256)), None
    raise ValueError(f"unknown kernel probe {name!r}")


def plain(name: str, in0, in1=None):
    """Plain PyTorch version of a kernel probe."""
    if name == "basic":
        return (in0 * in0 + (in0 >> 3)) & 0xFFFF
    if name == "refused_launch":
        raise RuntimeError("refused_launch: 2048 threads per block exceed "
                           "the card's 1024")
    if name == "mul_wide":            # 16-bit halves keep int64 exact
        p0, p1 = (in0 & 0xFFFF) * in1, (in0 >> 16) * in1
        lo = (p0 + ((p1 & 0xFFFF) << 16)) & 0xFFFFFFFF
        return torch.cat([lo, (p1 + (p0 >> 16)) >> 16])
    if name in ("smem_dynamic_large", "bulk_copy_mbarrier"):
        return in0.flip(0)
    if name == "shfl_carry":
        return bn.carry_normalize(in0, 16)
    if name == "cp_async":
        return torch.roll(in0, -1)
    if name == "mma_s8":              # integer product without torch.matmul
        return (in0.unsqueeze(-1) * in1.unsqueeze(1)).sum(2)
    if name == "cluster_dsmem":
        return in0.reshape(-1, 2, 128).flip(1).reshape(-1)
    raise ValueError(f"unknown kernel probe {name!r}")


def battery_plan(ins):
    """The role table of one launch of the kernel probes of ins ({name:
    (in0, in1 or None)}), in ins's order: [(name, n, first block, blocks)].
    n is what the probe's body takes (B numbers for shfl_carry, tiles for
    mma_s8, else in0's words). The roles lie back to back from block 0,
    each on an even block with an even count (clusters of two blocks), and
    each has a block of THREADS threads for every THREADS threads of work:
    a thread a word (basic, mul_wide, cluster_dsmem), 16 a number
    (shfl_carry), a warp a tile (mma_s8); the ONE_BLOCK probes one block."""
    plan, first = [], 0
    for name, (in0, _) in ins.items():
        if name not in KERNEL_PROBES:
            raise ValueError(f"unknown kernel probe {name!r}")
        n = {"shfl_carry": in0.shape[-1], "mma_s8": in0.shape[0]}.get(
            name, in0.numel())
        threads = {"shfl_carry": 16 * n, "mma_s8": 32 * n}.get(name, n)
        blocks = 1 if name in ONE_BLOCK else -(-threads // THREADS)
        blocks = max(2, blocks + blocks % 2)
        plan.append((name, n, first, blocks))
        first += blocks
    return plan


def _out(name, in0):
    shape = {"mul_wide": (2 * in0.numel(),),
             "mma_s8": (in0.shape[0], 16, 8)}.get(name, in0.shape)
    return torch.empty(shape, dtype=torch.int64, device=in0.device)


def probe(name: str, in0, in1=None):
    """Run a kernel probe. A CPU tensor takes the plain version; a CUDA
    tensor launches the battery's kernel with this probe alone."""
    if not in0.is_cuda:
        return plain(name, in0, in1)
    ins = [x.contiguous() for x in (in0, in1) if x is not None]
    cuda_build.require_cuda_int64("probe", *ins)
    ((_, n, _, blocks),) = battery_plan({name: (in0, in1)})
    out = _out(name, in0)
    cuda_build.launch(f"probe {name}", "pzk_probe", in0,
                      KERNEL_PROBES.index(name), ins[0].data_ptr(),
                      ins[1].data_ptr() if len(ins) > 1 else None,
                      out.data_ptr(), n, blocks)
    probe.launches += 1
    return out


probe.launches = 0


def battery(ins):
    """Run the kernel probes of ins ({name: (in0, in1 or None)}, each of
    BATTERY at most once) together; returns {name: output}. CPU tensors
    take the plain versions; CUDA tensors launch the kernel once, with
    battery_plan's table."""
    if not ins or not set(ins) <= set(BATTERY):
        raise ValueError(f"battery: probes of {BATTERY}, got {list(ins)}")
    tensors = [x for pair in ins.values() for x in pair if x is not None]
    if not any(x.is_cuda for x in tensors):
        return {name: plain(name, *pair) for name, pair in ins.items()}
    cuda_build.require_cuda_int64("probe battery", *tensors)
    ins = {name: tuple(None if x is None else x.contiguous() for x in pair)
           for name, pair in ins.items()}
    plan = battery_plan(ins)
    outs = {name: _out(name, in0) for name, (in0, _) in ins.items()}
    k = len(plan)
    ptrs, ints = ctypes.c_void_p * k, ctypes.c_int * k

    def ptr(x):
        return None if x is None else x.data_ptr()
    ids, in0s, in1s, out_ptrs, ns, firsts, counts = zip(*[
        (KERNEL_PROBES.index(name), ptr(ins[name][0]), ptr(ins[name][1]),
         outs[name].data_ptr(), n, first, blocks)
        for name, n, first, blocks in plan])
    cuda_build.launch("probe battery", "pzk_probe_battery", tensors[0], k,
                      ints(*ids), ptrs(*in0s), ptrs(*in1s), ptrs(*out_ptrs),
                      ints(*ns), ints(*firsts), ints(*counts))
    battery.launches += 1
    return outs


battery.launches = 0


def mismatches(got, want):
    """The probes whose outputs in got differ from want ({name: tensor})."""
    return [name for name in want if not torch.equal(got[name], want[name])]


def _oracle_probe(name: str, device, seed: int):
    rs = np.random.RandomState(seed)
    if name == "field_mul":
        xs = [int(rs.randint(0, 1 << 62)) * int(rs.randint(0, 1 << 62))
              for _ in range(B)]
        ys = [int(rs.randint(0, 1 << 62)) * int(rs.randint(0, 1 << 62))
              for _ in range(B)]
        got = fr.batch_from_limbs(cuda_field.mul(
            bn.to_tensor(fr.batch_to_limbs(xs), device),
            bn.to_tensor(fr.batch_to_limbs(ys), device)))
        return got == [x * y % fr.P for x, y in zip(xs, ys)]
    if name == "poseidon_t3":
        xs = list(range(1, B + 1))
        a = bn.to_tensor(fr.batch_to_limbs(xs), device)
        got = fr.batch_from_limbs(cuda_poseidon.poseidon_ex([a, a])[:, 0])
        return got == [pref.poseidon([x, x]) for x in xs]
    if name == "smt_climb":
        key, value, bb = 5, 7, 8
        root = pref.poseidon([key, value, 1])

        def col(v):
            return bn.to_tensor(fr.batch_to_limbs([v] * bb), device)
        sibs = torch.zeros((16, 80, bb), dtype=torch.int64, device=device)
        ok, _ = smt.verify(col(root), col(key), col(value), sibs)
        return bool(ok.all())
    raise ValueError(f"unknown probe {name!r}")


def run(name: str, device, seed: int = 0) -> None:
    """Run one probe on device and check it; raises AssertionError if the
    result is wrong (or, for refused_launch, if the launch was not
    refused)."""
    if name in ORACLE_PROBES:
        if not _oracle_probe(name, device, seed):
            raise AssertionError(f"probe {name}: differs from the oracle")
        return
    in0, in1 = inputs(name, device, seed)
    if name == "refused_launch":
        try:
            probe(name, in0, in1)
        except RuntimeError:
            return
        raise AssertionError("probe refused_launch: the launch was accepted")
    got, want = probe(name, in0, in1), plain(name, in0, in1)
    if not torch.equal(got, want):
        raise AssertionError(f"probe {name}: kernel differs from plain")


def run_battery(device, names=BATTERY) -> None:
    """Run the kernel probes names (of BATTERY) in one battery on device and
    check each output; raises AssertionError naming every probe that
    differs from its plain version."""
    ins = {name: inputs(name, device) for name in names}
    bad = mismatches(battery(ins), {name: plain(name, *pair)
                                    for name, pair in ins.items()})
    if bad:
        raise AssertionError(f"probe battery: {', '.join(bad)} differ from "
                             "plain")
