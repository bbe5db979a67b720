"""Scale-out over processes, one a GPU: torch.distributed init, the
(nodes x local GPUs) layout, each rank's slice of the batch, the verdict
count across ranks and the chained throughput harness.

Counterpart of ``passport_zk_circuits_tpu/parallel/distributed.py``.
Passport instances are independent, so the design is pure data
parallelism: every rank takes a contiguous slice of the global batch
(the minor-most axis of every tensor), splits it over its own devices
(``parallel/mesh``) and runs the forward; the only traffic between ranks
is the ``all_reduce`` of the valid count (and of the batch and the step
time in the harness). NCCL carries it between GPUs, gloo on the CPU.

Nothing here probes a private API: ``init_distributed`` with an explicit
coordinator calls ``init_process_group`` and lets every failure
propagate (a two-rank run that went on as a world of one would be a wrong
topology, not a graceful one); with no arguments it reads the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), or runs a world
of one when there is none.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as pmesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "nccl") -> None:
    """Join (or form) the process group.

    coordinator: "host:port" (or an init-method URL such as
    "tcp://host:port") with num_processes and process_id: init_process_group
    there, every failure raised. With no arguments: the launcher's
    environment when it sets RANK and WORLD_SIZE (init_method env://),
    else a world of one (no group). A group already formed is kept.
    backend: "nccl" between GPUs; a CPU run names "gloo"."""
    if dist.is_initialized():
        return
    if coordinator is None and num_processes is None and process_id is None:
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if "MASTER_ADDR" not in os.environ:
                raise RuntimeError("init_distributed: RANK and WORLD_SIZE "
                                   "are set but MASTER_ADDR is not")
            dist.init_process_group(backend, init_method="env://")
        return
    if None in (coordinator, num_processes, process_id):
        raise ValueError("init_distributed: give the coordinator, the "
                         "number of processes and this process's id")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices():
    """This rank's devices: its current CUDA device (a launcher sets it
    with torch.cuda.set_device(local_rank)). Raises where there is no
    card: a CPU run passes its devices to ``hybrid_mesh`` itself."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass hybrid_mesh(local=...) "
                           "to run on the CPU")
    return [torch.device("cuda", torch.cuda.current_device())]


def hybrid_mesh(batch_axes: tuple[str, str] = ("dcn", "ici"),
                local=None) -> pmesh.Mesh:
    """2-D mesh: processes (DCN, the network between nodes) major, each
    process's devices (ICI, the links within a node) minor; an entry is
    (rank, local index). One process gives a flat 1-axis mesh of its
    devices labelled with the ICI axis name. local: this rank's devices
    (``local_devices()`` when None); every rank must have as many."""
    local = tuple(local_devices() if local is None else local)
    n = process_count()
    if n == 1:
        arr = np.empty(len(local), dtype=object)
        arr[:] = local
        return pmesh.Mesh(arr, (batch_axes[1],), local)
    counts = [None] * n
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise RuntimeError(f"hybrid_mesh: ranks have {counts} devices")
    arr = np.empty((n, len(local)), dtype=object)
    for r in range(n):
        for i in range(len(local)):
            arr[r, i] = (r, i)
    return pmesh.Mesh(arr, tuple(batch_axes), local)


def shard_global_inputs(tree, mesh: pmesh.Mesh):
    """Every rank passes the same global inputs and keeps its own slice of
    the minor-most (batch) axis, split over its local devices: a list of
    trees, one a local device. Rank r of n takes the r-th of n equal,
    contiguous slices; no data crosses between ranks."""
    n, r = process_count(), process_index()

    def mine(x):
        t = x if torch.is_tensor(x) else torch.as_tensor(
            np.asarray(x, dtype=np.int64))
        return pmesh.split_leaf(t, n)[r]

    return pmesh.shard_inputs(pmesh.tree_map(mine, tree), mesh)


def _reduce_device():
    """Where a collective's tensor must live: the current CUDA device for
    NCCL, the CPU for gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_scalar(x, op=None):
    """A Python number reduced over the ranks (sum unless op says)."""
    t = torch.tensor([x], dtype=torch.float64 if isinstance(x, float)
                     else torch.int64, device=_reduce_device())
    if dist.is_initialized():
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM)
    return t.item()


def count_valid(outs) -> int:
    """Global count of fully valid witnesses (flow_ok & sig_ok & smt_ok):
    this rank's count over its per-device outputs, all_reduce'd."""
    return int(all_reduce_scalar(int(pmesh.count_valid(outs))))


def throughput_harness(forward_fn, inputs, mesh: pmesh.Mesh, iters: int = 5):
    """Witnesses/s at the current topology, by the chained method of
    ``bench.py``: each step's sk_identity comes from the previous step's
    outputs, so steps serialise and every one must run; a fetched value
    that depends on the last step fences the chain. inputs: this rank's
    per-device RegisterIdentityInputs (``shard_global_inputs``) or one
    tree. Returns the JAX harness's keys: batch and valid (global),
    sec_per_step (the slowest rank's), witnesses_per_sec (global and per
    device), devices and processes."""
    if not pmesh.is_sharded(inputs, mesh):
        inputs = pmesh.shard_inputs(inputs, mesh)

    def step(inp):
        out = forward_fn(inp)
        mix = out["passport_hash"] ^ out["pk_identity_hash"]
        sk = inp.sk_identity ^ mix
        sk[-1] &= 0x3FF                      # stays a valid (< 2^250) sk
        return inp._replace(sk_identity=sk), out

    xs, outs = zip(*[step(x) for x in inputs])
    for o in outs:
        o["flow_ok"].cpu()                   # first run fenced
    if dist.is_initialized():
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        xs, outs = zip(*[step(x) for x in xs])
    for x, o in zip(xs, outs):
        pmesh.valid_mask(o).cpu()
        x.sk_identity[0:1, 0:1].cpu()
    dt = all_reduce_scalar((time.perf_counter() - t0) / iters,
                           dist.ReduceOp.MAX if dist.is_initialized()
                           else None)
    batch = int(all_reduce_scalar(sum(int(x.sk_identity.shape[-1])
                                      for x in xs)))
    n_ok = count_valid(list(outs))
    n_dev = mesh.size
    return {
        "batch": batch,
        "valid": n_ok,
        "sec_per_step": dt,
        "witnesses_per_sec": batch / dt,
        "witnesses_per_sec_per_chip": batch / dt / n_dev,
        "devices": n_dev,
        "processes": process_count(),
    }
