"""Batch-axis sharding over the devices of one process.

Counterpart of ``passport_zk_circuits_tpu/parallel/mesh.py``. Passport
instances are independent, so the one sharding is the batch axis, the
minor-most axis of every tensor: a mesh's devices each take a contiguous
slice of the lanes, run the same forward on it, and the only reduction is
the count of fully valid witnesses. Where the JAX package lays one global
array over the mesh and jits the forward once, the port holds a list of
per-device input trees and calls the forward once a device; the calls are
issued one after another and the devices run them at the same time.

A mesh lists torch devices: ``make_mesh`` takes the first n CUDA devices,
or n slices on the CPU for a caller that asks for it (the tests).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out over named axes. ``devices`` is an object array
    with one axis a name; in a mesh that spans processes
    (``distributed.hybrid_mesh``) an entry of another process is the pair
    (rank, local index), and ``local`` lists this process's own devices.
    The batch is split over every entry, axis by axis, in C order."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    local: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(n_devices: int | None = None, axis: str = "batch",
              device_type: str = "cuda") -> Mesh:
    """A 1-D mesh of the first n_devices CUDA devices (all of them when
    None), or of n_devices slices on the CPU with device_type "cpu"."""
    if device_type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if not 1 <= n <= have:
            raise RuntimeError(f"make_mesh: {n} CUDA devices asked for, "
                               f"{have} present")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif device_type == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"make_mesh: unknown device type {device_type}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, (axis,), tuple(devs))


def batch_spec(ndim: int, axis: str = "batch"):
    """The partition of a rank-ndim tensor: only the minor-most (batch)
    axis is split, over ``axis``."""
    return (None,) * (ndim - 1) + (axis,)


def tree_map(fn, tree):
    """fn over every leaf (tensor or array) of nested NamedTuples, tuples,
    lists and dicts; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def split_leaf(x, n: int):
    """The n contiguous, equal slices of x's minor-most axis."""
    b = x.shape[-1]
    if b % n:
        raise ValueError(f"batch {b} does not split over {n} devices")
    return [x[..., i * (b // n):(i + 1) * (b // n)] for i in range(n)]


def shard_inputs(tree, mesh: Mesh):
    """Split every leaf of tree along its minor-most (batch) axis over the
    mesh's local devices: a list of trees, one a device, each leaf an
    int64 tensor there (numpy leaves are converted)."""
    n = len(mesh.local)

    def leaf(x, i, device):
        t = x if torch.is_tensor(x) else torch.as_tensor(
            np.asarray(x, dtype=np.int64))
        return split_leaf(t, n)[i].to(device).contiguous()

    return [tree_map(lambda x, i=i, d=d: leaf(x, i, d), tree)
            for i, d in enumerate(mesh.local)]


def is_sharded(inputs, mesh: Mesh) -> bool:
    return isinstance(inputs, list) and len(inputs) == len(mesh.local)


def sharded_forward(forward_fn, example_inp, mesh: Mesh):
    """forward_fn over the mesh: the returned function shards inputs
    itself (``shard_inputs``) unless they come as one tree a device, and
    returns the list of per-device outputs. example_inp fixes the tree's
    structure, as the JAX version's in_shardings do."""
    fields = getattr(example_inp, "_fields", None)

    def run(inputs):
        if not is_sharded(inputs, mesh):
            if fields is not None and getattr(inputs, "_fields",
                                              None) != fields:
                raise TypeError("sharded_forward: inputs do not have the "
                                "example's structure")
            inputs = shard_inputs(inputs, mesh)
        return [forward_fn(x) for x in inputs]

    return run


def gather(outs, device=None):
    """Per-device outputs -> one tree, every leaf concatenated along its
    minor-most axis on device (the first shard's device when None)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: gather([o[k] for o in outs], device) for k in first}
    if first is None:
        return None
    device = first.device if device is None else device
    return torch.cat([o.to(device) for o in outs], -1)


def valid_mask(out):
    """flow_ok & sig_ok & smt_ok of one forward's outputs."""
    return out["flow_ok"] & out["sig_ok"] & out["smt_ok"]


def count_valid(outs, mesh: Mesh | None = None):
    """Count of fully valid witnesses over the per-device outputs (or one
    output dict), as a 0-d int64 tensor on the first shard's device."""
    if isinstance(outs, dict):
        outs = [outs]
    dev = outs[0]["flow_ok"].device
    return sum(valid_mask(o).sum().to(dev) for o in outs)
