"""The port's batch sharding on the CPU: ``parallel/distributed.py`` in two
real processes over gloo (``tests/torch_dist_worker.py``: init by an
explicit coordinator and from the launcher's environment, the (2, 2)
hybrid mesh, each rank's slice of a global batch, ``count_valid`` and the
chained harness across the ranks); ``parallel/mesh.py``'s split, forward
and gather in one process; ``entry.dryrun_multichip(2)`` on the CPU; and
the kernel wrappers' one launch path, ``ops/cuda_build.launch``, which
makes the tensors' device current around every launch.
"""

import ast
import contextlib
import inspect
import os
import pathlib
import socket
import subprocess
import sys
from typing import NamedTuple

import pytest
import torch

from passport_zk_circuits_tpu_torch import entry
from passport_zk_circuits_tpu_torch.ops import cuda_build
from passport_zk_circuits_tpu_torch.parallel import distributed as dist
from passport_zk_circuits_tpu_torch.parallel import mesh as pmesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPS = ROOT / "passport_zk_circuits_tpu_torch" / "ops"
CPU = torch.device("cpu")


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


@pytest.mark.parametrize("mode", ["explicit", "env"])
def test_two_ranks_over_gloo(mode):
    port = _free_port()
    worker = pathlib.Path(__file__).with_name("torch_dist_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), "2", port,
                               mode], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
        assert f"worker {r}: ok" in out


def test_init_distributed_needs_the_whole_coordinator():
    with pytest.raises(ValueError):
        dist.init_distributed("localhost:1", num_processes=2)
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_without_a_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    dist.init_distributed()
    assert not torch.distributed.is_initialized()
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    mesh = dist.hybrid_mesh(local=[CPU, CPU])
    assert mesh.axis_names == ("ici",) and mesh.size == 2
    shards = dist.shard_global_inputs({"x": torch.arange(8).reshape(2, 4)},
                                      mesh)
    assert [s["x"].tolist() for s in shards] == [[[0, 1], [4, 5]],
                                                 [[2, 3], [6, 7]]]


def test_no_cpu_fallback_without_a_card():
    """The mesh takes the card unless the caller names its devices, and the
    group is NCCL unless the caller names gloo."""
    assert inspect.signature(dist.init_distributed).parameters[
        "backend"].default == "nccl"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.local_devices()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.hybrid_mesh()


class _Inp(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_mesh_split_forward_and_gather():
    mesh = pmesh.make_mesh(4, device_type="cpu")
    assert mesh.axis_names == ("batch",) and mesh.size == 4
    assert pmesh.batch_spec(3) == (None, None, "batch")
    inp = _Inp(torch.arange(24).reshape(3, 8), torch.arange(8) % 3 == 0)
    shards = pmesh.shard_inputs(inp, mesh)
    assert len(shards) == 4
    assert all(s.a.shape == (3, 2) and s.b.shape == (2,) for s in shards)
    fwd = pmesh.sharded_forward(lambda x: {
        "y": x.a * 2, "flow_ok": ~x.b, "sig_ok": x.a[0] >= 0,
        "smt_ok": x.a[1] >= 0}, inp, mesh)
    outs = fwd(inp)                       # not sharded first: run shards it
    assert len(outs) == 4
    assert torch.equal(pmesh.gather(outs)["y"], inp.a * 2)
    assert int(pmesh.count_valid(outs, mesh)) == 5
    assert int(pmesh.count_valid(fwd(shards)[0])) == 1
    with pytest.raises(ValueError):
        pmesh.shard_inputs(_Inp(torch.zeros(3, 6), torch.zeros(6)), mesh)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError):
            pmesh.make_mesh(2)


def test_entry_gives_the_flagship_forward_and_its_inputs():
    fn, (inp,) = entry.entry("cpu")
    assert inp.sk_identity.shape == (16, 8)
    assert inp.passport.slave_branches.shape == (16, 80, 8)
    assert inp.sk_identity.device == CPU and callable(fn)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.entry()


def test_dryrun_multichip_on_the_cpu(capsys):
    assert entry.dryrun_multichip(2, device_type="cpu") == 4
    assert "dryrun_multichip(2): ok, 4 witnesses valid" in \
        capsys.readouterr().out


# -- the kernels' launch path -------------------------------------------------

def _wrapper_modules():
    return sorted(p for p in OPS.glob("cuda_*.py") if p.name !=
                  "cuda_build.py")


def test_every_wrapper_launches_through_cuda_build_launch():
    """No wrapper reaches the library, a stream or the current device but
    through cuda_build.launch, and the wrappers name every C entry point
    of the library."""
    entries = set()
    for path in _wrapper_modules():
        tree = ast.parse(path.read_text())
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute):
                assert n.attr not in ("library", "stream_of", "device") or \
                    not (isinstance(n.value, ast.Name) and n.value.id in (
                        "cuda_build", "cuda")), (path.name, n.attr)
                assert not n.attr.startswith("pzk_"), (path.name, n.attr)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and n.value.startswith("pzk_"):
                entries.add(n.value)
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and
                 isinstance(n.func, ast.Attribute) and n.func.attr ==
                 "launch" and getattr(n.func.value, "id", "") ==
                 "cuda_build"]
        assert calls, f"{path.name} never calls cuda_build.launch"
    assert entries == set(cuda_build._SIGNATURES)


def test_launch_makes_the_tensors_device_current(monkeypatch):
    """launch calls the entry with the stream last, inside
    torch.cuda.device(tensor's device), and raises on an error code."""
    seen = []

    @contextlib.contextmanager
    def device(d):
        seen.append(("enter", d))
        yield
        seen.append(("exit", d))

    class Lib:
        def pzk_fake(self, *args):
            seen.append(("call", args))
            return args[0]

        def pzk_error_string(self, rc):
            return b"fake error"

    lib = Lib()
    monkeypatch.setattr(cuda_build, "library", lambda: lib)
    monkeypatch.setattr(cuda_build, "stream_of", lambda t: 77)
    monkeypatch.setattr(torch.cuda, "device", device)
    t = torch.zeros(2)
    cuda_build.launch("fake", "pzk_fake", t, 0, 5)
    assert seen == [("enter", t.device), ("call", (0, 5, 77)),
                    ("exit", t.device)]
    with pytest.raises(RuntimeError, match="fake: CUDA error 3: fake error"):
        cuda_build.launch("fake", "pzk_fake", t, 3)
