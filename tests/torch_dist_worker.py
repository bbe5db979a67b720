"""One rank of the two-process gloo run of the port's
``parallel/distributed.py`` (``tests/test_torch_distributed.py``).

    python tests/torch_dist_worker.py RANK WORLD PORT explicit|env

Joins the group through ``init_distributed``: with an explicit coordinator
("explicit"), or from the launcher's environment variables ("env"). Each
rank holds two CPU "devices", so the ranks form a (2, 2) ("dcn", "ici")
hybrid mesh. Every rank passes the same global batch to
``shard_global_inputs`` and keeps its own slice, split over its two
devices; the sums of the slices, all_reduce'd, must give the global sum.
``count_valid`` counts verdicts that differ by rank across both ranks,
and ``throughput_harness`` runs its chained steps on a small stand-in
forward. Prints "worker RANK: ok" at the end.
"""

import os
import sys
from typing import NamedTuple

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from passport_zk_circuits_tpu_torch.parallel import distributed as dist  # noqa: E402
from passport_zk_circuits_tpu_torch.parallel import mesh as pmesh  # noqa: E402

CPU = torch.device("cpu")


class Inputs(NamedTuple):
    x: torch.Tensor                  # (3, B)
    sk_identity: torch.Tensor        # (16, B)


def stand_in_forward(inp):
    """The forward's output keys on (16, B) and (B,) tensors: lane j is
    valid unless x[0, j] is a multiple of 5."""
    h = (inp.sk_identity * 3 + 1) & 0xFFFF
    ok = inp.x[0] % 5 != 0
    return {"passport_hash": h, "pk_identity_hash": h ^ 0x5A5A,
            "flow_ok": ok, "sig_ok": torch.ones_like(ok),
            "smt_ok": torch.ones_like(ok)}


def main():
    rank, world, port, mode = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    if mode == "explicit":
        dist.init_distributed(f"localhost:{port}", world, rank,
                              backend="gloo")
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=port)
        dist.init_distributed(backend="gloo")
    assert dist.process_count() == world and dist.process_index() == rank

    mesh = dist.hybrid_mesh(local=[CPU, CPU])
    assert mesh.axis_names == ("dcn", "ici"), mesh.axis_names
    assert mesh.devices.shape == (world, 2), mesh.devices.shape
    assert mesh.devices[rank, 1] == (rank, 1)

    # the same global batch on every rank; each keeps its slice
    B = 4 * world
    g = torch.arange(3 * B, dtype=torch.int64).reshape(3, B)
    shards = dist.shard_global_inputs({"x": g}, mesh)
    assert len(shards) == 2 and all(s["x"].shape == (3, 2) for s in shards)
    assert torch.equal(torch.cat([s["x"] for s in shards], -1),
                       g[:, 4 * rank:4 * rank + 4])
    total = dist.all_reduce_scalar(sum(int(s["x"].sum()) for s in shards))
    assert total == int(g.sum()), (total, int(g.sum()))

    # count_valid across ranks: rank r marks r + 1 of its 4 lanes invalid
    outs = [{"flow_ok": torch.tensor([True, True]),
             "sig_ok": torch.tensor([i * 2 + j > rank for j in range(2)]),
             "smt_ok": torch.tensor([True, True])} for i in range(2)]
    want = sum(4 - (r + 1) for r in range(world))
    assert dist.count_valid(outs) == want, (dist.count_valid(outs), want)

    # the chained harness on the stand-in forward
    sk = torch.arange(16 * B, dtype=torch.int64).reshape(16, B) & 0xFFFF
    inp = dist.shard_global_inputs(Inputs(g, sk), mesh)
    stats = dist.throughput_harness(stand_in_forward, inp, mesh, iters=2)
    bad = int((g[0] % 5 == 0).sum())
    assert stats["batch"] == B and stats["valid"] == B - bad, stats
    assert stats["devices"] == 2 * world and stats["processes"] == world
    assert stats["witnesses_per_sec"] > 0
    print(f"worker {rank}: ok")


if __name__ == "__main__":
    main()
