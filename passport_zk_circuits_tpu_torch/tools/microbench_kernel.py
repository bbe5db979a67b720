"""Cost of each K8 body on the card: one body looped n times inside one
kernel, chained across calls, reported per iteration.

Counterpart of ``tools/microbench_kernel.py``. The simple bodies run 4096
iterations a call, the field bodies 64, as there. Each body is first held
against its plain version at n = 2; a body that differs raises.

    python -m passport_zk_circuits_tpu_torch.tools.microbench_kernel \\
        [--batch 1024] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import cuda_loop
from ..utils.profiling import chain_time

N_ITER = {"u32_mul_add": 4096, "i32_mul_add": 4096, "mask_shift_add": 4096,
          "school": 64, "modmul_barrett16": 64, "modmul_mont32": 64,
          "barrett_only": 64}


def make_inputs(batch: int, device):
    """a in [0, 2^16), c in [1, 2^16) per limb, numpy's default_rng(0) as
    the JAX tool's."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 16, (16, batch))
    c = rng.integers(1, 1 << 16, (16, batch))
    return (torch.from_numpy(a).to(device), torch.from_numpy(c).to(device))


def run(device, batch: int = 1024, iters: int = 3):
    """{body: seconds per iteration}, after checking every body; iters
    chained calls of N_ITER[body] iterations each."""
    a, c = make_inputs(batch, device)
    res = {}
    for body in cuda_loop.BODIES:
        if not torch.equal(cuda_loop.loop(body, a, c, 2),
                           cuda_loop.loop_plain(body, a, c, 2)):
            raise AssertionError(f"K8 body {body} differs from plain")
        n = N_ITER[body]
        res[body] = chain_time(lambda x: cuda_loop.loop(body, x, c, n), a,
                               iters) / n
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("microbench_kernel: no CUDA device", file=sys.stderr)
        return 1
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"device={kind} B={args.batch}")
    for body, s in run(dev, args.batch).items():
        print(f"{body:18s} {s * 1e9:10.2f} ns/op  "
              f"({s / args.batch * 1e12:8.3f} ps/elem)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
