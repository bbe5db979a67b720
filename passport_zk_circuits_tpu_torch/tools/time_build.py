"""Time the kernel build two ways: ``ops/cuda_build``'s parallel build (one
nvcc process per ``csrc/*.cu``, all started together, then one link) and a
single nvcc command over all the sources.

    python -m passport_zk_circuits_tpu_torch.tools.time_build

Each of ROUNDS rounds runs both, alternating which goes first, into
``passport_zk_circuits_tpu_torch/_build/time_build/`` (removed at the end),
and prints the seconds of each.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

from ..ops import cuda_build

ROUNDS = 2


def parallel(so) -> None:
    cuda_build.build(so)


def one_nvcc(so) -> None:
    sources = [str(f) for f in sorted(cuda_build.CSRC.glob("*.cu"))]
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                           "-shared", "-o", str(so), *sources],
                          cwd=cuda_build.CSRC, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")


def main() -> int:
    out = cuda_build.BUILD_DIR / "time_build"
    out.mkdir(parents=True, exist_ok=True)
    n_src = len(list(cuda_build.CSRC.glob("*.cu")))
    print(f"{n_src} sources, {len(os.sched_getaffinity(0))} CPUs")
    ways = [parallel, one_nvcc]
    try:
        for r in range(ROUNDS):
            for way in ways if r % 2 == 0 else ways[::-1]:
                so = out / f"{way.__name__}_{r}.so"
                t0 = time.perf_counter()
                way(so)
                print(f"round {r} {way.__name__:8s} "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
