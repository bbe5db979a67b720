"""Time K3's candidate designs beside the shipped kernel at the flagship
step's Poseidon widths (t = 2, 3, 4, 6), B = 1024, on one CUDA card.

    python -m passport_zk_circuits_tpu_torch.tools.k3_designs [--batch 1024]

The designs, all built from the package's headers:

- team: a team of eight threads a lane, one word each (csrc/fr_team.cuh),
  running the generic body poseidon::permute<T> as K4 does, its pack in
  shared memory, one warp (four lanes) a block;
- split W: the lane split over its elements, each element over a team of
  8 / W threads, W words a thread (poseidon::poseidon_lane<T, W>, the
  shipped body; W = 8 is one element a thread with fr_bn254.cuh's
  product), for every W whose lane fits a warp. The shipped kernel is split
  W = 2 up to t = 8.

The designs' source is compiled by nvcc into ``_build/k3_designs/``. Each
design's output is held bit-equal to the shipped kernel's
(``ops/cuda_poseidon.poseidon_ex``), then every design is timed twice, in
turns forward and back: CUDA events around 10 launches after a warm one.
Prints one line per width. Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import random
import subprocess
import sys

import torch

from ..ops import bignum as bn
from ..ops import cuda_build
from ..ops import cuda_poseidon
from ..ops import field as fr
from ..ops import poseidon as pos

WIDTHS = (2, 3, 4, 6)
DESIGNS = ((0, "team"), (1, "split W=1"), (2, "split W=2"),
           (4, "split W=4"), (8, "split W=8"))
SRC = r"""
#include <cuda_runtime.h>
#include "fr_team.cuh"
#include "poseidon.cuh"
template <int T>
__global__ void __launch_bounds__(32) k3_team(
    const int64_t* __restrict__ state, int64_t* __restrict__ out,
    const uint32_t* __restrict__ pack, int nP, int B) {
  extern __shared__ uint32_t k[];
  const int words = fr::NW * poseidon::pack_entries(T, nP);
  for (int w = threadIdx.x; w < words; w += blockDim.x) k[w] = pack[w];
  __syncthreads();
  const frt::Team tm = frt::device_team();
  const long lane = (long)blockIdx.x * 4 + threadIdx.x / frt::TEAM;
  const long mine = lane < B ? lane : B - 1;
  uint32_t st[T];
  for (int j = 0; j < T; ++j)
    st[j] = tm.to_mont(tm.load(state + 16L * j * B + mine, B));
  poseidon::permute<T>(tm, st, k, nP);
  const uint32_t r = tm.from_mont(st[0]);
  if (lane < B) tm.store(r, out + lane, B);
}
template <int T, int W>
__global__ void __launch_bounds__(32) k3_split(
    const int64_t* __restrict__ state, int64_t* __restrict__ out,
    const uint32_t* __restrict__ pack, int nP, int B) {
  constexpr int GL = poseidon::lane_threads(T, W);
  const long lane = ((long)blockIdx.x * blockDim.x + threadIdx.x) / GL;
  poseidon::poseidon_lane<T, W>(wp::device_group<GL>(), state, out, pack,
                                nP, 1, lane, B);
}
template <int T, int W>
int split(const int64_t* state, int64_t* out, const uint32_t* pack, int nP,
          int B, cudaStream_t s) {
  if constexpr (poseidon::lane_threads(T, W) > 32) {
    return (int)cudaErrorInvalidValue;
  } else {
    const long threads = (long)B * poseidon::lane_threads(T, W);
    k3_split<T, W><<<(threads + 31) / 32, 32, 0, s>>>(state, out, pack, nP,
                                                     B);
    return 0;
  }
}
template <int T>
int launch(int design, const int64_t* state, int64_t* out,
           const uint32_t* pack, int nP, int B, cudaStream_t s) {
  switch (design) {
    case 0: {
      const size_t smem = 4 * fr::NW * poseidon::pack_entries(T, nP);
      k3_team<T><<<(B + 3) / 4, 32, smem, s>>>(state, out, pack, nP, B);
      return 0;
    }
    case 1: return split<T, 1>(state, out, pack, nP, B, s);
    case 2: return split<T, 2>(state, out, pack, nP, B, s);
    case 4: return split<T, 4>(state, out, pack, nP, B, s);
    case 8: return split<T, 8>(state, out, pack, nP, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
// design: 0 team, W = 1, 2, 4, 8 split; returns cudaErrorInvalidValue
// for a design whose lane does not fit a warp
extern "C" int k3_design_launch(int design, const int64_t* state,
                                int64_t* out, const uint32_t* pack, int t,
                                int nP, int B, cudaStream_t s) {
  int rc = (int)cudaErrorInvalidValue;
  switch (t) {
    case 2: rc = launch<2>(design, state, out, pack, nP, B, s); break;
    case 3: rc = launch<3>(design, state, out, pack, nP, B, s); break;
    case 4: rc = launch<4>(design, state, out, pack, nP, B, s); break;
    case 6: rc = launch<6>(design, state, out, pack, nP, B, s); break;
  }
  return rc ? rc : (int)cudaGetLastError();
}
"""


def build():
    """nvcc SRC into _build/k3_designs/; the loaded library."""
    d = cuda_build.BUILD_DIR / "k3_designs"
    d.mkdir(parents=True, exist_ok=True)
    (d / "k3_designs.cu").write_text(SRC)
    so = d / "libk3_designs.so"
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
         "-I", str(cuda_build.CSRC), "-o", str(so), str(d / "k3_designs.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    lib.k3_design_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def cuda_ms(fn, reps=10):
    """Mean device ms of fn over reps runs (CUDA events), after a warm
    one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(lib, t, batch, rng):
    """{design: [ms, ms]} at width t on batch random inputs."""
    dev = torch.device("cuda")
    ins = torch.stack([bn.to_tensor(fr.batch_to_limbs(
        [rng.randrange(fr.P) for _ in range(batch)]), dev)
        for _ in range(t - 1)], 1)                           # (16, t-1, B)
    flat = (pos.stack_inputs(ins, None).transpose(0, 1)
            .reshape(16 * t, batch).contiguous())
    out = torch.empty((16, batch), dtype=torch.int64, device=dev)
    pack = cuda_poseidon._pack(t, dev)

    def launch(design):
        return lib.k3_design_launch(design, flat.data_ptr(), out.data_ptr(),
                                    pack.data_ptr(), t, pos.N_ROUNDS_P[t - 2],
                                    batch, cuda_build.stream_of(flat))

    def design_fn(design):
        def fn():
            rc = launch(design)
            if rc != 0:
                raise RuntimeError(f"design {design} t={t}: CUDA error {rc}")
            return out
        return fn

    fns = {"shipped": lambda: cuda_poseidon.poseidon_ex(ins)}
    want = fns["shipped"]()[:, 0]
    for design, name in DESIGNS:
        if design and launch(design) != 0:           # lane wider than a warp
            continue
        fns[name] = design_fn(design)
        if not torch.equal(fns[name](), want):
            raise AssertionError(f"design {name} t={t} != poseidon_ex")
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(cuda_ms(fns[name]))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_designs: needs a CUDA card", file=sys.stderr)
        return 1
    lib = build()
    rng = random.Random(args.seed)
    for t in WIDTHS:
        times = run(lib, t, args.batch, rng)
        print(f"K3 designs t={t}, B={args.batch}: " + ", ".join(
            f"{name} {ms[0]:.4f} / {ms[1]:.4f} ms"
            for name, ms in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
