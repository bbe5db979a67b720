"""Time a kernel's candidate designs beside the shipped kernel on one CUDA
card, B = 1024 by default.

    python -m passport_zk_circuits_tpu_torch.tools.kernel_designs \\
        --kernel k3|k6|k7|k9 [--batch 1024] [--scan-len 256]

K3, the Poseidon permutation, at the flagship step's widths t = 2, 3, 4, 6:

- team: a team of eight threads a lane, one word each (csrc/fr_team.cuh),
  running the generic body poseidon::permute<T> as K4 does, its pack in
  shared memory, one warp (four lanes) a block;
- split W: the lane split over its elements, each element over a team of
  8 / W threads, W words a thread (poseidon::poseidon_lane<T, W>, the
  shipped body; W = 8 is one element a thread with fr_bn254.cuh's
  product), for every W whose lane fits a warp. The shipped kernel is split
  W = 2 up to t = 8.

K6, one Fr product a lane, on (16, B) x (16, B) random 256-bit operands
(taken unreduced):

- team W: each lane's two products, mont(a, R^2) then mont(b, a R), on a
  team of 8 / W threads, W words a thread (frs::mul_lane, the shipped
  body), W = 1, 2, 4 and 8. The shipped kernel (csrc/field.cu) runs
  W = kMulW;
- thread, 4 products: one lane a thread, both operands into Montgomery
  form, their product, and out of it (fr_bn254.cuh), the design before
  the team.

A K6 launch takes a few us, which CUDA events around launches through
ctypes measure as the host's time to issue them, so K6's designs are also
timed by their kernels' device time in one torch.profiler session.

K7, the Fr mul chain, at n = --scan-len products on the field-muls/s
path's inputs (tools/microbench_field.make_inputs: a (16, 1) column c):

- team W: each lane's chain on a team of 8 / W threads, W words a thread
  (frs::mul_chain_lane, the shipped body), W = 1, 2, 4 and 8 (W = 8 is one
  thread a lane with fr_bn254.cuh's product). The shipped kernel
  (csrc/field.cu) runs W = frs::CHAIN_W.

K9, the probe battery, is as slow as its slowest role, smem_dynamic_large:
51,200 32-bit words (int64 in and out, 819 KB) through one block's 200 KB
of dynamic shared memory, read back reversed. Its designs, each launched
as a cluster of two blocks as the battery's kernel is:

- T x U, V B: block 0 alone, T threads, U loads a thread in flight of V
  bytes each (8: one word, 16: two); the shipped role is 1024 x 4, 8 B;
- pair T x U, V B: both blocks of the cluster fill and drain block 0's
  buffer, block 1 through distributed shared memory, half the words each.

K9's designs are timed by device time (torch.profiler), as K6's are.

The designs' source is compiled by nvcc into ``_build/kernel_designs/``,
and each design kernel's registers and spills are printed from
``-Xptxas -v``, with its divergent branches and warp syncs from
``cuobjdump -sass``. Each design's output is held bit-equal to the shipped
kernel's, then every design is timed twice, in turns forward and back:
CUDA events around 10 launches after a warm one. Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import random
import re
import subprocess
import sys

import torch

from ..ops import bignum as bn
from ..ops import cuda_build
from ..ops import cuda_field
from ..ops import cuda_poseidon
from ..ops import cuda_probe
from ..ops import field as fr
from ..ops import poseidon as pos
from . import microbench_field

WIDTHS = (2, 3, 4, 6)
K3_DESIGNS = ((0, "team"), (1, "split W=1"), (2, "split W=2"),
              (4, "split W=4"), (8, "split W=8"))
K7_DESIGNS = ((1, "team W=1"), (2, "team W=2"), (4, "team W=4"),
              (8, "team W=8"))
K6_DESIGNS = ((0, "thread, 4 products"),) + K7_DESIGNS
K3_SRC = r"""
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
K7_SRC = r"""
#include <cuda_runtime.h>
#include "fr_slice.cuh"
template <int W>
__global__ void __launch_bounds__(32) k7_team(
    const int64_t* __restrict__ a, const int64_t* __restrict__ c,
    int c_bcast, int64_t* __restrict__ out, int n, int B) {
  constexpr int TW = fr::NW / W;
  const long lane = ((long)blockIdx.x * blockDim.x + threadIdx.x) / TW;
  frs::mul_chain_lane<W>(wp::device_group<TW>(), a, c, c_bcast, out, n, lane,
                         B);
}
template <int W>
void team(const int64_t* a, const int64_t* c, int c_bcast, int64_t* out,
          int n, int B, cudaStream_t s) {
  const long threads = (long)B * (fr::NW / W);
  k7_team<W><<<(threads + 31) / 32, 32, 0, s>>>(a, c, c_bcast, out, n, B);
}
// W = 1, 2, 4, 8 words a thread; cudaErrorInvalidValue for another W
extern "C" int k7_design_launch(int W, const int64_t* a, const int64_t* c,
                                int c_bcast, int64_t* out, int n, int B,
                                cudaStream_t s) {
  switch (W) {
    case 1: team<1>(a, c, c_bcast, out, n, B, s); break;
    case 2: team<2>(a, c, c_bcast, out, n, B, s); break;
    case 4: team<4>(a, c, c_bcast, out, n, B, s); break;
    case 8: team<8>(a, c, c_bcast, out, n, B, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""
K6_SRC = r"""
#include <cuda_runtime.h>
#include "fr_slice.cuh"
template <int W>
__global__ void __launch_bounds__(32) k6_team(
    const int64_t* __restrict__ a, const int64_t* __restrict__ b,
    int b_bcast, int64_t* __restrict__ out, int B) {
  constexpr int TW = fr::NW / W;
  const long lane = ((long)blockIdx.x * blockDim.x + threadIdx.x) / TW;
  frs::mul_lane<W>(wp::device_group<TW>(), a, b, b_bcast, out, lane, B);
}
__global__ void k6_thread4(const int64_t* __restrict__ a,
                           const int64_t* __restrict__ b, int b_bcast,
                           int64_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const fr::Fe x = fr::to_mont(fr::load_limbs(a + lane, B));
  const fr::Fe y = fr::to_mont(
      b_bcast ? fr::load_limbs(b, 1) : fr::load_limbs(b + lane, B));
  fr::store_limbs(fr::from_mont(fr::mul(x, y)), out + lane, B);
}
template <int W>
void team(const int64_t* a, const int64_t* b, int b_bcast, int64_t* out,
          int B, cudaStream_t s) {
  const long threads = (long)B * (fr::NW / W);
  k6_team<W><<<(threads + 31) / 32, 32, 0, s>>>(a, b, b_bcast, out, B);
}
// W = 1, 2, 4, 8 words a thread of a team, 0 one thread a lane;
// cudaErrorInvalidValue for another W
extern "C" int k6_design_launch(int W, const int64_t* a, const int64_t* b,
                                int b_bcast, int64_t* out, int B,
                                cudaStream_t s) {
  switch (W) {
    case 0: k6_thread4<<<(B + 31) / 32, 32, 0, s>>>(a, b, b_bcast, out, B);
            break;
    case 1: team<1>(a, b, b_bcast, out, B, s); break;
    case 2: team<2>(a, b, b_bcast, out, B, s); break;
    case 4: team<4>(a, b, b_bcast, out, B, s); break;
    case 8: team<8>(a, b, b_bcast, out, B, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""
K9_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;
// n words (n % 4 == 0) in through shared memory and out reversed: T
// threads, U loads a thread in flight of V words; PAIR: block r of the
// cluster moves words [r n / 2, (r + 1) n / 2) through block 0's buffer
template <int T, int U, int V, bool PAIR>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(T)
    k9_smem(const int64_t* __restrict__ in, int64_t* __restrict__ out,
            int n) {
  extern __shared__ __align__(16) uint32_t local[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  if (!PAIR && rank != 0) return;
  uint32_t* sm = PAIR ? cluster.map_shared_rank(local, 0) : local;
  const int lo = PAIR ? rank * (n / 2) : 0, hi = PAIR ? lo + n / 2 : n;
  for (int base = lo; base < hi; base += T * U * V) {
    uint32_t v[U * V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + (u * T + threadIdx.x) * V;
      if constexpr (V == 2) {
        const longlong2 x = i < hi
            ? *reinterpret_cast<const longlong2*>(in + i)
            : make_longlong2(0, 0);
        v[2 * u] = (uint32_t)x.x;
        v[2 * u + 1] = (uint32_t)x.y;
      } else {
        v[u] = i < hi ? (uint32_t)in[i] : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + (u * T + threadIdx.x) * V;
      if (i >= hi) continue;
      if constexpr (V == 2)
        *reinterpret_cast<uint2*>(sm + i) = make_uint2(v[2 * u], v[2 * u + 1]);
      else
        sm[i] = v[u];
    }
  }
  if (PAIR) cluster.sync(); else __syncthreads();
  for (int base = lo; base < hi; base += T * U * V) {
    uint32_t v[U * V];
#pragma unroll
    for (int u = 0; u < U * V; ++u) {
      const int i = base + (u / V * T + threadIdx.x) * V + u % V;
      v[u] = i < hi ? sm[n - 1 - i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + (u * T + threadIdx.x) * V;
      if (i >= hi) continue;
      if constexpr (V == 2)
        *reinterpret_cast<longlong2*>(out + i) =
            make_longlong2(v[2 * u], v[2 * u + 1]);
      else
        out[i] = v[u];
    }
  }
  if (PAIR) cluster.sync();   // block 0 may not exit while it is read
}
template <int T, int U, int V, bool PAIR>
int smem(const int64_t* in, int64_t* out, int n, cudaStream_t s) {
  const int bytes = n * 4;
  cudaError_t rc = cudaFuncSetAttribute(
      k9_smem<T, U, V, PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (rc != cudaSuccess) return (int)rc;
  k9_smem<T, U, V, PAIR><<<2, T, bytes, s>>>(in, out, n);
  return (int)cudaGetLastError();
}
// the designs of K9_DESIGNS, in order; in and out 16-byte aligned
extern "C" int k9_design_launch(int design, const int64_t* in,
                                int64_t* out, int n, cudaStream_t s) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  switch (design) {
CASES
  }
  return (int)cudaErrorInvalidValue;
}
"""
# (threads, loads a thread in flight, words a load, pair)
K9_DESIGNS = ((128, 16, 1, False), (128, 16, 2, False), (128, 32, 2, False),
              (256, 16, 1, False), (1024, 4, 1, False), (1024, 8, 1, False),
              (128, 16, 1, True), (128, 32, 2, True), (256, 16, 1, True),
              (1024, 4, 1, True))
K9_SRC = K9_SRC.replace("CASES", "\n".join(
    f"    case {d}: return smem<{t}, {u}, {v}, {str(pair).lower()}>"
    "(in, out, n, s);" for d, (t, u, v, pair) in enumerate(K9_DESIGNS)))


def k9_name(design):
    t, u, v, pair = design
    return f"{'pair ' if pair else ''}{t} x {u}, {8 * v} B"


_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (source, C entry, its argtypes)
SOURCES = {
    "k3": (K3_SRC, "k3_design_launch", [_I, _P, _P, _P, _I, _I, _I, _P]),
    "k6": (K6_SRC, "k6_design_launch", [_I, _P, _P, _I, _P, _I, _P]),
    "k7": (K7_SRC, "k7_design_launch", [_I, _P, _P, _I, _P, _I, _I, _P]),
    "k9": (K9_SRC, "k9_design_launch", [_I, _P, _P, _I, _P]),
}


def build(kernel):
    """nvcc the kernel's design source into _build/kernel_designs/, print
    its kernels' registers and spills; the loaded library."""
    src, entry, argtypes = SOURCES[kernel]
    d = cuda_build.BUILD_DIR / "kernel_designs"
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{kernel}.cu").write_text(src)
    so = d / f"lib{kernel}_designs.so"
    proc = subprocess.run(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-shared",
         "-I", str(cuda_build.CSRC), "-o", str(so), str(d / f"{kernel}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    sass = sass_branches(so)
    for name, (regs, st, ld) in cuda_build.ptxas_report(
            proc.stdout + proc.stderr).items():
        div, sync = sass.get(name, (None, None))
        print(f"  ptxas {name}: {regs} registers, spill stores {st} B, "
              f"loads {ld} B; SASS: {div} BRA.DIV, {sync} WARPSYNC")
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def sass_branches(so):
    """{kernel: (BRA.DIV, WARPSYNC instructions)} in so's SASS
    (cuobjdump -sass): a divergent branch around code that shuffles splits
    a team's exchanges (the 8 x slower K3 of a per-thread select)."""
    dump = subprocess.run(
        [str(pathlib.Path(cuda_build._nvcc()).parent / "cuobjdump"), "-sass",
         str(so)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = cuda_build.kernel_name(m.group(1))
            counts[name] = (0, 0)
        elif name is not None:
            div, sync = counts[name]
            counts[name] = (div + ("BRA.DIV" in line),
                            sync + ("WARPSYNC" in line))
    return counts


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


def in_turns(fns):
    """{name: [ms, ms]}: every fn timed forward, then back."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        times[name].append(cuda_ms(fns[name]))
    return times


def device_us(fns, reps=20):
    """{name: [device us of each call]}: every fn called reps times in
    turns, each call fenced by a synchronize, in one torch.profiler
    session; each call must launch one kernel."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            for fn in fns.values():
                fn()
                torch.cuda.synchronize()
    kernels = sorted((ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and not ev.name.startswith(("Memcpy", "Memset"))),
                     key=lambda ev: ev.time_range.start)
    if len(kernels) != reps * len(fns):
        raise AssertionError(f"profiler saw {len(kernels)} kernels, not "
                             f"{reps} x {len(fns)}")
    times = {name: [] for name in fns}
    for i, ev in enumerate(kernels):
        times[list(fns)[i % len(fns)]].append(ev.time_range.elapsed_us())
    return times


def design_fn(launch, design, out, what):
    def fn():
        rc = launch(design)
        if rc != 0:
            raise RuntimeError(f"design {design} {what}: CUDA error {rc}")
        return out
    return fn


def run_k3(launch_design, t, batch, rng):
    """{design: [ms, ms]} of K3 at width t on batch random inputs."""
    dev = torch.device("cuda")
    ins = torch.stack([bn.to_tensor(fr.batch_to_limbs(
        [rng.randrange(fr.P) for _ in range(batch)]), dev)
        for _ in range(t - 1)], 1)                           # (16, t-1, B)
    flat = (pos.stack_inputs(ins, None).transpose(0, 1)
            .reshape(16 * t, batch).contiguous())
    out = torch.empty((16, batch), dtype=torch.int64, device=dev)
    pack = cuda_poseidon._pack(t, dev)

    def launch(design):
        return launch_design(design, flat.data_ptr(), out.data_ptr(),
                             pack.data_ptr(), t, pos.N_ROUNDS_P[t - 2],
                             batch, cuda_build.stream_of(flat))

    fns = {"shipped": lambda: cuda_poseidon.poseidon_ex(ins)}
    want = fns["shipped"]()[:, 0]
    for design, name in K3_DESIGNS:
        if design and launch(design) != 0:           # lane wider than a warp
            continue
        fns[name] = design_fn(launch, design, out, f"t={t}")
        if not torch.equal(fns[name](), want):
            raise AssertionError(f"design {name} t={t} != poseidon_ex")
    return in_turns(fns)


def run_k7(launch_design, batch, scan_len):
    """{design: [ms, ms]} of K7 at n = scan_len on the field-muls/s
    path's inputs."""
    x0, c = microbench_field.make_inputs(batch, torch.device("cuda"))
    out = torch.empty_like(x0)

    def launch(design):
        return launch_design(design, x0.data_ptr(), c.data_ptr(), 1,
                             out.data_ptr(), scan_len, batch,
                             cuda_build.stream_of(x0))

    fns = {"shipped": lambda: cuda_field.mul_chain(x0, c, scan_len)}
    want = fns["shipped"]()
    for design, name in K7_DESIGNS:
        fns[name] = design_fn(launch, design, out, f"n={scan_len}")
        if not torch.equal(fns[name](), want):
            raise AssertionError(f"design {name} != mul_chain")
    return in_turns(fns)


def run_k6(launch_design, batch, rng):
    """({design: [ms, ms]} by CUDA events, {design: [us, ...]} of device
    time) of K6 on batch random 256-bit lanes, b a (16, B) tensor."""
    dev = torch.device("cuda")
    a, b = (bn.to_tensor(bn.ints_to_limbs_batch(
        [rng.getrandbits(256) for _ in range(batch)], 16), dev)
        for _ in range(2))
    out = torch.empty_like(a)

    def launch(design):
        return launch_design(design, a.data_ptr(), b.data_ptr(), 0,
                             out.data_ptr(), batch, cuda_build.stream_of(a))

    fns = {"shipped": lambda: cuda_field.mul(a, b)}
    want = fns["shipped"]()
    if not torch.equal(want, cuda_field.mul_plain(a, b)):
        raise AssertionError("shipped K6 != mul_plain")
    for design, name in K6_DESIGNS:
        fns[name] = design_fn(launch, design, out, f"B={batch}")
        if not torch.equal(fns[name](), want):
            raise AssertionError(f"design {name} != mul")
    return in_turns(fns), device_us(fns)


def run_k9(launch_design):
    """({design: [ms, ms]} by CUDA events, {design: [us, ...]} of device
    time) of K9's smem_dynamic_large role on its probe's inputs."""
    dev = torch.device("cuda")
    a, _ = cuda_probe.inputs("smem_dynamic_large", dev)
    out = torch.empty_like(a)

    def launch(design):
        return launch_design(design, a.data_ptr(), out.data_ptr(),
                             a.numel(), cuda_build.stream_of(a))

    fns = {"shipped": lambda: cuda_probe.probe("smem_dynamic_large", a)}
    want = cuda_probe.plain("smem_dynamic_large", a)
    if not torch.equal(fns["shipped"](), want):
        raise AssertionError("shipped K9 smem_dynamic_large != plain")
    for design, spec in enumerate(K9_DESIGNS):
        name = k9_name(spec)
        fns[name] = design_fn(launch, design, out, "smem_dynamic_large")
        if not torch.equal(fns[name](), want):
            raise AssertionError(f"design {name} != plain")
    return in_turns(fns), device_us(fns)


def _line(head, times, rate=None):
    return head + ", ".join(
        f"{name} {ms[0]:.4f} / {ms[1]:.4f} ms" +
        (f" ({rate(min(ms)):.6g} field-muls/s)" if rate else "")
        for name, ms in times.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), required=True)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--scan-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_designs: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"{args.kernel} designs on {torch.cuda.get_device_name(0)}")
    launch = build(args.kernel)
    if args.kernel == "k3":
        rng = random.Random(args.seed)
        for t in WIDTHS:
            print(_line(f"K3 designs t={t}, B={args.batch}: ",
                        run_k3(launch, t, args.batch, rng)), flush=True)
    elif args.kernel == "k6":
        events, dev_us = run_k6(launch, args.batch, random.Random(args.seed))
        print(_line(f"K6 designs B={args.batch}, CUDA events: ", events))
        print(f"K6 designs B={args.batch}, device us (torch.profiler, "
              f"{len(dev_us['shipped'])} calls each, mean / min): " +
              ", ".join(f"{name} {sum(us) / len(us):.3f} / {min(us):.3f}"
                        for name, us in dev_us.items()))
    elif args.kernel == "k9":
        events, dev_us = run_k9(launch)
        print(_line("K9 smem_dynamic_large designs, CUDA events: ", events))
        print(f"K9 smem_dynamic_large designs, device us (torch.profiler, "
              f"{len(dev_us['shipped'])} calls each, mean / min): " +
              ", ".join(f"{name} {sum(us) / len(us):.3f} / {min(us):.3f}"
                        for name, us in dev_us.items()))
    else:
        print(_line(f"K7 designs n={args.scan_len}, B={args.batch}: ",
                    run_k7(launch, args.batch, args.scan_len),
                    lambda ms: args.batch * args.scan_len / ms * 1e3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
