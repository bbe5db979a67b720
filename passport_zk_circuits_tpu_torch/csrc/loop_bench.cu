// K8: a field-op body (loop_bodies.cuh) looped n_iter times in one kernel,
// one lane per thread, the state in registers. Replaces the TPU kernel
// run_loop of tools/microbench_kernel.py (a Pallas fori_loop over a body).
//
// The loop carries one dependent chain per lane, so with one warp per block
// the 1024 lanes of the microbenchmarks occupy 32 SMs, and a body's time
// per iteration is its instruction latency chain, not the card's
// throughput: the kernel is bound by integer instruction issue and latency,
// never by the 256 bytes a lane reads and the 128 it writes. The empty asm
// keeps the compiler from replacing a chain of the simple bodies by its
// closed form (x + n * k for mask_shift_add), which would time nothing.
#include <cuda_runtime.h>

#include "loop_bodies.cuh"

constexpr int kThreads = 32;

__device__ __forceinline__ void opaque(loopb::L16& s) {
#pragma unroll
  for (int i = 0; i < loopb::NL; ++i) asm volatile("" : "+r"(s.v[i]));
}

template <class S>
__device__ __forceinline__ void opaque(S&) {}

// a, c, out: (16, B)
template <class Body>
__global__ void loop_kernel(const int64_t* __restrict__ a,
                            const int64_t* __restrict__ c,
                            int64_t* __restrict__ out, int n_iter, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  typename Body::S x = Body::enter(loopb::load16(a + lane, B));
  const typename Body::S k = Body::enter(loopb::load16(c + lane, B));
  for (int i = 0; i < n_iter; ++i) {
    x = Body::step(x, k);
    opaque(x);
  }
  loopb::store16(Body::leave(x), out + lane, B);
}

#define PZK_LOOP_CASE(id, T)                                                \
  case id:                                                                  \
    loop_kernel<loopb::T><<<grid, kThreads, 0, stream>>>(a, c, out, n_iter, \
                                                         B);                \
    break;

extern "C" int pzk_loop(int body, const int64_t* a, const int64_t* c,
                        int64_t* out, int n_iter, int B,
                        cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int grid = (B + kThreads - 1) / kThreads;
  switch (body) {
    PZK_LOOP_BODIES(PZK_LOOP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
