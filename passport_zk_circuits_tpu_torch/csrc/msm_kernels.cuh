// K10's kernels and their launchers, a template over the field policy F
// (fq::F1Call for G1; for G2 fq::F2 converts the points and fq::F2Pair, an
// Fq2 element over two threads, runs the group arithmetic), included by
// csrc/msm.cu (G1, and the C entries), csrc/msm_g2.cu, csrc/msm_g2_sum.cu
// and csrc/msm_g2_reduce.cu (G2): each source's instances are built by an
// nvcc process of their own, in parallel. Each launcher runs its
// kernel on the stream over msm.cuh's per-thread body and returns
// cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#include "msm.cuh"

// the kernels at global scope, as the port's others (their names in
// nvcc's -Xptxas -v report and the profiler's records), F::TEAM threads an
// item (a pair for fq::F2Pair, G2's arithmetic). One-warp blocks: a
// pass of a few thousand threads then spreads over every SM rather than
// filling a few; a minimum of one block an SM in the launch bounds leaves
// ptxas every register a thread may have (with fewer, the G1 kernels of
// the first design spilled 8-16 bytes).
constexpr int kMsmThreads = 32;

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_points_kernel(const int64_t* __restrict__ px,
                      const int64_t* __restrict__ py, long n,
                      uint32_t* __restrict__ out) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) msm::points_thread<F>(px, py, n, out, j);
}

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_round_kernel(const uint32_t* __restrict__ pts,
                     const int32_t* __restrict__ idx,
                     const uint32_t* __restrict__ in,
                     const int32_t* __restrict__ src, long nout, long per,
                     uint32_t* __restrict__ out) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) / F::TEAM;
  if ((i / 32) * 32 * per + i % 32 < nout)
    msm::round_thread<F>(pts, idx, in, src, nout, per, out, i);
}

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_sum_kernel(const uint32_t* __restrict__ in, int aff,
                   const int32_t* __restrict__ start,
                   const int32_t* __restrict__ stop,
                   const int32_t* __restrict__ dest, long nrun,
                   uint32_t* __restrict__ out, uint32_t* __restrict__ last) {
  const long s = ((long)blockIdx.x * blockDim.x + threadIdx.x) / F::TEAM;
  if (s < nrun)
    msm::sum_thread<F>(in, aff, start, stop, dest, out, last, s);
}

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_reduce_kernel(const uint32_t* __restrict__ buckets,
                      const int32_t* __restrict__ dig,
                      const int32_t* __restrict__ first,
                      const int32_t* __restrict__ dest, long ngroup,
                      uint32_t* __restrict__ out,
                      uint32_t* __restrict__ last) {
  const long g = ((long)blockIdx.x * blockDim.x + threadIdx.x) / F::TEAM;
  if (g < ngroup)
    msm::reduce_thread<F>(buckets, dig, first, dest, out, last, g);
}

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_horner_kernel(const uint32_t* __restrict__ wsum, int nwin, int c,
                      long L, int64_t* __restrict__ ox,
                      int64_t* __restrict__ oy) {
  const long l = ((long)blockIdx.x * blockDim.x + threadIdx.x) / F::TEAM;
  if (l < L) msm::horner_thread<F>(wsum, nwin, c, L, ox, oy, l);
}

namespace msm {

// blocks for n items of F::TEAM threads each
template <class F>
inline unsigned blocks(long n) {
  return (unsigned)((n * F::TEAM + kMsmThreads - 1) / kMsmThreads);
}

template <class F>
int launch_points(const int64_t* px, const int64_t* py, long n, uint32_t* out,
                  cudaStream_t stream) {
  if (n > 0)
    msm_points_kernel<F><<<blocks<F>(n), kMsmThreads, 0, stream>>>(px, py, n,
                                                                  out);
  return (int)cudaGetLastError();
}

template <class F>
int launch_round(const uint32_t* pts, const int32_t* idx, const uint32_t* in,
                 const int32_t* src, long nout, long per, uint32_t* out,
                 cudaStream_t stream) {
  if (nout > 0 && per > 0)  // a warp a span of 32 * per slots
    msm_round_kernel<F><<<blocks<F>((nout + 32 * per - 1) / (32 * per) * 32),
                          kMsmThreads, 0, stream>>>(pts, idx, in, src, nout,
                                                    per, out);
  return (int)cudaGetLastError();
}

template <class F>
int launch_sum(const uint32_t* in, int aff, const int32_t* start,
               const int32_t* stop, const int32_t* dest, long nrun,
               uint32_t* out, uint32_t* last, cudaStream_t stream) {
  if (nrun > 0)
    msm_sum_kernel<F><<<blocks<F>(nrun), kMsmThreads, 0, stream>>>(
        in, aff, start, stop, dest, nrun, out, last);
  return (int)cudaGetLastError();
}

template <class F>
int launch_reduce(const uint32_t* buckets, const int32_t* dig,
                  const int32_t* first, const int32_t* dest, long ngroup,
                  uint32_t* out, uint32_t* last, cudaStream_t stream) {
  if (ngroup > 0)
    msm_reduce_kernel<F><<<blocks<F>(ngroup), kMsmThreads, 0, stream>>>(
        buckets, dig, first, dest, ngroup, out, last);
  return (int)cudaGetLastError();
}

template <class F>
int launch_horner(const uint32_t* wsum, int nwin, int c, long L, int64_t* ox,
                  int64_t* oy, cudaStream_t stream) {
  if (L > 0)
    msm_horner_kernel<F><<<blocks<F>(L), kMsmThreads, 0, stream>>>(
        wsum, nwin, c, L, ox, oy);
  return (int)cudaGetLastError();
}

// Explicit instantiations (PREFIX empty) or their declarations (PREFIX
// extern) of one curve's launchers, so that each source builds only the
// kernels it names
#define PZK_MSM_POINTS(PREFIX, F)                                            \
  PREFIX template int launch_points<F>(const int64_t*, const int64_t*, long, \
                                       uint32_t*, cudaStream_t);
#define PZK_MSM_ROUND(PREFIX, F)                                             \
  PREFIX template int launch_round<F>(const uint32_t*, const int32_t*,       \
                                      const uint32_t*, const int32_t*, long, \
                                      long, uint32_t*, cudaStream_t);
#define PZK_MSM_SUM(PREFIX, F)                                               \
  PREFIX template int launch_sum<F>(const uint32_t*, int, const int32_t*,    \
                                    const int32_t*, const int32_t*, long,    \
                                    uint32_t*, uint32_t*, cudaStream_t);
#define PZK_MSM_REDUCE(PREFIX, F)                                            \
  PREFIX template int launch_reduce<F>(const uint32_t*, const int32_t*,      \
                                       const int32_t*, const int32_t*, long, \
                                       uint32_t*, uint32_t*, cudaStream_t);
#define PZK_MSM_HORNER(PREFIX, F)                                            \
  PREFIX template int launch_horner<F>(const uint32_t*, int, int, long,      \
                                       int64_t*, int64_t*, cudaStream_t);

}  // namespace msm
