// K10's kernels and their launchers, a template over the field policy F
// (fq::F1 for G1, fq::F2 for G2), included by csrc/msm.cu (G1, and the C
// entries), csrc/msm_g2.cu, csrc/msm_g2_window.cu and
// csrc/msm_g2_combine.cu (G2): each source's instances are built by an
// nvcc process of their own, in parallel (the G2 instances spill and take
// the longest). Each launcher runs its kernel on the stream over msm.cuh's
// per-thread body and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

#include "msm.cuh"

// the kernels at global scope, as the port's others (their names in
// nvcc's -Xptxas -v report and the profiler's records). A minimum of one
// block an SM in the launch bounds: without it ptxas held the G1 window,
// combine and Horner kernels near 168 registers and spilled 8-16 bytes.
constexpr int kMsmThreads = 128;

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
    msm_sum_kernel(const uint32_t* __restrict__ pts,
                   const int64_t* __restrict__ idx,
                   const int64_t* __restrict__ start,
                   const int64_t* __restrict__ len,
                   const int64_t* __restrict__ dest, long nrun,
                   uint32_t* __restrict__ out) {
  const long s = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s < nrun) msm::sum_thread<F>(pts, idx, start, len, dest, out, s);
}

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_window_kernel(const uint32_t* __restrict__ buckets, long nseg,
                      uint32_t* __restrict__ s_out,
                      uint32_t* __restrict__ t_out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nseg) msm::window_thread<F>(buckets, s_out, t_out, i);
}

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_combine_kernel(const uint32_t* __restrict__ s_in,
                       const uint32_t* __restrict__ t_in, long nlw,
                       uint32_t* __restrict__ out) {
  const long lw = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lw < nlw) msm::combine_thread<F>(s_in, t_in, out, lw);
}

template <class F>
__global__ void __launch_bounds__(kMsmThreads, 1)
    msm_horner_kernel(const uint32_t* __restrict__ wsum, long L,
                      int64_t* __restrict__ ox, int64_t* __restrict__ oy) {
  const long l = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l < L) msm::horner_thread<F>(wsum, L, ox, oy, l);
}

namespace msm {

inline unsigned blocks(long n) {
  return (unsigned)((n + kMsmThreads - 1) / kMsmThreads);
}

template <class F>
int launch_points(const int64_t* px, const int64_t* py, long n, uint32_t* out,
                  cudaStream_t stream) {
  if (n > 0)
    msm_points_kernel<F><<<blocks(n), kMsmThreads, 0, stream>>>(px, py, n, out);
  return (int)cudaGetLastError();
}

template <class F>
int launch_sum(const uint32_t* pts, const int64_t* idx, const int64_t* start,
               const int64_t* len, const int64_t* dest, long nrun,
               uint32_t* out, cudaStream_t stream) {
  if (nrun > 0)
    msm_sum_kernel<F><<<blocks(nrun), kMsmThreads, 0, stream>>>(
        pts, idx, start, len, dest, nrun, out);
  return (int)cudaGetLastError();
}

template <class F>
int launch_window(const uint32_t* buckets, long nseg, uint32_t* s_out,
                  uint32_t* t_out, cudaStream_t stream) {
  if (nseg > 0)
    msm_window_kernel<F><<<blocks(nseg), kMsmThreads, 0, stream>>>(
        buckets, nseg, s_out, t_out);
  return (int)cudaGetLastError();
}

template <class F>
int launch_combine(const uint32_t* s_in, const uint32_t* t_in, long nlw,
                   uint32_t* out, cudaStream_t stream) {
  if (nlw > 0)
    msm_combine_kernel<F><<<blocks(nlw), kMsmThreads, 0, stream>>>(s_in, t_in,
                                                                nlw, out);
  return (int)cudaGetLastError();
}

template <class F>
int launch_horner(const uint32_t* wsum, long L, int64_t* ox, int64_t* oy,
                  cudaStream_t stream) {
  if (L > 0)
    msm_horner_kernel<F><<<blocks(L), kMsmThreads, 0, stream>>>(wsum, L, ox, oy);
  return (int)cudaGetLastError();
}

// Explicit instantiations (PREFIX empty) or their declarations (PREFIX
// extern) of one curve's launchers, so that each source builds only the
// kernels it names
#define PZK_MSM_POINTS(PREFIX, F)                                            \
  PREFIX template int launch_points<F>(const int64_t*, const int64_t*, long, \
                                       uint32_t*, cudaStream_t);
#define PZK_MSM_SUM(PREFIX, F)                                               \
  PREFIX template int launch_sum<F>(const uint32_t*, const int64_t*,         \
                                    const int64_t*, const int64_t*,          \
                                    const int64_t*, long, uint32_t*,         \
                                    cudaStream_t);
#define PZK_MSM_WINDOW(PREFIX, F)                                            \
  PREFIX template int launch_window<F>(const uint32_t*, long, uint32_t*,     \
                                       uint32_t*, cudaStream_t);
#define PZK_MSM_COMBINE(PREFIX, F)                                           \
  PREFIX template int launch_combine<F>(const uint32_t*, const uint32_t*,    \
                                        long, uint32_t*, cudaStream_t);
#define PZK_MSM_HORNER(PREFIX, F)                                            \
  PREFIX template int launch_horner<F>(const uint32_t*, long, int64_t*,      \
                                       int64_t*, cudaStream_t);

}  // namespace msm
