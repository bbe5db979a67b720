// K10's per-thread bodies: Pippenger's bucket method over BN254 G1 or G2
// (F = fq::F1 or fq::F2), one thread a run of points, a segment of
// buckets, a window or a proof lane. csrc/msm.cu launches them; a host
// build runs them thread by thread (tests/torch_msm_host_check.cc).
//
// The plan (ops/cuda_msm.Schedule, plain PyTorch glue over indices only):
//   * a window is one 16-bit limb of the scalar (C = 16 bits, NWIN = 16
//     windows), its digit the limb itself; digit 0 is skipped;
//   * every (lane, window, digit, point) with a non-zero digit is one item,
//     sorted by its bucket (lane, window, digit);
//   * sum_thread adds a run of at most RUN consecutive items of one bucket
//     (points by mixed adds, or partial sums by full adds) into one
//     Jacobian point: a Groth16 witness is mostly 0 and 1, so one bucket
//     may hold most of the points, and runs of fixed length spread it over
//     many threads; the glue repeats the pass over the partial sums until
//     each bucket has one, written to its slot of a dense bucket array;
//   * window_thread sums a segment of SEG buckets of one window by the
//     running sum (s = sum (b - lo) B_b, t = sum B_b);
//   * combine_thread joins a window's NSEG segments: sum s_k +
//     SEG * sum k t_k (a running sum over the segments, then log2(SEG)
//     doublings);
//   * horner_thread runs a lane's windows from the top (16 doublings and an
//     add a window) and converts the result to affine normal-form limbs.
#pragma once

#include "bn254_curve.cuh"

namespace msm {

constexpr int C = 16;                  // bits of a window: one scalar limb
constexpr int NWIN = 16;               // windows of a 256-bit scalar
constexpr long NBUCKET = 1L << C;      // buckets of a window (0 unused)
constexpr int RUN = 32;                // items a thread of sum_thread adds
constexpr int SEG_LOG = 8;
constexpr int SEG = 1 << SEG_LOG;      // buckets a thread of window_thread
constexpr int NSEG = NBUCKET / SEG;    // segments of a window

// Point j of the (16[, 2], n) normal-form limb tensors px, py as affine
// Montgomery words at out + j * AFF_WORDS (the key's points, converted once)
template <class F>
PZK_HD void points_thread(const int64_t* px, const int64_t* py, long n,
                          uint32_t* out, long j) {
  const ec::Aff<F> a{F::load(px + j, n), F::load(py + j, n)};
  ec::put_aff(a, out + j * ec::AFF_WORDS<F>);
}

// Run s: items start[s] .. start[s] + len[s] - 1 of the sorted list added
// into one Jacobian point at out + dest[s] * JAC_WORDS. With idx, item i is
// the affine point idx[i] of pts (mixed adds); without, the Jacobian partial
// sum i of pts (full adds).
template <class F>
PZK_HD void sum_thread(const uint32_t* pts, const int64_t* idx,
                       const int64_t* start, const int64_t* len,
                       const int64_t* dest, uint32_t* out, long s) {
  ec::Jac<F> acc = ec::infinity<F>();
  const long lo = start[s], hi = lo + len[s];
#pragma unroll 1
  for (long i = lo; i < hi; ++i) {
    if (idx)
      acc = ec::add_mixed(acc, ec::get_aff<F>(pts + idx[i] * ec::AFF_WORDS<F>));
    else
      acc = ec::add(acc, ec::get_jac<F>(pts + i * ec::JAC_WORDS<F>));
  }
  ec::put_jac(acc, out + dest[s] * ec::JAC_WORDS<F>);
}

// Segment i = lw * NSEG + k of the dense buckets (lane-window lw, buckets
// lo = k SEG .. lo + SEG - 1, Jacobian): s = sum (b - lo) B_b and
// t = sum B_b, by the running sum from the top bucket down
template <class F>
PZK_HD void window_thread(const uint32_t* buckets, uint32_t* s_out,
                          uint32_t* t_out, long i) {
  const uint32_t* b0 = buckets + i * SEG * ec::JAC_WORDS<F>;
  ec::Jac<F> t = ec::infinity<F>(), s = ec::infinity<F>();
#pragma unroll 1
  for (int b = SEG - 1; b >= 1; --b) {
    t = ec::add(t, ec::get_jac<F>(b0 + b * ec::JAC_WORDS<F>));
    s = ec::add(s, t);
  }
  t = ec::add(t, ec::get_jac<F>(b0));
  ec::put_jac(s, s_out + i * ec::JAC_WORDS<F>);
  ec::put_jac(t, t_out + i * ec::JAC_WORDS<F>);
}

// Window sum lw = sum_b b B_b from its segments: sum_k s_k + SEG sum_k k t_k
template <class F>
PZK_HD void combine_thread(const uint32_t* s_in, const uint32_t* t_in,
                           uint32_t* out, long lw) {
  const uint32_t* s0 = s_in + lw * NSEG * ec::JAC_WORDS<F>;
  const uint32_t* t0 = t_in + lw * NSEG * ec::JAC_WORDS<F>;
  ec::Jac<F> u = ec::infinity<F>(), v = ec::infinity<F>();
#pragma unroll 1
  for (int k = NSEG - 1; k >= 1; --k) {
    u = ec::add(u, ec::get_jac<F>(t0 + k * ec::JAC_WORDS<F>));
    v = ec::add(v, u);                               // v = sum k t_k
  }
#pragma unroll 1
  for (int d = 0; d < SEG_LOG; ++d) v = ec::dbl(v);
#pragma unroll 1
  for (int k = 0; k < NSEG; ++k)
    v = ec::add(v, ec::get_jac<F>(s0 + k * ec::JAC_WORDS<F>));
  ec::put_jac(v, out + lw * ec::JAC_WORDS<F>);
}

// Lane l of L: sum_w 2^(C w) W_w over its window sums (lane-major, window
// w at l * NWIN + w), as affine normal-form limbs at column l of the
// (16[, 2], L) outputs ox, oy; infinity gives (0, 0)
template <class F>
PZK_HD void horner_thread(const uint32_t* wsum, long L, int64_t* ox,
                          int64_t* oy, long l) {
  const uint32_t* w0 = wsum + l * NWIN * ec::JAC_WORDS<F>;
  ec::Jac<F> acc = ec::get_jac<F>(w0 + (NWIN - 1) * ec::JAC_WORDS<F>);
#pragma unroll 1
  for (int w = NWIN - 2; w >= 0; --w) {
#pragma unroll 1
    for (int d = 0; d < C; ++d) acc = ec::dbl(acc);
    acc = ec::add(acc, ec::get_jac<F>(w0 + w * ec::JAC_WORDS<F>));
  }
  const ec::Aff<F> a = ec::to_affine(acc);
  F::store(a.x, ox + l, L);
  F::store(a.y, oy + l, L);
}

}  // namespace msm
