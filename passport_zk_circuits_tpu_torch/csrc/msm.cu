// K10: multi-scalar multiplication over BN254 G1 and G2, Pippenger's
// bucket method with signed windows, for the Groth16 prover
// (groth16/protocol.prove: the A, B1, K and H MSMs over G1, pi_B's over
// G2).
//
// It replaces no TPU kernel: the JAX package leaves the MSM to XLA
// (passport_zk_circuits_tpu/ops/msm.py:122, msm_affine), and the port's
// plain version (ops/msm.py: 4-bit windows, a table a point, pairwise trees
// of unified adds in int64 limb products) needed 1.5 x its memory budget for
// one G1 window of the ECDSA p256 circuit (2^21 points) and ~76 GB for one
// G2 window. Here every group operation runs in one of these kernels, over
// msm.cuh's bodies (Fq or Fq2 in Montgomery form, bn254_curve.cuh's
// formulas); the glue (ops/cuda_msm.py) only computes and sorts indices.
//
// Bound: the kernels are bound by their 32-bit integer instructions. The
// least Pippenger work on an MSM's own scalars (chip_smoke.msm_ops, the
// minimum over window widths and signed or unsigned digits) is a bucket add
// an item less one a non-empty bucket, at the cheaper of the mixed add and a
// batched-affine add (2 products, a squaring and 6 additions, and 3
// products of the shared inversion), two full adds a digit of each window's
// running sums up to its largest digit, and a lane's Horner chain and
// affine conversion. A CIOS product is about 280 int32 instructions.
//
// The design (msm.cuh): c-bit signed windows, c from the point count, so a
// window has 2^(c-1) buckets; rounds of affine pair adds that share one
// inversion among a thread's run of adds (5 products and a squaring an
// add, against 8 products and 3 squarings for the mixed add), while a round
// holds enough adds to fill the card; then short runs of Jacobian adds for
// the rest (the tail of a skewed bucket: a witness's bucket 1 holds most of
// its points); then a bucket reduction over each window's non-empty
// buckets only, a thread a group of 16 (a dense window) or one (a sparse
// one), joined by runs again; a thread a lane for the Horner chain. No
// thread carries more than a few hundred group operations but the Horner
// chain (c doublings a window). One-warp blocks, no shared memory. Every
// product is a call of one function (fq::F1Call): inlined, a point add was
// some 100 KB of code, and the kernels ran up to 2.7 x slower out of the
// instruction cache. G2 runs an Fq2 element over a pair of threads
// (fq::F2Pair): one thread holding a Jacobian G2 point spilled. The kernels
// and launchers are in csrc/msm_kernels.cuh; G2's instances are built from
// csrc/msm_g2.cu, csrc/msm_g2_sum.cu and csrc/msm_g2_reduce.cu, in parallel
// with these.
#include "msm_kernels.cuh"

// G1's instances here, G2's in csrc/msm_g2.cu, csrc/msm_g2_sum.cu and
// csrc/msm_g2_reduce.cu (built in parallel)
namespace msm {
PZK_MSM_POINTS(, fq::F1Call)
PZK_MSM_ROUND(, fq::F1Call)
PZK_MSM_SUM(, fq::F1Call)
PZK_MSM_REDUCE(, fq::F1Call)
PZK_MSM_HORNER(, fq::F1Call)
PZK_MSM_POINTS(extern, fq::F2)
PZK_MSM_ROUND(extern, fq::F2Pair)
PZK_MSM_SUM(extern, fq::F2Pair)
PZK_MSM_REDUCE(extern, fq::F2Pair)
PZK_MSM_HORNER(extern, fq::F2Pair)
}  // namespace msm

// Each entry launches its kernel over G2 (g2 != 0; the group arithmetic
// on fq::F2Pair, two threads an item) or G1 on the stream and returns
// cudaGetLastError().
extern "C" int pzk_msm_points(int g2, const int64_t* px, const int64_t* py,
                              long n, uint32_t* out, cudaStream_t stream) {
  return g2 ? msm::launch_points<fq::F2>(px, py, n, out, stream)
            : msm::launch_points<fq::F1Call>(px, py, n, out, stream);
}

extern "C" int pzk_msm_round(int g2, const uint32_t* pts, const int32_t* idx,
                             const uint32_t* in, const int32_t* src,
                             long nout, long per, uint32_t* out,
                             cudaStream_t stream) {
  return g2 ? msm::launch_round<fq::F2Pair>(pts, idx, in, src, nout, per,
                                            out, stream)
            : msm::launch_round<fq::F1Call>(pts, idx, in, src, nout, per,
                                            out, stream);
}

extern "C" int pzk_msm_sum(int g2, const uint32_t* in, int aff,
                           const int32_t* start, const int32_t* stop,
                           const int32_t* dest, long nrun, uint32_t* out,
                           uint32_t* last, cudaStream_t stream) {
  return g2 ? msm::launch_sum<fq::F2Pair>(in, aff, start, stop, dest, nrun,
                                          out, last, stream)
            : msm::launch_sum<fq::F1Call>(in, aff, start, stop, dest, nrun,
                                          out, last, stream);
}

extern "C" int pzk_msm_reduce(int g2, const uint32_t* buckets,
                              const int32_t* dig, const int32_t* first,
                              const int32_t* dest, long ngroup, uint32_t* out,
                              uint32_t* last, cudaStream_t stream) {
  return g2 ? msm::launch_reduce<fq::F2Pair>(buckets, dig, first, dest,
                                             ngroup, out, last, stream)
            : msm::launch_reduce<fq::F1Call>(buckets, dig, first, dest,
                                             ngroup, out, last, stream);
}

extern "C" int pzk_msm_horner(int g2, const uint32_t* wsum, int nwin, int c,
                              long L, int64_t* ox, int64_t* oy,
                              cudaStream_t stream) {
  return g2 ? msm::launch_horner<fq::F2Pair>(wsum, nwin, c, L, ox, oy, stream)
            : msm::launch_horner<fq::F1Call>(wsum, nwin, c, L, ox, oy, stream);
}
