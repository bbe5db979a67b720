// K10: multi-scalar multiplication over BN254 G1 and G2, Pippenger's
// bucket method, for the Groth16 prover (groth16/protocol.prove: the A, B1,
// K and H MSMs over G1, pi_B's over G2).
//
// It replaces no TPU kernel: the JAX package leaves the MSM to XLA
// (passport_zk_circuits_tpu/ops/msm.py:122, msm_affine), and the port's
// plain version (ops/msm.py: 4-bit windows, a table a point, pairwise trees
// of unified adds in int64 limb products) needed 1.5 x its memory budget for
// one G1 window of the ECDSA p256 circuit (2^21 points) and ~76 GB for one
// G2 window. Here every group operation runs in one of these kernels, one
// point in one thread's registers, over msm.cuh's bodies (Fq or Fq2 in
// Montgomery form, bn254_curve.cuh's formulas); the glue (ops/cuda_msm.py)
// only computes and sorts indices.
//
// Bound: the kernels are bound by their 32-bit integer instructions. The
// plan needs one mixed add an item (a non-zero 16-bit digit of a scalar)
// less one a bucket, 2 (2^16 - 1) full adds a window for the running sums,
// about 3 x 256 for the segments, and a lane's Horner chain (240 doublings,
// 15 adds) and inversion. A G1 mixed add is 8 products, 3 squarings and 7
// additions of Fq, about 3,100 int32 instructions (280 a CIOS product, 240 a
// squaring, 24 an addition: chip_smoke.py's counts), a full add 12
// products and 4 squarings, about 4,500; over Fq2 (3 products and 5
// additions of Fq a product) about 9,900 and 14,400. The ECDSA p256
// circuit's h query (2,097,151 points, full-width scalars) is about
// 33.5 M mixed adds and 2.1 M bucket adds: about 1.1e11 instructions, a
// bound of about 6.8 ms at chip_smoke.py's card model (1.673e13 int32
// instructions/s); chip_smoke.py computes each MSM's bound from its run's
// items.
//
// The design is the simple one first: one thread a run of RUN = 32 items
// (a bucket's points spread over runs, so a skewed witness, most of its
// wires 0 or 1, does not leave one thread with most of bucket 1), partial
// sums merged by the same kernel until one a bucket, a dense array of
// buckets, running sums a segment of 256 buckets a thread, then a thread a
// window and a thread a lane. No shared memory, no batched-affine adds.
// The kernels and launchers are in csrc/msm_kernels.cuh; G2's instances
// are built from csrc/msm_g2.cu, csrc/msm_g2_window.cu and
// csrc/msm_g2_combine.cu, in parallel with these.
#include "msm_kernels.cuh"

// G1's instances here, G2's in csrc/msm_g2.cu, csrc/msm_g2_window.cu and
// csrc/msm_g2_combine.cu (built in parallel)
namespace msm {
PZK_MSM_POINTS(, fq::F1)
PZK_MSM_SUM(, fq::F1)
PZK_MSM_WINDOW(, fq::F1)
PZK_MSM_COMBINE(, fq::F1)
PZK_MSM_HORNER(, fq::F1)
PZK_MSM_POINTS(extern, fq::F2)
PZK_MSM_SUM(extern, fq::F2)
PZK_MSM_WINDOW(extern, fq::F2)
PZK_MSM_COMBINE(extern, fq::F2)
PZK_MSM_HORNER(extern, fq::F2)
}  // namespace msm

// Each entry launches its kernel over G2 (g2 != 0) or G1 on the stream and
// returns cudaGetLastError().
extern "C" int pzk_msm_points(int g2, const int64_t* px, const int64_t* py,
                              long n, uint32_t* out, cudaStream_t stream) {
  return g2 ? msm::launch_points<fq::F2>(px, py, n, out, stream)
            : msm::launch_points<fq::F1>(px, py, n, out, stream);
}

extern "C" int pzk_msm_sum(int g2, const uint32_t* pts, const int64_t* idx,
                           const int64_t* start, const int64_t* len,
                           const int64_t* dest, long nrun, uint32_t* out,
                           cudaStream_t stream) {
  return g2 ? msm::launch_sum<fq::F2>(pts, idx, start, len, dest, nrun, out,
                                      stream)
            : msm::launch_sum<fq::F1>(pts, idx, start, len, dest, nrun, out,
                                      stream);
}

extern "C" int pzk_msm_window(int g2, const uint32_t* buckets, long nseg,
                              uint32_t* s_out, uint32_t* t_out,
                              cudaStream_t stream) {
  return g2 ? msm::launch_window<fq::F2>(buckets, nseg, s_out, t_out, stream)
            : msm::launch_window<fq::F1>(buckets, nseg, s_out, t_out, stream);
}

extern "C" int pzk_msm_combine(int g2, const uint32_t* s_in,
                               const uint32_t* t_in, long nlw, uint32_t* out,
                               cudaStream_t stream) {
  return g2 ? msm::launch_combine<fq::F2>(s_in, t_in, nlw, out, stream)
            : msm::launch_combine<fq::F1>(s_in, t_in, nlw, out, stream);
}

extern "C" int pzk_msm_horner(int g2, const uint32_t* wsum, long L,
                              int64_t* ox, int64_t* oy, cudaStream_t stream) {
  return g2 ? msm::launch_horner<fq::F2>(wsum, L, ox, oy, stream)
            : msm::launch_horner<fq::F1>(wsum, L, ox, oy, stream);
}
