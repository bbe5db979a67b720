// K10 over G2 (fq::F2Pair): the run and Horner kernels of
// csrc/msm_kernels.cuh for the twist, built by an nvcc process of their own
// beside csrc/msm.cu (G1 and the C entries, with the kernel's note),
// csrc/msm_g2.cu and csrc/msm_g2_reduce.cu.
#include "msm_kernels.cuh"

namespace msm {
PZK_MSM_SUM(, fq::F2Pair)
PZK_MSM_HORNER(, fq::F2Pair)
}  // namespace msm
