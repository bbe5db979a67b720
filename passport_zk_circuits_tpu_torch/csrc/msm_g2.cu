// K10 over G2: the point conversion (fq::F2) and round (fq::F2Pair)
// kernels of csrc/msm_kernels.cuh for the twist, built by an nvcc process
// of their own beside csrc/msm.cu (G1 and the C entries, with the
// kernel's note), csrc/msm_g2_sum.cu and csrc/msm_g2_reduce.cu.
#include "msm_kernels.cuh"

namespace msm {
PZK_MSM_POINTS(, fq::F2)
PZK_MSM_ROUND(, fq::F2Pair)
}  // namespace msm
