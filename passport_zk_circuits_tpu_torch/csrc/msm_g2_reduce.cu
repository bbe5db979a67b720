// K10 over G2 (fq::F2Pair): the bucket reduction kernel of
// csrc/msm_kernels.cuh for the twist (a group of a window's non-empty
// buckets weighted by their digits), built by an nvcc process of its own
// beside csrc/msm.cu (G1 and the C entries, with the kernel's note),
// csrc/msm_g2.cu and csrc/msm_g2_sum.cu.
#include "msm_kernels.cuh"

namespace msm {
PZK_MSM_REDUCE(, fq::F2Pair)
}  // namespace msm
