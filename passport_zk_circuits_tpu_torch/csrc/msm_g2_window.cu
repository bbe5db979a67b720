// K10 over G2 (fq::F2): the window kernel of csrc/msm_kernels.cuh for the
// twist (the running sums a segment, the instance that spills most), built
// by an nvcc process of its own beside csrc/msm.cu (G1 and the C entries,
// with the kernel's note), csrc/msm_g2.cu and csrc/msm_g2_combine.cu.
#include "msm_kernels.cuh"

namespace msm {
PZK_MSM_WINDOW(, fq::F2)
}  // namespace msm
