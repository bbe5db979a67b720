// K10 over G2 (fq::F2): the combine kernel of csrc/msm_kernels.cuh for
// the twist (a window's segments joined), built by an nvcc process of its
// own beside csrc/msm.cu (G1 and the C entries, with the kernel's note),
// csrc/msm_g2.cu and csrc/msm_g2_window.cu.
#include "msm_kernels.cuh"

namespace msm {
PZK_MSM_COMBINE(, fq::F2)
}  // namespace msm
