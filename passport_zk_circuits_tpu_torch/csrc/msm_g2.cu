// K10 over G2 (fq::F2): the point conversion, run and Horner kernels of
// csrc/msm_kernels.cuh for the twist, built by an nvcc process of their own
// beside csrc/msm.cu (G1 and the C entries, with the kernel's note),
// csrc/msm_g2_window.cu and csrc/msm_g2_combine.cu.
#include "msm_kernels.cuh"

namespace msm {
PZK_MSM_POINTS(, fq::F2)
PZK_MSM_SUM(, fq::F2)
PZK_MSM_HORNER(, fq::F2)
}  // namespace msm
