// K11's per-thread body: [s]G for one Fr scalar over BN254 G1 or the
// twist (F = fq::F1 or fq::F2), through the stride-8 tables of
// ops/weierstrass.fixed_base_table: table[w][j] = (j 2^(8w)) G for the 32
// byte windows w and j = 1..255 (j = 0 is infinity and never read). One
// mixed add a non-zero byte, then one Fermat inversion to affine.
// csrc/fixed_base.cu launches it; a host build runs it thread by thread
// (tests/torch_msm_host_check.cc).
#pragma once

#include "bn254_curve.cuh"

namespace fb {

constexpr int NWIN = 32;               // byte windows of a 256-bit scalar
constexpr int ENTRIES = 256;           // table entries a window

// Scalar i of the (16, B) normal-form limb tensor scal; table: NWIN x
// ENTRIES affine Montgomery points (AFF_WORDS words each); out: column i of
// the (16[, 2], B) affine normal-form limb tensors ox, oy ((0, 0) for
// infinity, a zero scalar)
template <class F>
PZK_HD void mul_thread(const int64_t* scal, long B, const uint32_t* table,
                       int64_t* ox, int64_t* oy, long i) {
  ec::Jac<F> acc = ec::infinity<F>();
#pragma unroll 1
  for (int w = 0; w < NWIN; ++w) {
    const int byte = (int)((scal[(w >> 1) * B + i] >> (8 * (w & 1))) & 0xFF);
    if (byte)
      acc = ec::add_mixed(acc, ec::get_aff<F>(
          table + (w * ENTRIES + byte) * ec::AFF_WORDS<F>));
  }
  const ec::Aff<F> a = ec::to_affine(acc);
  F::store(a.x, ox + i, B);
  F::store(a.y, oy + i, B);
}

}  // namespace fb
