// K11: batched fixed-base scalar multiplication [s]G over BN254 G1 and
// the twist G2, for Groth16 setup (groth16/protocol.setup: the a, b1, k and
// h queries over G1, b2 over G2, through _g1_mul_many and _g2_mul_many).
//
// It replaces no TPU kernel: the JAX package leaves these mults to XLA
// (passport_zk_circuits_tpu/groth16/protocol.py:223 and :260), and the
// port's plain version (ops/weierstrass.fixed_base_mul + to_affine,
// ops/g2.fixed_base_mul + to_affine) ran 32 unified adds of int64 limb
// products over the batch, 90 % of the flagship's setup on the card.
//
// One thread a scalar (fixed_base.cuh): 32 byte windows, a mixed add
// against the stride-8 table entry of each non-zero byte (the tables of
// utils/constants/fixed_base_bn254_{g1,g2}.npz, uploaded once a device in
// Montgomery form by ops/cuda_fixed_base.py), then one Fermat inversion
// (about 254 squarings and 120 products) and the affine normal-form limbs.
//
// Bound: 32-bit integer instructions. A scalar needs one mixed add a
// non-zero byte but the first (about 31 for a uniform Fr scalar: 31 x
// about 3,100 over G1, 9,900 over G2) and its inversion (about 1.0e5 over
// Fq, 1.0e5 more and 4 products over Fq2), so a G1 list of 2^21 scalars is
// about 4.1e11 instructions, about 25 ms at chip_smoke.py's card model
// (1.673e13 int32 instructions/s); chip_smoke.py computes each call's
// bound from its scalars' bytes.
#include <cuda_runtime.h>

#include "fixed_base.cuh"

constexpr int kThreads = 128;

template <class F>
__global__ void __launch_bounds__(kThreads)
    fixed_base_kernel(const int64_t* __restrict__ scal, long B,
                      const uint32_t* __restrict__ table,
                      int64_t* __restrict__ ox, int64_t* __restrict__ oy) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) fb::mul_thread<F>(scal, B, table, ox, oy, i);
}

// [s]G for the B scalars over G2 (g2 != 0) or G1; returns
// cudaGetLastError()
extern "C" int pzk_fixed_base(int g2, const int64_t* scal, long B,
                              const uint32_t* table, int64_t* ox, int64_t* oy,
                              cudaStream_t stream) {
  if (B > 0) {
    const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
    if (g2)
      fixed_base_kernel<fq::F2><<<grid, kThreads, 0, stream>>>(scal, B, table,
                                                               ox, oy);
    else
      fixed_base_kernel<fq::F1><<<grid, kThreads, 0, stream>>>(scal, B, table,
                                                               ox, oy);
  }
  return (int)cudaGetLastError();
}
