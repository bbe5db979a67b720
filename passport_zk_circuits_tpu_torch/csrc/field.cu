// K6 and K7: one BN254 Fr product per lane, and a chain of n products
// x <- x * c mod P in one launch, one lane per thread. Replace the TPU
// kernels mul and mul_chain of passport_zk_circuits_tpu/ops/pallas_field.py.
//
// The TPU kernels run a 16-bit schoolbook product and a static Barrett
// reduction on the VPU. Here each operand goes to Montgomery form once at
// entry (to_mont, which takes any value below 2^256, so inputs need not be
// below P), the products are CIOS fr::mul in registers, and the result
// leaves Montgomery form once at exit. A product is 136 32x32->64 partial
// products with their carries and no memory traffic. K6 moves 384 bytes a
// lane for 4 products (two entry conversions, the product, the exit), and
// the two weigh about the same against the card's byte and integer rates;
// K7 moves the same bytes for n + 3 products, so at the n = 256 of the
// field-muls/s metric it is bound by integer multiply throughput. Blocks
// are one warp, so the metric's 1024 lanes spread over 32 SMs instead of
// 8. Inputs and outputs are the port's int64 limb tensors, read and
// written as they are.
#include <cuda_runtime.h>

#include "fr_bn254.cuh"

constexpr int kThreads = 32;

// a: (16, B); b: (16, B), or (16, 1) when b_bcast (stride 0 across lanes);
// out: (16, B).
__global__ void fr_mul_kernel(const int64_t* __restrict__ a,
                              const int64_t* __restrict__ b, int b_bcast,
                              int64_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const fr::Fe x = fr::to_mont(fr::load_limbs(a + lane, B));
  const fr::Fe y = fr::to_mont(
      b_bcast ? fr::load_limbs(b, 1) : fr::load_limbs(b + lane, B));
  fr::store_limbs(fr::from_mont(fr::mul(x, y)), out + lane, B);
}

// n sequential steps x <- x * c mod P starting from x = a. n = 0 copies a
// as it is (unreduced), as the TPU kernel's zero-trip loop does.
__global__ void fr_mul_chain_kernel(const int64_t* __restrict__ a,
                                    const int64_t* __restrict__ c,
                                    int c_bcast, int64_t* __restrict__ out,
                                    int n, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  if (n == 0) {
    for (int i = 0; i < 16; ++i)
      out[(long)i * B + lane] = a[(long)i * B + lane];
    return;
  }
  fr::Fe x = fr::to_mont(fr::load_limbs(a + lane, B));
  const fr::Fe y = fr::to_mont(
      c_bcast ? fr::load_limbs(c, 1) : fr::load_limbs(c + lane, B));
  for (int i = 0; i < n; ++i) x = fr::mul(x, y);
  fr::store_limbs(fr::from_mont(x), out + lane, B);
}

extern "C" int pzk_fr_mul(const int64_t* a, const int64_t* b, int b_bcast,
                          int64_t* out, int B, cudaStream_t stream) {
  if (B > 0)
    fr_mul_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        a, b, b_bcast, out, B);
  return (int)cudaGetLastError();
}

extern "C" int pzk_fr_mul_chain(const int64_t* a, const int64_t* c,
                                int c_bcast, int64_t* out, int n, int B,
                                cudaStream_t stream) {
  if (B > 0)
    fr_mul_chain_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(a, c, c_bcast, out, n, B);
  return (int)cudaGetLastError();
}
