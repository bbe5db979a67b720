// K6 and K7: one BN254 Fr product per lane, and a chain of n products
// x <- x * c mod P in one launch. Replace the TPU kernels mul and mul_chain
// of passport_zk_circuits_tpu/ops/pallas_field.py.
//
// The TPU kernels run a 16-bit schoolbook product and a static Barrett
// reduction on the VPU. Here each operand goes to Montgomery form once at
// entry (to_mont, which takes any value below 2^256, so inputs need not be
// below P), the products are CIOS Montgomery products in registers, and
// the result leaves Montgomery form once at exit. A product is 136
// 32x32->64 partial products with their carries and no memory traffic.
//
// K6 runs one lane a thread (fr_bn254.cuh): it moves 384 bytes a lane for
// 4 products (two entry conversions, the product, the exit), and the two
// weigh about the same against the card's byte and integer rates.
//
// K7's n products are one dependent chain a lane, so at the field-muls/s
// metric's B = 1024 its time is the chain's latency: one thread's product
// is a chain of 128 multiply-adds (about 1,300 clocks). K7 spreads each
// lane over a team of 8 / W threads, W words each (fr_slice.cuh: CIOS
// across the team, carries resolved by ballot lookahead), so a product is
// 8 team steps of W columns, and the chain's products leave their final
// subtract of P to its end (x stays below 2P). kChainW is the fastest W of
// the team designs (tools/kernel_designs --kernel k7). Blocks are one warp, 32 / (8 / W)
// lanes. Inputs and outputs are the port's int64 limb tensors, read and
// written as they are.
#include <cuda_runtime.h>

#include "fr_bn254.cuh"
#include "fr_slice.cuh"

constexpr int kThreads = 32;
constexpr int kChainW = 2;                   // words a thread of K7's team
constexpr int kChainTeam = fr::NW / kChainW;

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

// n sequential steps x <- x * c mod P starting from x = a, a lane on a
// team of kChainTeam threads (frs::mul_chain_lane)
__global__ void __launch_bounds__(kThreads)
    fr_mul_chain_kernel(const int64_t* __restrict__ a,
                        const int64_t* __restrict__ c, int c_bcast,
                        int64_t* __restrict__ out, int n, int B) {
  const long lane =
      ((long)blockIdx.x * blockDim.x + threadIdx.x) / kChainTeam;
  frs::mul_chain_lane<kChainW>(wp::device_group<kChainTeam>(), a, c, c_bcast,
                               out, n, lane, B);
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
  const long threads = (long)B * kChainTeam;
  if (B > 0)
    fr_mul_chain_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(a, c, c_bcast, out, n, B);
  return (int)cudaGetLastError();
}
