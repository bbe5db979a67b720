// K6 and K7: one BN254 Fr product per lane, and a chain of n products
// x <- x * c mod P in one launch. Replace the TPU kernels mul and mul_chain
// of passport_zk_circuits_tpu/ops/pallas_field.py.
//
// The TPU kernels run a 16-bit schoolbook product and a static Barrett
// reduction on the VPU. Here the products are CIOS Montgomery products in
// registers, each lane on a team of 8 / W threads, W words a thread
// (fr_slice.cuh: CIOS across the team, carries resolved by ballot
// lookahead), so a product is 8 team steps of W columns. Inputs and outputs
// are the port's int64 limb tensors, read and written as they are; any
// input below 2^256 is taken, so inputs need not be below P.
//
// Both kernels are bound by their lanes' dependent chain of products, not
// by bytes or the card's integer rate: one thread's product is a chain of
// 128 multiply-adds (about 1,300 clocks), a team's about 664 clocks at
// W = 2. Blocks are one warp, 32 / (8 / W) lanes, so B = 1024 at W = 2
// spreads over 128 SMs.
//
// K6 (frs::mul_lane) takes two products a lane, mont(a, R^2) = a R mod P,
// then mont(b, a R) = a b mod P, not four (both operands into Montgomery
// form, their product, out of it). kMulW is the fastest W of its team
// designs (tools/kernel_designs --kernel k6).
//
// K7's n products are one dependent chain a lane, so at the field-muls/s
// metric's B = 1024 its time is the chain's latency. Both operands go to
// Montgomery form once at entry and the result leaves it once at exit; the
// chain's products leave their final subtract of P to its end (x stays
// below 2P). K7 runs frs::CHAIN_W words a thread (tools/kernel_designs
// --kernel k7).
#include <cuda_runtime.h>

#include "fr_slice.cuh"

constexpr int kThreads = 32;
constexpr int kMulW = 2;                     // words a thread of K6's team
constexpr int kMulTeam = fr::NW / kMulW;
constexpr int kChainTeam = fr::NW / frs::CHAIN_W;

// a: (16, B); b: (16, B), or (16, 1) when b_bcast (stride 0 across lanes);
// out: (16, B). A lane on a team of kMulTeam threads (frs::mul_lane).
__global__ void __launch_bounds__(kThreads)
    fr_mul_kernel(const int64_t* __restrict__ a,
                  const int64_t* __restrict__ b, int b_bcast,
                  int64_t* __restrict__ out, int B) {
  const long lane = ((long)blockIdx.x * blockDim.x + threadIdx.x) / kMulTeam;
  frs::mul_lane<kMulW>(wp::device_group<kMulTeam>(), a, b, b_bcast, out,
                       lane, B);
}

// n sequential steps x <- x * c mod P starting from x = a, a lane on a
// team of kChainTeam threads (frs::mul_chain_lane)
__global__ void __launch_bounds__(kThreads)
    fr_mul_chain_kernel(const int64_t* __restrict__ a,
                        const int64_t* __restrict__ c, int c_bcast,
                        int64_t* __restrict__ out, int n, int B) {
  const long lane =
      ((long)blockIdx.x * blockDim.x + threadIdx.x) / kChainTeam;
  frs::mul_chain_lane<frs::CHAIN_W>(wp::device_group<kChainTeam>(), a, c,
                                    c_bcast, out, n, lane, B);
}

extern "C" int pzk_fr_mul(const int64_t* a, const int64_t* b, int b_bcast,
                          int64_t* out, int B, cudaStream_t stream) {
  const long threads = (long)B * kMulTeam;
  if (B > 0)
    fr_mul_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                    stream>>>(a, b, b_bcast, out, B);
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
