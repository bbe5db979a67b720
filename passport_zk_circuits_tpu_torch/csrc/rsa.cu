// K2: batched sig^e mod n with a modulus per lane (RSA verification).
// Replaces the TPU kernel pow_mod of passport_zk_circuits_tpu/ops/pallas_rsa.py.
// Same contract: 16-bit limbs at the boundary, the host's Barrett constant
// mu = floor(b^2k / n) per lane, canonical output; any exponent e >= 1,
// any even k up to 512 limbs, any modulus with a non-zero top limb.
//
// One warp a lane (bignum.cuh, bnw::pow_lane): the lane's K = k/2 words
// spread over the 32 threads, W = ceil(K / 32) a thread in registers, and
// Montgomery products across the warp. R^2 mod n comes from the wrapper's
// mu (one low-half product), n^-1 mod 2^32 by Newton, so a lane needs no
// host work. A product is bound by the latency of its K outer steps, each
// waiting on two shuffles (the quotient word's broadcast and the shift
// down a word); B = 1024 lanes are 1024 one-warp blocks, about eight warps
// on each of the 132 SMs. No shared memory: the first design, one thread a
// lane, held RSA-2048's 580 words there, 17 lanes a block on 61 SMs.
//
// A lane with an even modulus (Montgomery needs an odd one) takes bn's
// Barrett on its warp's thread 0, its words in the scratch buffer the
// wrapper allocates (bn::powmod_lane_words(K) words a lane), so odd lanes
// pay nothing for it. The branch is per warp, on the lane's own data.
#include <cuda_runtime.h>

#include "bignum.cuh"

// (32, 1): without the second bound ptxas held W = 8 to 72 registers and
// spilled; with it W = 8 takes 82 and none
template <int W>
__global__ void __launch_bounds__(32, 1)
    rsa_pow_kernel(const int64_t* __restrict__ sig,
                   const int64_t* __restrict__ n,
                   const int64_t* __restrict__ mu, int64_t* __restrict__ out,
                   int k, int B, unsigned long long e,
                   uint32_t* __restrict__ scratch) {
  bnw::pow_lane<W>(wp::device_group<32>(), sig, n, mu, out, k, blockIdx.x,
                   B, e, scratch);
}

#define PZK_RSA_CASE(W)                                                   \
  case W:                                                                 \
    rsa_pow_kernel<W><<<B, 32, 0, stream>>>(sig, n, mu, out, k, B, e,     \
                                            scratch);                     \
    break;

// k: 16-bit limbs per number (even, at most 512); mu has k + 1 limbs;
// scratch: B * bn::powmod_lane_words(k / 2) words.
extern "C" int pzk_rsa_pow(const int64_t* sig, const int64_t* n,
                           const int64_t* mu, int64_t* out, int k, int B,
                           unsigned long long e, uint32_t* scratch,
                           cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  switch ((k / 2 + 31) / 32) {
    PZK_RSA_CASE(1) PZK_RSA_CASE(2) PZK_RSA_CASE(3) PZK_RSA_CASE(4)
    PZK_RSA_CASE(5) PZK_RSA_CASE(6) PZK_RSA_CASE(7) PZK_RSA_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
