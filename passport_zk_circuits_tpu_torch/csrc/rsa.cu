// K2: batched sig^e mod n with a modulus per lane (RSA verification).
// Replaces the TPU kernel pow_mod of passport_zk_circuits_tpu/ops/pallas_rsa.py.
// Same contract: 16-bit limbs at the boundary, Barrett with the host's
// mu = floor(b^2k / n), canonical output; any exponent e >= 1.
//
// A 2048-bit lane needs its base, modulus, mu, accumulator and Barrett
// scratch: 9K + 4 = 580 words for K = 64, far past the 255 registers a
// thread has. One thread per lane keeps the arithmetic sequential and
// simple; the lane's numbers live in shared memory, interleaved by lane so
// the threads of a warp touch neighbouring banks. That caps a block at about
// 16 lanes of RSA-2048, so few warps run per SM: the kernel is bound by the
// latency of its dependent multiply-add chains, not by bytes or issue rate.
#include <cuda_runtime.h>

#include "bignum.cuh"

static int words_per_lane(int K) { return 4 * K + 1 + bn::mulmod_scratch_words(K); }

__global__ void rsa_pow_kernel(const int64_t* __restrict__ sig,
                               const int64_t* __restrict__ n,
                               const int64_t* __restrict__ mu,
                               int64_t* __restrict__ out, int k, int B,
                               unsigned long long e) {
  extern __shared__ uint32_t sm[];
  const int L = blockDim.x;
  const int lane = blockIdx.x * L + threadIdx.x;
  if (lane >= B) return;
  const int K = k / 2;
  uint32_t* S = sm + threadIdx.x;
  uint32_t* N = S + K * L;
  uint32_t* MU = N + K * L;
  uint32_t* ACC = MU + (K + 1) * L;
  uint32_t* SCR = ACC + K * L;
  bn::load_limbs(sig + lane, B, k, S, L);
  bn::load_limbs(n + lane, B, k, N, L);
  bn::load_limbs(mu + lane, B, k + 1, MU, L);
  bn::powmod(S, e, N, MU, K, ACC, SCR, L);
  bn::store_limbs(ACC, L, k, out + lane, B);
}

// k: 16-bit limbs per number (even); mu has k + 1 limbs.
extern "C" int pzk_rsa_pow(const int64_t* sig, const int64_t* n,
                           const int64_t* mu, int64_t* out, int k, int B,
                           unsigned long long e, cudaStream_t stream) {
  const int bytes = 4 * words_per_lane(k / 2);
  int lanes = 40960 / bytes;
  if (lanes > 128) lanes = 128;
  if (lanes < 1) lanes = 1;
  if (B > 0)
    rsa_pow_kernel<<<(B + lanes - 1) / lanes, lanes, lanes * bytes, stream>>>(
        sig, n, mu, out, k, B, e);
  return (int)cudaGetLastError();
}
