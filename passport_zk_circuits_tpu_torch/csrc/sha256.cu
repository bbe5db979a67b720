// K1: batched SHA-256 / SHA-224 over pre-padded messages, one lane per
// thread. Replaces the TPU kernel sha2_32_chunks of
// passport_zk_circuits_tpu/ops/pallas_sha2.py (one fused Pallas call over all
// blocks). Layout at the boundary: message (16 nb, B) and digest (8, B), int64
// tensors holding 32-bit big-endian words, batch minor-most, so a warp reads
// 32 consecutive words of one message row at a time.
//
// A lane's rounds are one dependent chain (64 a block), so at the witness
// step's B = 1024 the kernel is bound by that chain's latency, not by the
// card's integer rate: there are too few lanes to fill it. The step's
// messages (dg1, dg15, ec, sa) are independent inputs, so the many-message
// entry hashes all of them in one launch, one warp a thread block: 4 x 1024
// lanes are 128 thread blocks on 128 SMs where one message a launch in
// blocks of 128 threads ran 8. The messages with the most SHA blocks start
// first (sha::plan_many). The round constants are immediates and the state
// and the schedule window stay in registers (sha::compress).
#include <cuda_runtime.h>

#include "sha256.cuh"

__global__ void sha256_kernel(const int64_t* __restrict__ msg,
                              int64_t* __restrict__ out, int nb, int B,
                              int is224) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < B) sha::hash_lane(msg, out, nb, is224 != 0, B, lane);
}

// The plan travels by value in the kernel's parameters: no pointer table
// is copied to the device.
__global__ void __launch_bounds__(sha::MANY_THREADS)
    sha256_many_kernel(const __grid_constant__ sha::Many m) {
  sha::many_thread(m, blockIdx.x, threadIdx.x);
}

extern "C" int pzk_sha256(const int64_t* msg, int64_t* out, int nb, int B,
                          int is224, cudaStream_t stream) {
  if (B > 0)
    sha256_kernel<<<(B + 127) / 128, 128, 0, stream>>>(msg, out, nb, B, is224);
  return (int)cudaGetLastError();
}

// n messages (1 <= n <= sha::MAX_MSGS) of B lanes: msg[i] (16 nb[i], B),
// out[i] (8, B), SHA-224's IV where is224[i]; host arrays, read here.
extern "C" int pzk_sha256_many(const int64_t* const* msg,
                               int64_t* const* out, const int* nb,
                               const int* is224, int n, int B,
                               cudaStream_t stream) {
  if (n < 1 || n > sha::MAX_MSGS) return (int)cudaErrorInvalidValue;
  const sha::Many m = sha::plan_many(n, msg, out, nb, is224, B);
  if (B > 0)
    sha256_many_kernel<<<sha::many_blocks(m), sha::MANY_THREADS, 0, stream>>>(
        m);
  return (int)cudaGetLastError();
}
