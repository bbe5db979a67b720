// K1: batched SHA-256 / SHA-224 over pre-padded messages, one lane per
// thread. Replaces the TPU kernel sha2_32_chunks of
// passport_zk_circuits_tpu/ops/pallas_sha2.py (one fused Pallas call over all
// blocks). Layout at the boundary: message (16 nb, B) and digest (8, B), int64
// tensors holding 32-bit big-endian words, batch minor-most, so a warp reads
// 32 consecutive words of one message row at a time.
#include <cuda_runtime.h>

#include "sha256.cuh"

__global__ void sha256_kernel(const int64_t* __restrict__ msg,
                              int64_t* __restrict__ out, int nb, int B,
                              int is224) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint32_t iv256[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                             0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                             0x1f83d9abu, 0x5be0cd19u};
  const uint32_t iv224[8] = {0xc1059ed8u, 0x367cd507u, 0x3070dd17u,
                             0xf70e5939u, 0xffc00b31u, 0x68581511u,
                             0x64f98fa7u, 0xbefa4fa4u};
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = is224 ? iv224[i] : iv256[i];
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t)msg[(long)(16 * blk + i) * B + lane];
    sha::compress(st, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[(long)i * B + lane] = st[i];
}

extern "C" int pzk_sha256(const int64_t* msg, int64_t* out, int nb, int B,
                          int is224, cudaStream_t stream) {
  if (B > 0)
    sha256_kernel<<<(B + 127) / 128, 128, 0, stream>>>(msg, out, nb, B, is224);
  return (int)cudaGetLastError();
}
