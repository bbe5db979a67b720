// K5: the BabyJubJub double-and-add ladder. Replaces the TPU kernel ladder
// of passport_zk_circuits_tpu/ops/pallas_babyjubjub.py, and with its affine
// entry also the inversion that follows it there (to_affine in
// passport_zk_circuits_tpu/ops/babyjubjub.scalar_mul).
// LSB-first over nbits scalar bits, extended coordinates (add-2008-hwcd),
// identity (0, 1, 1, 0). Two entries of one kernel:
//   pzk_ladder: canonical extended (X, Y, Z, T);
//   pzk_ladder_affine: canonical affine (x, y) = (X / Z, Y / Z), Z inverted
//   in the kernel by Fermat (fr::inv: 256 squarings, 127 products).
//
// 254 steps of two independent point additions, 22 Montgomery products in
// three dependent levels: the kernel is bound by integer multiply latency
// and throughput, not by memory. One thread a lane filled 8 of the 132 SMs
// at B = 1024; here a team of eight threads a lane (fr_team.cuh) holds the
// two points as 8 words a thread, in blocks of one warp (four lanes), so
// B = 1024 is 256 blocks and every SM gets work.
#include <cuda_runtime.h>

#include "babyjubjub.cuh"
#include "fr_team.cuh"

// bits: (nbits, B) in {0, 1}; bx, by: (16, B) affine base;
// out: (4, 16, B) extended, or (2, 16, B) affine
template <bool AFFINE>
__global__ void __launch_bounds__(32)
    ladder_kernel(const int64_t* __restrict__ bits,
                  const int64_t* __restrict__ bx,
                  const int64_t* __restrict__ by, int64_t* __restrict__ out,
                  int nbits, int B) {
  const frt::Team tm = frt::device_team();
  const long lane = (long)blockIdx.x * (blockDim.x / frt::TEAM) +
                    threadIdx.x / frt::TEAM;
  // threads past the batch run on its last lane and store nothing
  const long mine = lane < B ? lane : B - 1;
  const bjj::Point<uint32_t> acc =
      bjj::ladder(tm, bits, bx, by, nbits, mine, B);
  const long plane = 16L * B;
  uint32_t res[4];
  if (AFFINE) {
    const uint32_t zinv = fr::inv(tm, acc.Z);
    res[0] = tm.from_mont(tm.mul(acc.X, zinv));
    res[1] = tm.from_mont(tm.mul(acc.Y, zinv));
  } else {
    res[0] = tm.from_mont(acc.X);
    res[1] = tm.from_mont(acc.Y);
    res[2] = tm.from_mont(acc.Z);
    res[3] = tm.from_mont(acc.T);
  }
  if (lane < B)
    for (int k = 0; k < (AFFINE ? 2 : 4); ++k)
      tm.store(res[k], out + k * plane + lane, B);
}

static int launch_ladder(bool affine, const int64_t* bits, const int64_t* bx,
                         const int64_t* by, int64_t* out, int nbits, int B,
                         cudaStream_t stream) {
  constexpr int LANES = 32 / frt::TEAM;                // lanes a block
  const int grid = (B + LANES - 1) / LANES;
  if (B > 0 && affine)
    ladder_kernel<true><<<grid, 32, 0, stream>>>(bits, bx, by, out, nbits, B);
  else if (B > 0)
    ladder_kernel<false><<<grid, 32, 0, stream>>>(bits, bx, by, out, nbits,
                                                  B);
  return (int)cudaGetLastError();
}

extern "C" int pzk_ladder(const int64_t* bits, const int64_t* bx,
                          const int64_t* by, int64_t* out, int nbits, int B,
                          cudaStream_t stream) {
  return launch_ladder(false, bits, bx, by, out, nbits, B, stream);
}

extern "C" int pzk_ladder_affine(const int64_t* bits, const int64_t* bx,
                                 const int64_t* by, int64_t* out, int nbits,
                                 int B, cudaStream_t stream) {
  return launch_ladder(true, bits, bx, by, out, nbits, B, stream);
}

// Message of a CUDA error code returned by any entry point of this library.
extern "C" const char* pzk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
