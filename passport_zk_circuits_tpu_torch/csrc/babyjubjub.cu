// K5: the BabyJubJub double-and-add ladder, one lane per thread. Replaces
// the TPU kernel ladder of passport_zk_circuits_tpu/ops/pallas_babyjubjub.py.
// LSB-first over nbits scalar bits, extended coordinates (add-2008-hwcd),
// identity (0, 1, 1, 0); returns canonical extended (X, Y, Z, T). The
// affine conversion (one inversion) stays outside, in plain PyTorch.
//
// The two points (8 field elements, 64 words) and the temporaries of an
// addition fit in registers; 254 steps of 22 dependent Montgomery products
// make the kernel bound by integer multiply latency and throughput, not by
// memory.
#include <cuda_runtime.h>

#include "babyjubjub.cuh"

// bits: (nbits, B) in {0, 1}; bx, by: (16, B) affine base; out: (4, 16, B)
__global__ void ladder_kernel(const int64_t* __restrict__ bits,
                              const int64_t* __restrict__ bx,
                              const int64_t* __restrict__ by,
                              int64_t* __restrict__ out, int nbits, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const fr::Fe a_m = bjj::small_mont(bjj::A);
  const fr::Fe d_m = bjj::small_mont(bjj::D);
  bjj::Point base;
  base.X = fr::to_mont(fr::load_limbs(bx + lane, B));
  base.Y = fr::to_mont(fr::load_limbs(by + lane, B));
  base.Z = fr::one_mont();
  base.T = fr::mul(base.X, base.Y);
  bjj::Point acc;
  acc.X = fr::zero();
  acc.Y = fr::one_mont();
  acc.Z = fr::one_mont();
  acc.T = fr::zero();
  for (int i = 0; i < nbits; ++i)
    bjj::ladder_step(acc, base, bits[(long)i * B + lane] != 0, a_m, d_m);
  const long plane = 16L * B;
  fr::store_limbs(fr::from_mont(acc.X), out + 0 * plane + lane, B);
  fr::store_limbs(fr::from_mont(acc.Y), out + 1 * plane + lane, B);
  fr::store_limbs(fr::from_mont(acc.Z), out + 2 * plane + lane, B);
  fr::store_limbs(fr::from_mont(acc.T), out + 3 * plane + lane, B);
}

extern "C" int pzk_ladder(const int64_t* bits, const int64_t* bx,
                          const int64_t* by, int64_t* out, int nbits, int B,
                          cudaStream_t stream) {
  if (B > 0)
    ladder_kernel<<<(B + 127) / 128, 128, 0, stream>>>(bits, bx, by, out,
                                                       nbits, B);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by any entry point of this library.
extern "C" const char* pzk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
