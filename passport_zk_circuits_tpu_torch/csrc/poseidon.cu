// K3 and K4: the circomlib PoseidonEx permutation and the whole SMT root
// climb, one lane per thread, over one permutation body (poseidon.cuh).
// Replace the TPU kernels _permute / poseidon_ex and smt_climb of
// passport_zk_circuits_tpu/ops/pallas_poseidon.py.
//
// A permutation is ~65-70 rounds of dependent Montgomery products (t = 3:
// about 380 of them, each 64 32-bit multiply-adds twice over); the state
// (t x 8 words) sits in registers and the round constants are read from
// global memory, where every thread of a warp reads the same address. So the
// kernels are bound by integer multiply throughput and latency, not bytes.
// The TPU route is capped at t <= 8 by an f32 exactness bound of the MXU;
// these kernels take every t from 2 to 17.
#include <cuda_runtime.h>

#include "poseidon.cuh"

// state: (16 T, B) canonical limbs, element j in rows 16j..16j+15;
// out: (16 n_outs, B)
template <int T>
__global__ void poseidon_kernel(const int64_t* __restrict__ state,
                                int64_t* __restrict__ out,
                                const uint32_t* __restrict__ pack, int nP,
                                int n_outs, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  fr::Fe st[T];
  for (int j = 0; j < T; ++j)
    st[j] = fr::to_mont(fr::load_limbs(state + (long)16 * j * B + lane, B));
  poseidon::permute<T>(st, pack, nP);
  for (int j = 0; j < n_outs; ++j)
    fr::store_limbs(fr::from_mont(st[j]), out + (long)16 * j * B + lane, B);
}

// sibs: (16 N, B) deepest level first; lr, top, inew: (N, B) flags;
// leaf: (16, B) = Poseidon(key, value, 1); out: (16, B) computed root.
// Per level: hash (L, R) ordered by the key bit, then keep the hash while on
// the top path, the leaf where the leaf is inserted, zero below it.
__global__ void smt_climb_kernel(const int64_t* __restrict__ sibs,
                                 const int64_t* __restrict__ lr,
                                 const int64_t* __restrict__ top,
                                 const int64_t* __restrict__ inew,
                                 const int64_t* __restrict__ leaf,
                                 int64_t* __restrict__ out,
                                 const uint32_t* __restrict__ pack3, int nP,
                                 int n_levels, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const fr::Fe leaf_m = fr::to_mont(fr::load_limbs(leaf + lane, B));
  fr::Fe child = fr::zero();
  for (int i = 0; i < n_levels; ++i) {
    const fr::Fe sib =
        fr::to_mont(fr::load_limbs(sibs + (long)16 * i * B + lane, B));
    const bool right = lr[(long)i * B + lane] != 0;
    fr::Fe st[3] = {fr::zero(), right ? sib : child, right ? child : sib};
    poseidon::permute<3>(st, pack3, nP);
    child = top[(long)i * B + lane] != 0
                ? st[0]
                : (inew[(long)i * B + lane] != 0 ? leaf_m : fr::zero());
  }
  fr::store_limbs(fr::from_mont(child), out + lane, B);
}

#define PZK_POSEIDON_CASE(T)                                                \
  case T:                                                                   \
    poseidon_kernel<T><<<grid, 128, 0, stream>>>(state, out, pack, nP,      \
                                                 n_outs, B);                \
    break;

extern "C" int pzk_poseidon(const int64_t* state, int64_t* out,
                            const uint32_t* pack, int t, int nP, int n_outs,
                            int B, cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int grid = (B + 127) / 128;
  switch (t) {
    PZK_POSEIDON_CASE(2) PZK_POSEIDON_CASE(3) PZK_POSEIDON_CASE(4)
    PZK_POSEIDON_CASE(5) PZK_POSEIDON_CASE(6) PZK_POSEIDON_CASE(7)
    PZK_POSEIDON_CASE(8) PZK_POSEIDON_CASE(9) PZK_POSEIDON_CASE(10)
    PZK_POSEIDON_CASE(11) PZK_POSEIDON_CASE(12) PZK_POSEIDON_CASE(13)
    PZK_POSEIDON_CASE(14) PZK_POSEIDON_CASE(15) PZK_POSEIDON_CASE(16)
    PZK_POSEIDON_CASE(17)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int pzk_smt_climb(const int64_t* sibs, const int64_t* lr,
                             const int64_t* top, const int64_t* inew,
                             const int64_t* leaf, int64_t* out,
                             const uint32_t* pack3, int nP, int n_levels,
                             int B, cudaStream_t stream) {
  if (B > 0)
    smt_climb_kernel<<<(B + 127) / 128, 128, 0, stream>>>(
        sibs, lr, top, inew, leaf, out, pack3, nP, n_levels, B);
  return (int)cudaGetLastError();
}
