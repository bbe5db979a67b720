// K3 and K4: the circomlib PoseidonEx permutation and the whole SMT root
// climb (poseidon.cuh). Replace the TPU kernels _permute / poseidon_ex and
// smt_climb of passport_zk_circuits_tpu/ops/pallas_poseidon.py.
//
// A permutation is ~65-70 rounds of dependent Montgomery products (t = 6:
// about 1,300 of them, each 64 32-bit multiply-adds twice over), so both
// kernels are bound by the latency of integer multiply chains, not bytes:
// at B = 1024 there are too few lanes to hide a chain behind others.
//
// K3 splits a lane's permutation over a group of threads
// (poseidon.cuh, permute_split): the state's elements side by side, each
// over a team of threads that holds its words (fr_slice.cuh): 2 x 4
// threads at t = 2, 4 x 4 at t = 3, 4, 8 x 4 at t = 5-8, 16 x 2 at t =
// 9-16, 32 x 1 at t = 17. A full round's mix gathers the elements by
// shuffle and forms the element's output column from independent
// products; a partial round's new element 0 is a shuffle butterfly. A
// round then waits on about 4 team products instead of 2t + 2 products of
// one thread, and B = 1024 lanes fill 256 (t = 2), 512 (t = 3, 4) or 1024
// one-warp blocks. The constant pack (8 KB at t = 2 to 97 KB at t = 17) is
// read through the read-only data path (const __restrict__) for every t:
// a team reads a round's one or two entries, its threads on neighbouring
// words, at the round's start, and their latency hides under the S-box's
// three products.
//
// K4 runs a team of eight threads a lane (fr_team.cuh), one word each, in
// blocks of one warp (four lanes): B = 1024 is 256 blocks, so every SM gets
// work. Its t = 3 pack (12 KB) sits in shared memory, where the eight
// threads of a team read eight banks and the four teams of a warp share
// them. A warp skips a level when none of its lanes is on the top path
// there (the hash would be discarded), so a batch pays for the levels its
// proofs use. The TPU route is capped at t <= 8 by an f32 exactness bound
// of the MXU; K3 takes every t from 2 to 17.
#include <cuda_runtime.h>

#include "fr_team.cuh"
#include "poseidon.cuh"

// state: (16 T, B) canonical limbs, element j in rows 16j..16j+15;
// out: (16 n_outs, B). One warp a block, 32 / GL lanes a warp.
template <int T>
__global__ void __launch_bounds__(32)
    poseidon_kernel(const int64_t* __restrict__ state,
                    int64_t* __restrict__ out,
                    const uint32_t* __restrict__ pack, int nP, int n_outs,
                    int B) {
  constexpr int W = poseidon::slice_words(T);
  constexpr int GL = poseidon::lane_threads(T, W);
  const long lane = ((long)blockIdx.x * blockDim.x + threadIdx.x) / GL;
  poseidon::poseidon_lane<T, W>(wp::device_group<GL>(), state, out, pack,
                                nP, n_outs, lane, B);
}

// sibs: (16 N, B) deepest level first; lr, top, inew: (N, B) flags;
// leaf: (16, B) = Poseidon(key, value, 1); out: (16, B) computed root.
// One warp a block, a team of eight threads a lane; pack3 goes to shared
// memory first.
__global__ void __launch_bounds__(32)
    smt_climb_kernel(const int64_t* __restrict__ sibs,
                     const int64_t* __restrict__ lr,
                     const int64_t* __restrict__ top,
                     const int64_t* __restrict__ inew,
                     const int64_t* __restrict__ leaf,
                     int64_t* __restrict__ out,
                     const uint32_t* __restrict__ pack3, int nP, int n_levels,
                     int B) {
  extern __shared__ uint32_t k3[];
  const int words = fr::NW * poseidon::pack_entries(3, nP);
  for (int w = threadIdx.x; w < words; w += blockDim.x) k3[w] = pack3[w];
  __syncthreads();
  const frt::Team tm = frt::device_team();
  const long lane = (long)blockIdx.x * (blockDim.x / frt::TEAM) +
                    threadIdx.x / frt::TEAM;
  // threads past the batch run on its last lane and store nothing
  const long mine = lane < B ? lane : B - 1;
  const uint32_t root = poseidon::smt_climb(tm, sibs, lr, top, inew, leaf,
                                            k3, nP, n_levels, mine, B);
  const uint32_t canon = tm.from_mont(root);
  if (lane < B) tm.store(canon, out + lane, B);
}

#define PZK_POSEIDON_CASE(T)                                                \
  case T:                                                                   \
    poseidon_kernel<T><<<((long)B * poseidon::lane_threads(                 \
                              T, poseidon::slice_words(T)) + 31) / 32,      \
                          32, 0, stream>>>(state, out, pack, nP, n_outs, B); \
    break;

extern "C" int pzk_poseidon(const int64_t* state, int64_t* out,
                            const uint32_t* pack, int t, int nP, int n_outs,
                            int B, cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
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
  constexpr int LANES = 32 / frt::TEAM;                // lanes a block
  const size_t smem = 4 * fr::NW * poseidon::pack_entries(3, nP);
  if (B > 0)
    smt_climb_kernel<<<(B + LANES - 1) / LANES, 32, smem, stream>>>(
        sibs, lr, top, inew, leaf, out, pack3, nP, n_levels, B);
  return (int)cudaGetLastError();
}
