// K8: a field-op body (loop_bodies.cuh) looped n_iter times in one kernel,
// the state in registers. Replaces the TPU kernel run_loop of
// tools/microbench_kernel.py, a Pallas fori_loop over a body run on the
// whole (16, B) block as vectors.
//
// A body's time an iteration is the latency of its dependent chain: the
// kernel is bound by that chain, never by the 256 bytes a lane reads and
// the 128 it writes. So each body's work goes to the card by how it
// depends on itself:
//
// - u32_mul_add, i32_mul_add and mask_shift_add (loopb::PerLimb) carry 16
//   independent chains a lane, one a limb: one thread a (limb, lane),
//   16 B threads in blocks of loopb::LIMB_BLOCK = 128, one warp for each
//   SM sub-partition, so B = 1024 spreads over 128 SMs
//   (loopb::limb_thread). A step is then one thread's two dependent
//   instructions (IMAD, LOP3); a thread holding a whole lane would issue
//   32 a step, and 1024 lanes would fill only 32 SMs with one warp each.
// - modmul_mont32 is K7's chain with a per-lane c: K7's lane body
//   (frs::mul_chain_lane, a team of 8 / frs::CHAIN_W threads a lane), in
//   one-warp blocks (loopb::team_chain). loopb::ModmulMont32 is host-only,
//   the one-thread form that the host tests hold this body to.
// - school, modmul_barrett16 and barrett_only, the TPU's 16-bit
//   formulation kept to compare with it, keep one lane a thread in
//   one-warp blocks: spread over a team they would need a second team
//   product beside frs::Slice's, and their ns/op then stay those of one
//   thread's 16-bit chain, the figure they are kept for.
//
// loopb::opaque keeps the compiler from replacing a chain of the simple
// bodies by its closed form, which would time nothing.
#include <cuda_runtime.h>

#include "fr_slice.cuh"
#include "loop_bodies.cuh"

constexpr int kThreads = 32;
constexpr int kTeam = fr::NW / frs::CHAIN_W;

// a, c, out: (16, B); one thread a (limb, lane)
template <class Body>
__global__ void __launch_bounds__(loopb::LIMB_BLOCK)
    loop_limb_kernel(const int64_t* __restrict__ a,
                     const int64_t* __restrict__ c,
                     int64_t* __restrict__ out, int n_iter, int B) {
  loopb::limb_thread<Body>(a, c, out, n_iter,
                           (long)blockIdx.x * blockDim.x + threadIdx.x, B);
}

// modmul_mont32: a lane on a team of kTeam threads, K7's lane body
__global__ void __launch_bounds__(kThreads)
    loop_team_kernel(const int64_t* __restrict__ a,
                     const int64_t* __restrict__ c,
                     int64_t* __restrict__ out, int n_iter, int B) {
  const long lane = ((long)blockIdx.x * blockDim.x + threadIdx.x) / kTeam;
  frs::mul_chain_lane<frs::CHAIN_W>(wp::device_group<kTeam>(), a, c, 0, out,
                                    n_iter, lane, B);
}

// one lane a thread
template <class Body>
__global__ void __launch_bounds__(kThreads)
    loop_lane_kernel(const int64_t* __restrict__ a,
                     const int64_t* __restrict__ c,
                     int64_t* __restrict__ out, int n_iter, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  typename Body::S x = Body::enter(loopb::load16(a + lane, B));
  const typename Body::S k = Body::enter(loopb::load16(c + lane, B));
  for (int i = 0; i < n_iter; ++i) {
    x = Body::step(x, k);
    loopb::opaque(x);
  }
  loopb::store16(Body::leave(x), out + lane, B);
}

template <class Body>
void launch(const int64_t* a, const int64_t* c, int64_t* out, int n_iter,
            int B, cudaStream_t stream) {
  if constexpr (loopb::per_limb<Body>) {
    const long threads = (long)loopb::NL * B;
    loop_limb_kernel<Body>
        <<<(threads + loopb::LIMB_BLOCK - 1) / loopb::LIMB_BLOCK,
           loopb::LIMB_BLOCK, 0, stream>>>(a, c, out, n_iter, B);
  } else if constexpr (loopb::team_chain<Body>) {
    const long threads = (long)B * kTeam;
    loop_team_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(a, c, out, n_iter, B);
  } else {
    loop_lane_kernel<Body><<<(B + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(a, c, out, n_iter, B);
  }
}

#define PZK_LOOP_CASE(id, T)                                \
  case id:                                                  \
    launch<loopb::T>(a, c, out, n_iter, B, stream);         \
    break;

extern "C" int pzk_loop(int body, const int64_t* a, const int64_t* c,
                        int64_t* out, int n_iter, int B,
                        cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  switch (body) {
    PZK_LOOP_BODIES(PZK_LOOP_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
