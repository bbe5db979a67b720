// A group of G neighbouring threads of a warp that work on one lane
// together (G a power of two, at most 32) and pass 32-bit words to each
// other. On the device a group is G threads of a warp, joined by shuffles
// of width G and warp ballots. K4 and K5 run a lane on a team of eight
// threads, one word each (fr_team.cuh); K3 splits a lane's Poseidon
// permutation over a group, each state element over a team of its threads
// (poseidon.cuh, permute_split; fr_slice.cuh); K2 spreads a lane's RSA
// numbers over a whole warp (bignum.cuh, namespace bnw). All of them take
// their exchange, and the carry-lookahead that resolves their carries,
// from here.
//
// A host build (g++) runs a group's threads itself and supplies their
// exchange, group_from and group_ballot below:
// tests/torch_csrc_host_check.cc runs the threads as coroutines and checks
// K2's, K3's, K4's and K5's lane bodies that way, bit for bit. Under nvcc
// the group code runs on the device only; its host pass traps.
#pragma once

#include "fr_bn254.cuh"

namespace wp {

// word j of an 8-word constant, by selects (no indexing of local memory)
PZK_HD uint32_t word(const uint32_t (&c)[fr::NW], unsigned j) {
  uint32_t r = c[0];
#pragma unroll
  for (int k = 1; k < fr::NW; ++k) r = j == (unsigned)k ? c[k] : r;
  return r;
}

// a mask of N threads' flags, with room for the carry out of the top one
template <int N>
struct Flags {
  using type = uint32_t;
};
template <>
struct Flags<32> {
  using type = uint64_t;
};

#ifndef __CUDACC__
// Defined by a host build that includes this header: thread i of the group
// being run offers x and gets what thread src offered (group_from), or
// every thread's flag, bit k from thread k (group_ballot); group_thread is
// the thread being run (for this_group, where a policy finds its group
// itself).
uint32_t group_from(unsigned i, uint32_t x, unsigned src);
unsigned group_ballot(unsigned i, bool p);
unsigned group_thread();
#endif

template <int G>
struct Group {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a group is a power of two of threads, at most a warp");
  unsigned i;        // this thread's place in the group, 0..G-1
  unsigned shift;    // the group's first thread in its warp

  // x as held by group thread src (mod G)
  PZK_HD uint32_t from(uint32_t x, unsigned src) const {
#if defined(__CUDA_ARCH__)
    return __shfl_sync(0xFFFFFFFFu, x, (int)(src % G), G);
#elif defined(__CUDACC__)
    __builtin_trap();  // nvcc's host pass: group code runs on the device only
#else
    return group_from(i, x, src % G);
#endif
  }

  // x as held by group thread src, where the group may run apart from the
  // rest of its warp (the group branches on its own data, its threads
  // together): the shuffle names the group's threads alone
  PZK_HD uint32_t from_group(uint32_t x, unsigned src) const {
#if defined(__CUDA_ARCH__)
    const unsigned mask = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1) << shift;
    return __shfl_sync(mask, x, (int)(src % G), G);
#elif defined(__CUDACC__)
    __builtin_trap();  // nvcc's host pass: group code runs on the device only
#else
    return group_from(i, x, src % G);
#endif
  }

  // bit k: p as held by group thread k
  PZK_HD unsigned ballot(bool p) const {
#if defined(__CUDA_ARCH__)
    const unsigned m = __ballot_sync(0xFFFFFFFFu, p);
    return G == 32 ? m : (m >> shift) & ((1u << G) - 1);
#elif defined(__CUDACC__)
    __builtin_trap();  // nvcc's host pass: group code runs on the device only
#else
    return group_ballot(i, p);
#endif
  }

  // whether any thread of the warp has p set (of the group on the host,
  // where a warp is one group): the warp takes a branch together
  PZK_HD bool any(bool p) const {
#if defined(__CUDA_ARCH__)
    return __any_sync(0xFFFFFFFFu, p);
#else
    return ballot(p) != 0;
#endif
  }

  // Carry (or borrow) into this thread's words by carry-lookahead over the
  // N threads first .. first + N-1 of the group, this one among them (as in
  // NVIDIA's CGBN): from each one's generate (a carry out with none in) and
  // propagate (a carry in goes through) flags, one addition of the two
  // masks gives every thread its carry in. out: the carry out of the last.
  template <int N = G>
  PZK_HD uint32_t carry_in(bool gen, bool prop, bool& out,
                           unsigned first = 0) const {
    using M = typename Flags<N>::type;
    M gm = ballot(gen), u = ballot(prop);
    if constexpr (N < G) {
      gm = (gm >> first) & ((1u << N) - 1);
      u = (u >> first) & ((1u << N) - 1);
    }
    u |= gm;
    const M x = u + gm;
    out = (x >> N) & 1;
    return (uint32_t)(((x ^ u ^ gm) >> (i - first)) & 1);
  }

  // an element of Fr as held by group thread src: eight words
  PZK_HD fr::Fe from(const fr::Fe& x, unsigned src) const {
    fr::Fe r;
#pragma unroll
    for (int k = 0; k < fr::NW; ++k) r.w[k] = from(x.w[k], src);
    return r;
  }
};

#ifdef __CUDACC__
// The group of the calling thread: threads G*m .. G*m + G-1 of its warp.
// Every thread of the warp must reach each shuffle and ballot, so a kernel
// sizes its blocks in whole warps and keeps threads past the batch running
// on a clamped lane.
template <int G>
__device__ __forceinline__ Group<G> device_group() {
  const unsigned l = threadIdx.x % 32;
  return Group<G>{l % G, l - l % G};
}
#endif

// The calling thread's group, on the device or in a host build
// (group_thread)
template <int G>
PZK_HD Group<G> this_group() {
#if defined(__CUDA_ARCH__)
  return device_group<G>();
#elif defined(__CUDACC__)
  __builtin_trap();  // nvcc's host pass: group code runs on the device only
#else
  return Group<G>{group_thread(), 0};
#endif
}

}  // namespace wp
