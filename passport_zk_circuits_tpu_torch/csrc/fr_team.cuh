// BN254 Fr spread over a team of eight threads: thread j of a team holds
// word j (32 bits) of each element, little-endian, Montgomery form, always
// canonical, as in fr_bn254.cuh. Used by K4 (the SMT climb) and K5 (the
// ladder), where one thread a lane left 1024 lanes on 8 of the card's 132
// SMs with one dependent chain each: a team puts eight threads on a lane, so
// B = 1024 is 256 warps, and a product's chain is split eight ways.
//
// The Montgomery product is CIOS across the team. Per word a_i of a
// (broadcast with a shuffle): every thread adds a_i * b_j to its column,
// thread 0's low word gives m = t0 * (-P^-1) (broadcast), every thread adds
// m * p_j, and the columns move down one thread (a shuffle); a column keeps
// its carries as a 64-bit value below 2^34, so no carry crosses threads
// inside the loop. At the end the carries are resolved in one step: each
// thread's carry-out (generate) and all-ones word (propagate) go into two
// ballots, and one integer addition of the two masks gives every thread its
// carry-in (carry-lookahead, as in NVIDIA's CGBN). add, sub and the final
// conditional subtract of P resolve their carries and borrows the same way.
//
// A Team is also the arithmetic policy of poseidon.cuh and babyjubjub.cuh
// (see fr::Lane): the algorithms are written once and run per thread (K3)
// or per team (K4, K5).
//
// A host build (g++) runs a team's threads itself and supplies their
// exchange, team_from and team_ballot below: tests/torch_csrc_host_check.cc
// runs the threads as coroutines and checks the team arithmetic, the climb
// and the ladder that way, bit for bit. Under nvcc the team code runs on the
// device only; its host pass traps.
#pragma once

#include "fr_bn254.cuh"

namespace frt {

constexpr int TEAM = 8;                    // threads a lane, one word each
constexpr unsigned TEAM_MASK = (1u << TEAM) - 1;

// word j of an 8-word constant, by selects (no indexing of local memory)
PZK_HD uint32_t word(const uint32_t (&c)[fr::NW], unsigned j) {
  uint32_t r = c[0];
#pragma unroll
  for (int k = 1; k < fr::NW; ++k) r = j == (unsigned)k ? c[k] : r;
  return r;
}

#ifndef __CUDACC__
// Defined by a host build that includes this header: thread j of the team
// being run offers x and gets what thread src offered (team_from), or every
// thread's flag, bit k from thread k (team_ballot).
uint32_t team_from(unsigned j, uint32_t x, unsigned src);
unsigned team_ballot(unsigned j, bool p);
#endif

struct Team {
  using Fe = uint32_t;
  unsigned j;        // the word this thread holds, 0..TEAM-1
  unsigned shift;    // first bit of this team in a warp-wide ballot
  uint32_t pj;       // word j of P

  // x as held by team thread src (mod TEAM)
  PZK_HD uint32_t from(uint32_t x, unsigned src) const {
#if defined(__CUDA_ARCH__)
    return __shfl_sync(0xFFFFFFFFu, x, (int)(src % TEAM), TEAM);
#elif defined(__CUDACC__)
    __builtin_trap();  // nvcc's host pass: team code runs on the device only
#else
    return team_from(j, x, src % TEAM);
#endif
  }

  // bit k: p as held by team thread k
  PZK_HD unsigned ballot(bool p) const {
#if defined(__CUDA_ARCH__)
    return (__ballot_sync(0xFFFFFFFFu, p) >> shift) & TEAM_MASK;
#elif defined(__CUDACC__)
    __builtin_trap();  // nvcc's host pass: team code runs on the device only
#else
    return team_ballot(j, p);
#endif
  }

  // whether any thread of the warp has p set (of the team on the host,
  // where a warp is one team): the warp takes a branch together
  PZK_HD bool any(bool p) const {
#if defined(__CUDA_ARCH__)
    return __any_sync(0xFFFFFFFFu, p);
#else
    return ballot(p) != 0;
#endif
  }

  // Carry (or borrow) into this thread's word, given every word's
  // generate and propagate flags; out: the carry out of the top word.
  PZK_HD uint32_t carry_in(bool generate, bool propagate, bool& out) const {
    const unsigned g = ballot(generate);
    const unsigned u = g | ballot(propagate);
    const unsigned x = u + g;
    out = (x >> TEAM) & 1;
    return ((x ^ u ^ g) >> j) & 1;
  }

  // w mod P for a canonical-word value w < 2P
  PZK_HD Fe reduce_once(Fe w) const {
    const uint32_t d = w - pj;
    bool borrow;
    const uint32_t b = carry_in(w < pj, w == pj, borrow);
    return borrow ? w : d - b;
  }

  PZK_HD Fe zero() const { return 0; }
  PZK_HD Fe one() const {
    const uint32_t o[fr::NW] = {PZK_FR_ONE};
    return word(o, j);
  }
  PZK_HD Fe small(uint32_t v) const { return j == 0 ? v : 0; }

  // a + b mod P, a, b < P
  PZK_HD Fe add(Fe a, Fe b) const {
    const uint32_t s = a + b;
    bool top;
    return reduce_once(s + carry_in(s < a, s == 0xFFFFFFFFu, top));
  }

  // a - b mod P, a, b < P
  PZK_HD Fe sub(Fe a, Fe b) const {
    const uint32_t d0 = a - b;
    bool borrow, top;
    const uint32_t d = d0 - carry_in(a < b, d0 == 0, borrow);
    const uint32_t e0 = d + pj;
    const uint32_t e = e0 + carry_in(e0 < d, e0 == 0xFFFFFFFFu, top);
    return borrow ? e : d;
  }

  // Montgomery product a * b / 2^256 mod P (CIOS across the team); a < 2^256,
  // b < P, so the value before the final subtract is below 2P.
  PZK_HD Fe mul(Fe a, Fe b) const {
    uint64_t t = 0;                  // column j, below 2^34
#pragma unroll
    for (int i = 0; i < TEAM; ++i) {
      const uint64_t v = (uint64_t)from(a, i) * b + (uint32_t)t;
      const uint32_t lo = (uint32_t)v;
      const uint32_t m = from(lo * fr::PINV, 0);
      const uint64_t w = lo + (uint64_t)m * pj;     // thread 0: low word 0
      const uint32_t next = from((uint32_t)w, j + 1);
      t = (v >> 32) + (t >> 32) + (w >> 32) + (j + 1 < TEAM ? next : 0u);
    }
    // the columns' high parts (< 4) move up one word
    const uint32_t lo = (uint32_t)t;
    const uint32_t up = from((uint32_t)(t >> 32), j + TEAM - 1);
    const uint32_t s = lo + (j ? up : 0u);
    bool top;
    return reduce_once(s + carry_in(s < lo, s == 0xFFFFFFFFu, top));
  }

  PZK_HD Fe sqr(Fe a) const { return mul(a, a); }

  PZK_HD Fe to_mont(Fe a) const {
    const uint32_t r2[fr::NW] = {PZK_FR_R2};
    return mul(a, word(r2, j));
  }

  PZK_HD Fe from_mont(Fe a) const { return mul(a, j == 0 ? 1u : 0u); }

  PZK_HD Fe at(const uint32_t* base, int idx) const {
    return base[fr::NW * idx + j];
  }

  // word j of 16 little-endian 16-bit limbs (int64 each) at x[i * stride]
  PZK_HD Fe load(const int64_t* x, long stride) const {
    return (uint32_t)(x[(2 * j) * stride] & 0xFFFF) |
           ((uint32_t)(x[(2 * j + 1) * stride] & 0xFFFF) << 16);
  }

  PZK_HD void store(Fe a, int64_t* x, long stride) const {
    x[(2 * j) * stride] = a & 0xFFFF;
    x[(2 * j + 1) * stride] = a >> 16;
  }
};

PZK_HD Team make_team(unsigned j, unsigned shift) {
  const uint32_t p[fr::NW] = {PZK_FR_P};
  Team tm;
  tm.j = j;
  tm.shift = shift;
  tm.pj = word(p, j);
  return tm;
}

#ifdef __CUDACC__
// The team of the calling thread: threads 8k..8k+7 of a warp. Every thread
// of the warp must reach each shuffle and ballot, so a kernel sizes its
// blocks in whole warps and keeps threads past the batch running on a
// clamped lane.
__device__ __forceinline__ Team device_team() {
  const unsigned lane = threadIdx.x % 32;
  return make_team(lane % TEAM, lane - lane % TEAM);
}
#endif

}  // namespace frt
