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
// carry-in (carry-lookahead, wp::Group::carry_in). add, sub and the final
// conditional subtract of P resolve their carries and borrows the same way.
//
// A Team is also the arithmetic policy of poseidon.cuh and babyjubjub.cuh
// (see fr::Lane): the algorithms are written once and run per thread (K3)
// or per team (K4, K5).
//
// A team is a wp::Group of eight threads (warp.cuh), whose exchange a host
// build supplies: tests/torch_csrc_host_check.cc runs the threads as
// coroutines and checks the team arithmetic, the climb and the ladder that
// way, bit for bit.
#pragma once

#include "fr_bn254.cuh"
#include "warp.cuh"

namespace frt {

constexpr int TEAM = 8;                    // threads a lane, one word each

struct Team {
  using Fe = uint32_t;
  wp::Group<TEAM> g;  // g.i: the word this thread holds, 0..TEAM-1
  uint32_t pj;        // word g.i of P

  // whether any thread of the warp has p set: the warp takes a branch
  // together
  PZK_HD bool any(bool p) const { return g.any(p); }

  // w mod P for a canonical-word value w < 2P
  PZK_HD Fe reduce_once(Fe w) const {
    const uint32_t d = w - pj;
    bool borrow;
    const uint32_t b = g.carry_in(w < pj, w == pj, borrow);
    return borrow ? w : d - b;
  }

  PZK_HD Fe zero() const { return 0; }
  PZK_HD Fe one() const {
    const uint32_t o[fr::NW] = {PZK_FR_ONE};
    return wp::word(o, g.i);
  }
  PZK_HD Fe small(uint32_t v) const { return g.i == 0 ? v : 0; }

  // a + b mod P, a, b < P
  PZK_HD Fe add(Fe a, Fe b) const {
    const uint32_t s = a + b;
    bool top;
    return reduce_once(s + g.carry_in(s < a, s == 0xFFFFFFFFu, top));
  }

  // a - b mod P, a, b < P
  PZK_HD Fe sub(Fe a, Fe b) const {
    const uint32_t d0 = a - b;
    bool borrow, top;
    const uint32_t d = d0 - g.carry_in(a < b, d0 == 0, borrow);
    const uint32_t e0 = d + pj;
    const uint32_t e = e0 + g.carry_in(e0 < d, e0 == 0xFFFFFFFFu, top);
    return borrow ? e : d;
  }

  // Montgomery product a * b / 2^256 mod P (CIOS across the team); a < 2^256,
  // b < P, so the value before the final subtract is below 2P.
  PZK_HD Fe mul(Fe a, Fe b) const {
    uint64_t t = 0;                  // column j, below 2^34
#pragma unroll
    for (int i = 0; i < TEAM; ++i) {
      const uint64_t v = (uint64_t)g.from(a, i) * b + (uint32_t)t;
      const uint32_t lo = (uint32_t)v;
      const uint32_t m = g.from(lo * fr::PINV, 0);
      const uint64_t w = lo + (uint64_t)m * pj;     // thread 0: low word 0
      const uint32_t next = g.from((uint32_t)w, g.i + 1);
      t = (v >> 32) + (t >> 32) + (w >> 32) + (g.i + 1 < TEAM ? next : 0u);
    }
    // the columns' high parts (< 4) move up one word
    const uint32_t lo = (uint32_t)t;
    const uint32_t up = g.from((uint32_t)(t >> 32), g.i + TEAM - 1);
    const uint32_t s = lo + (g.i ? up : 0u);
    bool top;
    return reduce_once(s + g.carry_in(s < lo, s == 0xFFFFFFFFu, top));
  }

  PZK_HD Fe sqr(Fe a) const { return mul(a, a); }

  PZK_HD Fe to_mont(Fe a) const {
    const uint32_t r2[fr::NW] = {PZK_FR_R2};
    return mul(a, wp::word(r2, g.i));
  }

  PZK_HD Fe from_mont(Fe a) const { return mul(a, g.i == 0 ? 1u : 0u); }

  PZK_HD Fe at(const uint32_t* base, int idx) const {
    return base[fr::NW * idx + g.i];
  }

  // word g.i of 16 little-endian 16-bit limbs (int64 each) at
  // x[i * stride]
  PZK_HD Fe load(const int64_t* x, long stride) const {
    const long j = g.i;
    return (uint32_t)(x[(2 * j) * stride] & 0xFFFF) |
           ((uint32_t)(x[(2 * j + 1) * stride] & 0xFFFF) << 16);
  }

  PZK_HD void store(Fe a, int64_t* x, long stride) const {
    const long j = g.i;
    x[(2 * j) * stride] = a & 0xFFFF;
    x[(2 * j + 1) * stride] = a >> 16;
  }
};

// The team arithmetic of team thread g.i
PZK_HD Team make_team(const wp::Group<TEAM>& g) {
  const uint32_t p[fr::NW] = {PZK_FR_P};
  Team tm;
  tm.g = g;
  tm.pj = wp::word(p, g.i);
  return tm;
}

#ifdef __CUDACC__
// The team of the calling thread: threads 8k..8k+7 of a warp (see
// wp::device_group)
__device__ __forceinline__ Team device_team() {
  return make_team(wp::device_group<TEAM>());
}
#endif

}  // namespace frt
