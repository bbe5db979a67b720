// BN254 Fr with each element spread over a team of TW = 8 / W threads, W
// words a thread, inside a lane group of GL threads (warp.cuh): the
// arithmetic of K3, whose lane group holds one element of the Poseidon
// state per team. Thread i of the group holds words qW .. qW + W-1 of
// element e, for e = i / TW and q = i % TW, little-endian, Montgomery form,
// always canonical, as in fr_bn254.cuh.
//
// One thread a lane runs a 256-bit product as a chain of 128 dependent
// multiply-adds; spread over a team, each thread runs W columns of it. The
// product is CIOS across the team: per word a_i (broadcast from its
// thread), every thread adds a_i * b_c to its columns, the team's lowest
// word gives m = t_0 * (-P^-1) (broadcast), every thread adds m * p_c, and
// the columns move down a word (one shuffle from the next thread). A column
// keeps its carries as a 64-bit value below 2^34, so no carry crosses
// threads in the loop; at the end the carries, and those of add, sub and
// the final subtract of P, are resolved by carry-lookahead over two
// ballots of the team (wp::Group::carry_in). W = 1 is the arithmetic of
// fr_team.cuh's team of eight, one word a thread. With W = 8 (a team of
// one) every operation is fr_bn254.cuh's own. K3 ships W = 2 (a team of
// four) up to t = 8; K6 (mul_lane, below) and K7 (mul_chain_lane) run a
// lane on one team (tools/kernel_designs times every W for all three).
//
// A host build runs a group's threads itself through warp.cuh's exchange;
// tests/torch_csrc_host_check.cc runs K3's, K6's and K7's lane bodies that
// way.
#pragma once

#include "fr_bn254.cuh"
#include "warp.cuh"

namespace frs {

template <int W, int GL>
struct Slice {
  static_assert(W == 1 || W == 2 || W == 4 || W == 8, "W divides 8");
  static constexpr int TW = fr::NW / W;       // threads an element
  static_assert(GL % TW == 0 && GL <= 32, "whole teams in a warp");

  struct Fe {
    uint32_t w[W];
  };

  wp::Group<GL> g;
  unsigned e;          // the element this thread holds a slice of
  unsigned q;          // its slice: words qW .. qW + W-1
  uint32_t p[W];       // the same words of P

  // -- exchange within the element's team ----------------------------------
  PZK_HD uint32_t team(uint32_t x, unsigned s) const {
    if constexpr (TW == 1)
      return x;
    else
      return g.from(x, e * TW + s % TW);
  }

  // Carry (or borrow) into this thread's words, from every team thread's
  // generate (carry out with none in) and propagate flags; out: the carry
  // out of the team's top thread.
  PZK_HD uint32_t carry_in(bool gen, bool prop, bool& out) const {
    if constexpr (TW == 1) {
      out = gen;
      return 0;
    } else {
      return g.template carry_in<TW>(gen, prop, out, e * TW);
    }
  }

  // element j's slice, from the thread of element j that holds this one's
  // words
  PZK_HD Fe elem(const Fe& x, unsigned j) const {
    Fe r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.w[w] = g.from(x.w[w], j * TW + q);
    return r;
  }

  // -- as fr:: on a whole element when the team is one thread --------------
  PZK_HD static fr::Fe whole(const Fe& a) {
    fr::Fe r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.w[w] = a.w[w];
    return r;
  }
  PZK_HD static Fe part(const fr::Fe& a) {
    Fe r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.w[w] = a.w[w];
    return r;
  }

  PZK_HD Fe zero() const {
    Fe r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.w[w] = 0;
    return r;
  }

  PZK_HD static Fe select(bool c, const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.w[w] = c ? a.w[w] : b.w[w];
    return r;
  }

  // s mod P for a value s < 2P
  PZK_HD Fe reduce_once(const Fe& s) const {
    Fe d;
    uint32_t c = 0;
    bool zero = true;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t v = (uint64_t)s.w[w] - p[w] - c;
      d.w[w] = (uint32_t)v;
      c = (uint32_t)(v >> 32) & 1;
      zero = zero & (d.w[w] == 0);
    }
    bool borrow;
    uint32_t bin = carry_in(c != 0, zero, borrow);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t next = bin & (d.w[w] == 0);
      d.w[w] -= bin;
      bin = next;
    }
    return select(borrow, s, d);
  }

  // a + b mod P, a, b < P
  PZK_HD Fe add(const Fe& a, const Fe& b) const {
    if constexpr (TW == 1) return part(fr::add(whole(a), whole(b)));
    Fe s;
    uint32_t c = 0;
    bool ones = true;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t v = (uint64_t)a.w[w] + b.w[w] + c;
      s.w[w] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
      ones = ones & (s.w[w] == 0xFFFFFFFFu);
    }
    bool top;                                    // a + b < 2P < 2^256
    uint32_t cin = carry_in(c != 0, ones, top);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t next = cin & (s.w[w] == 0xFFFFFFFFu);
      s.w[w] += cin;
      cin = next;
    }
    return reduce_once(s);
  }

  // Montgomery product a * b / 2^256 mod P, a < 2^256, b < P.
  PZK_HD Fe mul(const Fe& a, const Fe& b) const {
    if constexpr (TW == 1) return part(fr::mul(whole(a), whole(b)));
    return reduce_once(mul_lazy(a, b));
  }

  // mul without its final subtract, for the same a and b: a * b / 2^256
  // mod P or that plus P, below 2P. A chain x <- x * c (c < P) can so keep
  // x below 2P and leave the subtract to its end (K7).
  PZK_HD Fe mul_lazy(const Fe& a, const Fe& b) const {
    if constexpr (TW == 1) return part(fr::mul(whole(a), whole(b)));
    uint64_t t[W];
#pragma unroll
    for (int c = 0; c < W; ++c) t[c] = 0;
#pragma unroll
    for (int s = 0; s < TW; ++s) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t ai = team(a.w[w], s);
        const uint64_t v0 = (uint64_t)ai * b.w[0] + (uint32_t)t[0];
        const uint32_t m = team((uint32_t)v0 * fr::PINV, 0);
        const uint64_t x0 = (uint64_t)(uint32_t)v0 + (uint64_t)m * p[0];
        const uint32_t up = team((uint32_t)x0, q + 1);
        // column c's carries go down to column c - 1 with the low word of
        // column c + 1
        uint64_t carry = (v0 >> 32) + (t[0] >> 32) + (x0 >> 32);
#pragma unroll
        for (int c = 1; c < W; ++c) {
          const uint64_t v = (uint64_t)ai * b.w[c] + (uint32_t)t[c];
          const uint64_t x = (uint64_t)(uint32_t)v + (uint64_t)m * p[c];
          t[c - 1] = carry + (uint32_t)x;
          carry = (v >> 32) + (t[c] >> 32) + (x >> 32);
        }
        // the top thread's up is thread 0's low word, which m made zero. A
        // per-thread condition here made the compiler branch around the
        // whole product, splitting the team's shuffles.
        t[W - 1] = carry + up;
      }
    }
    // the columns' carries (< 4) move up a word, then one lookahead; thread
    // 0's comes from the top word, whose carry is zero (the value is below
    // 2P < 2^255)
    Fe s;
    uint32_t c = team((uint32_t)(t[W - 1] >> 32), q + TW - 1);
    bool ones = true;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t v = (uint64_t)(uint32_t)t[w] + c;
      s.w[w] = (uint32_t)v;
      ones = ones & (s.w[w] == 0xFFFFFFFFu);
      c = (uint32_t)(v >> 32) + (w + 1 < W ? (uint32_t)(t[w] >> 32) : 0u);
    }
    bool top;                                    // the value is below 2^256
    uint32_t cin = carry_in(c != 0, ones, top);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t next = cin & (s.w[w] == 0xFFFFFFFFu);
      s.w[w] += cin;
      cin = next;
    }
    return s;
  }

  PZK_HD Fe sqr(const Fe& a) const { return mul(a, a); }

  PZK_HD Fe to_mont(const Fe& a) const {
    const uint32_t r2[fr::NW] = {PZK_FR_R2};
    Fe b;
#pragma unroll
    for (int w = 0; w < W; ++w) b.w[w] = wp::word(r2, q * W + w);
    return mul(a, b);
  }

  PZK_HD Fe from_mont(const Fe& a) const {
    Fe one = zero();
    one.w[0] = q == 0 ? 1u : 0u;
    return mul(a, one);
  }

  // entry idx of a table of 8-word Montgomery constants
  PZK_HD Fe at(const uint32_t* base, int idx) const {
    Fe r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.w[w] = base[fr::NW * idx + q * W + w];
    return r;
  }

  // this thread's words of 16 little-endian 16-bit limbs (int64 each) at
  // x[i * stride]
  PZK_HD Fe load(const int64_t* x, long stride) const {
    Fe r;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const long j = q * W + w;
      r.w[w] = (uint32_t)(x[(2 * j) * stride] & 0xFFFF) |
               ((uint32_t)(x[(2 * j + 1) * stride] & 0xFFFF) << 16);
    }
    return r;
  }

  PZK_HD void store(const Fe& a, int64_t* x, long stride) const {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const long j = q * W + w;
      x[(2 * j) * stride] = a.w[w] & 0xFFFF;
      x[(2 * j + 1) * stride] = a.w[w] >> 16;
    }
  }
};

// The slice arithmetic of group thread g.i
template <int W, int GL>
PZK_HD Slice<W, GL> make_slice(const wp::Group<GL>& g) {
  const uint32_t p[fr::NW] = {PZK_FR_P};
  Slice<W, GL> s;
  s.g = g;
  s.e = g.i / Slice<W, GL>::TW;
  s.q = g.i % Slice<W, GL>::TW;
#pragma unroll
  for (int w = 0; w < W; ++w) s.p[w] = wp::word(p, s.q * W + w);
  return s;
}

// The words a thread of K7's team: W = 2, a team of four, is the fastest
// of W = 1, 2, 4, 8 (tools/kernel_designs --kernel k7). K8's modmul_mont32
// body runs K7's lane body at the same W.
constexpr int CHAIN_W = 2;

// K6's lane body: out = a * b mod P, canonical, for lane `lane` of B, on a
// team of 8 / W threads (the group is the team). a, out: (16, B) limbs; b:
// (16, B), or one (16, 1) column that every lane reads when b_bcast. Any a,
// b below 2^256 is taken, in two products: x = mul(a, R^2) = a R mod P,
// then mul(b, x) = a b mod P. Each takes its unreduced value (a, then b)
// as the word-by-word operand and a canonical one (R^2 mod P, then x) as
// the column operand, as Slice::mul asks (a < 2^256, b < P): every partial
// sum of the CIOS then stays below b + P < 2P, so the one final subtract of
// each product leaves it canonical. A lane past the batch runs on lane B - 1
// and stores nothing.
template <int W>
PZK_HD void mul_lane(const wp::Group<fr::NW / W>& g, const int64_t* a,
                     const int64_t* b, int b_bcast, int64_t* out, long lane,
                     long B) {
  const Slice<W, fr::NW / W> f = make_slice<W>(g);
  const long mine = lane < B ? lane : B - 1;
  const typename Slice<W, fr::NW / W>::Fe x = f.to_mont(f.load(a + mine, B));
  const typename Slice<W, fr::NW / W>::Fe y =
      f.mul(f.load(b + (b_bcast ? 0 : mine), b_bcast ? 1 : B), x);
  if (lane < B) f.store(y, out + lane, B);
}

// K7's lane body: n dependent steps x <- x * c mod P from x = a, for lane
// `lane` of B, on a team of 8 / W threads (the group is the team). a, out:
// (16, B) limbs; c: (16, B), or one (16, 1) column that every lane reads
// when c_bcast. Both go to Montgomery form first, so any value below 2^256
// is taken; n = 0 copies a as it is (unreduced). The chain's products
// skip their final subtract (x stays below 2P; from_mont reduces it), which
// shortens each by two ballots. A lane past the batch runs on lane B - 1
// and stores nothing.
template <int W>
PZK_HD void mul_chain_lane(const wp::Group<fr::NW / W>& g, const int64_t* a,
                           const int64_t* c, int c_bcast, int64_t* out, int n,
                           long lane, long B) {
  const Slice<W, fr::NW / W> f = make_slice<W>(g);
  if (n == 0) {
    if (lane < B)
      for (long j = 2 * W * f.q; j < 2 * W * (f.q + 1); ++j)
        out[j * B + lane] = a[j * B + lane];
    return;
  }
  const long mine = lane < B ? lane : B - 1;
  typename Slice<W, fr::NW / W>::Fe x = f.to_mont(f.load(a + mine, B));
  const typename Slice<W, fr::NW / W>::Fe y =
      f.to_mont(f.load(c + (c_bcast ? 0 : mine), c_bcast ? 1 : B));
  for (int i = 0; i < n; ++i) x = f.mul_lazy(x, y);    // below 2P
  x = f.from_mont(x);
  if (lane < B) f.store(x, out + lane, B);
}

}  // namespace frs
