// Multi-word modular arithmetic with a per-lane modulus, for K2 (RSA
// verification). __host__ __device__ so g++ compiles it too. Two forms:
//
// namespace bn: one thread a lane, Barrett with a host-computed mu (K2's
// first design). Numbers are little-endian 32-bit words; word i of a number
// lives at x[i * s]. K2 keeps it for a lane whose modulus is even, where
// Montgomery does not apply; the lane's 9K + 4 words then live in a device
// buffer (s = 1).
//
// namespace bnw: one warp a lane, Montgomery (CIOS) with the lane's K-word
// numbers spread over the 32 threads, W = ceil(K / 32) words a thread in
// registers (RSA-2048: W = 2). One thread a lane kept RSA-2048's 580 words
// in shared memory, one multiply-add at a time through a load and a store,
// on 17 lanes a block; here a product's K outer steps each broadcast a_i and
// the quotient word m by shuffle, every thread does its W columns'
// multiply-adds at once, and the shift down a word is one more shuffle.
// Columns keep their carries (64-bit, below 2^34) until the end, where one
// carry-lookahead over two ballots resolves them (as fr_team.cuh does for
// eight threads). So a product is bound by the latency of its K steps'
// shuffles, and B = 1024 lanes are 1024 warps across the card.
#pragma once

#include "fr_bn254.cuh"  // PZK_HD
#include "warp.cuh"

namespace bn {

// out[0 .. na+nb) = a * b (out must not overlap a or b)
PZK_HD void mul(const uint32_t* a, int na, const uint32_t* b, int nb,
                uint32_t* out, int s) {
  for (int i = 0; i < na + nb; ++i) out[i * s] = 0;
  for (int i = 0; i < na; ++i) {
    const uint64_t ai = a[i * s];
    uint64_t c = 0;
    for (int j = 0; j < nb; ++j) {
      uint64_t v = out[(i + j) * s] + ai * b[j * s] + c;
      out[(i + j) * s] = (uint32_t)v;
      c = v >> 32;
    }
    out[(i + nb) * s] = (uint32_t)c;
  }
}

// out[0 .. nw) = (a * b) mod 2^(32 nw), nw <= na + nb
PZK_HD void mul_lo(const uint32_t* a, int na, const uint32_t* b, int nb,
                   uint32_t* out, int nw, int s) {
  for (int i = 0; i < nw; ++i) out[i * s] = 0;
  for (int i = 0; i < na && i < nw; ++i) {
    const uint64_t ai = a[i * s];
    uint64_t c = 0;
    for (int j = 0; j < nb && i + j < nw; ++j) {
      uint64_t v = out[(i + j) * s] + ai * b[j * s] + c;
      out[(i + j) * s] = (uint32_t)v;
      c = v >> 32;
    }
    if (i + nb < nw) out[(i + nb) * s] = (uint32_t)c;
  }
}

// r -= n over nw words, where n has nn <= nw words (upper ones zero);
// returns the borrow out
PZK_HD uint32_t sub_in_place(uint32_t* r, const uint32_t* n, int nn, int nw,
                             int s) {
  uint64_t borrow = 0;
  for (int i = 0; i < nw; ++i) {
    uint64_t v = (uint64_t)r[i * s] - (i < nn ? n[i * s] : 0u) - borrow;
    r[i * s] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  return (uint32_t)borrow;
}

// r >= n, r of nw words, n of nn <= nw words
PZK_HD bool geq(const uint32_t* r, const uint32_t* n, int nn, int nw, int s) {
  for (int i = nw - 1; i >= 0; --i) {
    uint32_t ni = i < nn ? n[i * s] : 0u;
    if (r[i * s] != ni) return r[i * s] > ni;
  }
  return true;
}

// Scratch a lane needs for mulmod with K-word numbers
PZK_HD int mulmod_scratch_words(int K) { return (2 * K) + (2 * K + 2) + (K + 1); }

// Words a lane needs for powmod: base, modulus, mu, accumulator, scratch
PZK_HD int powmod_lane_words(int K) {
  return 4 * K + 1 + mulmod_scratch_words(K);
}

// out = x * y mod n, K-word x, y, n with 2^(32(K-1)) <= n < 2^(32K);
// mu = floor(2^(64K) / n) in K+1 words. out may alias x or y.
// Barrett: the quotient estimate q3 is at most 2 short, so r < 3n before
// the two conditional subtracts.
PZK_HD void mulmod(const uint32_t* x, const uint32_t* y, const uint32_t* n,
                   const uint32_t* mu, int K, uint32_t* out, uint32_t* scratch,
                   int s) {
  uint32_t* t = scratch;                  // 2K words: x * y
  uint32_t* q2 = t + 2 * K * s;           // 2K + 2 words
  uint32_t* r = q2 + (2 * K + 2) * s;     // K + 1 words
  mul(x, K, y, K, t, s);
  mul(t + (K - 1) * s, K + 1, mu, K + 1, q2, s);     // q1 * mu
  mul_lo(q2 + (K + 1) * s, K + 1, n, K, r, K + 1, s);  // q3 * n mod b^(K+1)
  // r = (t - q3 n) mod b^(K+1)
  uint64_t borrow = 0;
  for (int i = 0; i <= K; ++i) {
    uint64_t v = (uint64_t)t[i * s] - r[i * s] - borrow;
    r[i * s] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  for (int rep = 0; rep < 2; ++rep)
    if (geq(r, n, K, K + 1, s)) sub_in_place(r, n, K, K + 1, s);
  for (int i = 0; i < K; ++i) out[i * s] = r[i * s];
}

// acc = base^e mod n, left to right: a squaring per bit below the top one
// and a multiply per set bit. e >= 1.
PZK_HD void powmod(const uint32_t* base, unsigned long long e,
                   const uint32_t* n, const uint32_t* mu, int K, uint32_t* acc,
                   uint32_t* scratch, int s) {
  for (int i = 0; i < K; ++i) acc[i * s] = base[i * s];
  int top = 63;
  while (top > 0 && !((e >> top) & 1ull)) --top;
  for (int b = top - 1; b >= 0; --b) {
    mulmod(acc, acc, n, mu, K, acc, scratch, s);
    if ((e >> b) & 1ull) mulmod(acc, base, n, mu, K, acc, scratch, s);
  }
}

// k 16-bit limbs (int64 each) at x[i * stride] -> ceil(k/2) words at w
PZK_HD void load_limbs(const int64_t* x, long stride, int k, uint32_t* w,
                       int s) {
  for (int i = 0; i < (k + 1) / 2; ++i) {
    uint32_t lo = (uint32_t)(x[(2 * i) * stride] & 0xFFFF);
    uint32_t hi = 2 * i + 1 < k
                      ? (uint32_t)(x[(2 * i + 1) * stride] & 0xFFFF) : 0u;
    w[i * s] = lo | (hi << 16);
  }
}

PZK_HD void store_limbs(const uint32_t* w, int s, int k, int64_t* x,
                        long stride) {
  for (int i = 0; i < k; ++i)
    x[i * stride] = (w[(i / 2) * s] >> (16 * (i & 1))) & 0xFFFF;
}

}  // namespace bn

// -- K2 across a warp --------------------------------------------------------
namespace bnw {

using Warp = wp::Group<32>;

// word j of a number of k 16-bit limbs (int64 each) at x[i * stride]
PZK_HD uint32_t load_word(const int64_t* x, long stride, int k, int j) {
  const uint32_t lo =
      2 * j < k ? (uint32_t)(x[(2L * j) * stride] & 0xFFFF) : 0u;
  const uint32_t hi =
      2 * j + 1 < k ? (uint32_t)(x[(2L * j + 1) * stride] & 0xFFFF) : 0u;
  return lo | (hi << 16);
}

// The words s of sum_j t_j 2^(32j) over the warp's 32W columns, thread l
// holding columns lW .. lW + W-1, each t_j < 2^62. Returns what lies above
// the 32W words, in units of 2^(32 * 32W).
template <int W>
PZK_HD uint32_t resolve(const Warp& g, const uint64_t t[W], uint32_t s[W]) {
  // each column's carry into the next; the top one to the next thread
  const uint32_t below = g.from((uint32_t)(t[W - 1] >> 32), g.i + 31);
  uint64_t u[W];                               // below 2^33
#pragma unroll
  for (int w = 0; w < W; ++w)
    u[w] = (uint32_t)t[w] +
           (w ? t[w - 1] >> 32 : (uint64_t)(g.i ? below : 0u));
  const uint32_t below2 = g.from((uint32_t)(u[W - 1] >> 32), g.i + 31);
  uint32_t c = g.i ? below2 : 0u;
  bool ones = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)(uint32_t)u[w] + c;
    s[w] = (uint32_t)v;
    ones = ones & (s[w] == 0xFFFFFFFFu);
    c = (uint32_t)(v >> 32) + (w + 1 < W ? (uint32_t)(u[w] >> 32) : 0u);
  }
  bool out;
  uint32_t cin = g.carry_in(c != 0, ones, out);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t next = cin & (s[w] == 0xFFFFFFFFu);
    s[w] += cin;
    cin = next;
  }
  return g.from((uint32_t)(t[W - 1] >> 32) + (uint32_t)(u[W - 1] >> 32), 31) +
         (out ? 1u : 0u);
}

// d = a - b over the warp's 32W words; returns the borrow out of the top
template <int W>
PZK_HD bool sub(const Warp& g, const uint32_t a[W], const uint32_t b[W],
                uint32_t d[W]) {
  uint32_t c = 0;
  bool zero = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint64_t v = (uint64_t)a[w] - b[w] - c;
    d[w] = (uint32_t)v;
    c = (uint32_t)(v >> 32) & 1;
    zero = zero & (d[w] == 0);
  }
  bool out;
  uint32_t bin = g.carry_in(c != 0, zero, out);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t next = bin & (d[w] == 0);
    d[w] -= bin;
    bin = next;
  }
  return out;
}

// A lane's odd modulus over the warp: thread l holds words lW .. lW + W-1
// (zero from word K on)
template <int W>
struct Mod {
  Warp g;
  int K;              // words of the modulus, at most 32 W
  uint32_t n[W];
  uint32_t ninv;      // -n^-1 mod 2^32
};

// a * b / 2^(32K) mod n, canonical, for a < 2^(32K) and b < n (CIOS across
// the warp); out may alias a or b. Per outer step i: a_i comes from its
// thread, every thread adds a_i * b_c to its columns, thread 0's low word
// gives m = t_0 * ninv, every thread adds m * n_c, and the columns move
// down a word (the top one from the next thread). Column c keeps its
// carries as a 64-bit value below 2^34, so no carry crosses threads in the
// loop; the value before the final subtract is below 2n.
template <int W>
PZK_HD void mont_mul(const Mod<W>& M, const uint32_t a[W],
                     const uint32_t b[W], uint32_t out[W]) {
  const Warp& g = M.g;
  uint64_t t[W];
#pragma unroll
  for (int c = 0; c < W; ++c) t[c] = 0;
  const int steps = (M.K + W - 1) / W;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (s * W + w < M.K) {                         // the same in the warp
        const uint32_t ai = g.from(a[w], s);
        const uint64_t v0 = (uint64_t)ai * b[0] + (uint32_t)t[0];
        const uint32_t m = g.from((uint32_t)v0, 0) * M.ninv;
        const uint64_t x0 = (uint64_t)(uint32_t)v0 + (uint64_t)m * M.n[0];
        const uint32_t up = g.from((uint32_t)x0, g.i + 1);
        // column c's carries, which go down to column c - 1 with the low
        // word of column c + 1
        uint64_t carry = (v0 >> 32) + (t[0] >> 32) + (x0 >> 32);
#pragma unroll
        for (int c = 1; c < W; ++c) {
          const uint64_t v = (uint64_t)ai * b[c] + (uint32_t)t[c];
          const uint64_t x = (uint64_t)(uint32_t)v + (uint64_t)m * M.n[c];
          t[c - 1] = carry + (uint32_t)x;
          carry = (v >> 32) + (t[c] >> 32) + (x >> 32);
        }
        t[W - 1] = carry + up;     // thread 31's: thread 0's low word, 0
      }
    }
  }
  uint32_t s[W], d[W];
  const uint32_t top = resolve<W>(g, t, s);
  const bool below_n = sub<W>(g, s, M.n, d);
#pragma unroll
  for (int c = 0; c < W; ++c) out[c] = below_n && top == 0 ? s[c] : d[c];
}

// R^2 mod n for R = 2^(32K), from the lane's Barrett constant mu =
// floor(R^2 / n): 0 <= R^2 - mu * n < n < R, so R^2 mod n = (-mu * n) mod
// R, the negated low half of one product. mu: its low K words.
template <int W>
PZK_HD void r2_mod_n(const Mod<W>& M, const uint32_t mu[W], uint32_t r2[W]) {
  const Warp& g = M.g;
  uint64_t lo[W], hi[W];     // hi[c] weighs as column c + 1
  uint32_t nsh[W];           // n moved up i words: word j holds n_(j-i)
#pragma unroll
  for (int c = 0; c < W; ++c) {
    lo[c] = hi[c] = 0;
    nsh[c] = M.n[c];
  }
  const int steps = (M.K + W - 1) / W;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (s * W + w < M.K) {
        const uint32_t mi = g.from(mu[w], s);
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const uint64_t p = (uint64_t)mi * nsh[c];
          lo[c] += (uint32_t)p;
          hi[c] += p >> 32;
        }
        const uint32_t in = g.from(nsh[W - 1], g.i + 31);
#pragma unroll
        for (int c = W - 1; c > 0; --c) nsh[c] = nsh[c - 1];
        nsh[0] = g.i ? in : 0u;
      }
    }
  }
  const uint32_t hb_lo = g.from((uint32_t)hi[W - 1], g.i + 31);
  const uint32_t hb_hi = g.from((uint32_t)(hi[W - 1] >> 32), g.i + 31);
  uint64_t t[W];
#pragma unroll
  for (int c = 0; c < W; ++c)
    t[c] = lo[c] + (c ? hi[c - 1]
                      : (g.i ? ((uint64_t)hb_hi << 32) | hb_lo : 0ull));
  uint32_t x[W], zero[W];
  resolve<W>(g, t, x);
#pragma unroll
  for (int c = 0; c < W; ++c) zero[c] = 0;
  sub<W>(g, zero, x, r2);                      // mod 2^(32 * 32W) ...
#pragma unroll
  for (int c = 0; c < W; ++c)                  // ... and mod R
    if ((int)g.i * W + c >= M.K) r2[c] = 0;
}

#ifdef __CUDACC__
#define PZK_HD_NOINLINE static __host__ __device__ __noinline__
#else
#define PZK_HD_NOINLINE static inline
#endif

// An even-modulus lane: the Barrett bn::powmod on one thread, over the
// lane's bn::powmod_lane_words(K) words at scratch + lane * that. Kept out
// of line, so that the warp path's registers are its own.
PZK_HD_NOINLINE void pow_even(const int64_t* sig, const int64_t* n,
                              const int64_t* mu, int64_t* out, int k,
                              long lane, long B, unsigned long long e,
                              uint32_t* scratch) {
  const int K = k / 2;
  uint32_t* S = scratch + lane * bn::powmod_lane_words(K);
  uint32_t* N = S + K;
  uint32_t* MU = N + K;
  uint32_t* ACC = MU + K + 1;
  bn::load_limbs(sig + lane, B, k, S, 1);
  bn::load_limbs(n + lane, B, k, N, 1);
  bn::load_limbs(mu + lane, B, k + 1, MU, 1);
  bn::powmod(S, e, N, MU, K, ACC, ACC + K, 1);
  bn::store_limbs(ACC, 1, k, out + lane, B);
}

// K2's lane body, one warp (g) a lane: out = sig^e mod n. sig, n, out:
// (k, B) 16-bit limbs, mu: (k + 1, B), e >= 1. An odd modulus takes
// Montgomery across the warp: x R = mont(x, R^2 mod n), left-to-right
// square and multiply, then mont(., 1) gives the canonical result. An even
// modulus takes the Barrett bn::powmod on thread 0, over the lane's
// bn::powmod_lane_words(K) words of scratch (a device buffer). e = 1 gives
// sig as it is, as bn::powmod does.
template <int W>
PZK_HD void pow_lane(const Warp& g, const int64_t* sig, const int64_t* n,
                     const int64_t* mu, int64_t* out, int k, long lane,
                     long B, unsigned long long e, uint32_t* scratch) {
  const int K = k / 2;
  Mod<W> M;
  M.g = g;
  M.K = K;
  uint32_t x[W], m[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = (int)g.i * W + w;
    x[w] = j < K ? load_word(sig + lane, B, k, j) : 0u;
    M.n[w] = j < K ? load_word(n + lane, B, k, j) : 0u;
    m[w] = j < K ? load_word(mu + lane, B, k + 1, j) : 0u;
  }
  const uint32_t n0 = g.from(M.n[0], 0);
  if (e > 1 && !(n0 & 1)) {                    // even: Barrett, one thread
    if (g.i == 0) pow_even(sig, n, mu, out, k, lane, B, e, scratch);
    return;
  }
  if (e > 1) {
    uint32_t inv = n0;                         // n0^-1 mod 2^3, then Newton
#pragma unroll
    for (int r = 0; r < 4; ++r) inv *= 2u - n0 * inv;
    M.ninv = 0u - inv;
    uint32_t r2[W], xm[W], one[W];
    r2_mod_n(M, m, r2);
    mont_mul(M, x, r2, xm);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      x[w] = xm[w];
      one[w] = g.i == 0 && w == 0 ? 1u : 0u;
    }
    int top = 63;
    while (!((e >> top) & 1ull)) --top;
#pragma unroll 1
    for (int b = top - 1; b >= 0; --b) {
      mont_mul(M, x, x, x);
      if ((e >> b) & 1ull) mont_mul(M, x, xm, x);
    }
    mont_mul(M, x, one, x);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j = (int)g.i * W + w;
    if (j < K) {
      out[(2L * j) * B + lane] = x[w] & 0xFFFF;
      out[(2L * j + 1) * B + lane] = x[w] >> 16;
    }
  }
}

}  // namespace bnw
