// Multi-word modular multiplication with a per-lane modulus (Barrett with a
// host-computed mu), per lane. __host__ __device__ so g++ compiles it too.
//
// Numbers are little-endian 32-bit words; word i of a number lives at
// x[i * s]. The stride lets a kernel interleave the lanes of a block in
// shared memory (lane l's word i at i * lanes + l: neighbouring threads hit
// neighbouring banks); host code passes s = 1.
#pragma once

#include "fr_bn254.cuh"  // PZK_HD

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
