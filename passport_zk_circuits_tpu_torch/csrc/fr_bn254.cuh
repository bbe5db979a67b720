// BN254 scalar field Fr: add, sub, Montgomery mul and sqr, per lane.
//
// Counterpart of the field building blocks of
// passport_zk_circuits_tpu/ops/pallas_field.py (school_mul, barrett_static,
// modmul, addmod, submod). The TPU kernels keep 16-bit limbs in [0, 2P) and
// run the limb products as byte matmuls on the MXU; none of that carries
// over. Here an element is 8 little-endian 32-bit words in Montgomery form
// (x * 2^256 mod P), always canonical (< P); the product is CIOS Montgomery
// multiplication with 64-bit partial products. Conversion happens only at a
// kernel's boundary (to_mont / from_mont), where values are canonical
// 16-bit limbs as in the rest of the port.
//
// The column loop is written once, over a modulus M (its words, -M^-1 mod
// 2^32, 2^512 mod M, 2^256 mod M): FrModulus here, BN254's base field q in
// fq_bn254.cuh (the Groth16 prover's group arithmetic, K10 and K11). An
// element of the field mod M is an Elem<M>; fr::Fe is Elem<FrModulus>.
//
// Everything is __host__ __device__ and free of CUDA intrinsics, so g++
// compiles the same arithmetic for the host tests.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PZK_HD __host__ __device__ __forceinline__
#else
#define PZK_HD inline
#endif

namespace fr {

constexpr int NW = 8;  // 32-bit words per element

#define PZK_FR_P 0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, \
                 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u
// 2^512 mod P: to_mont multiplies by it
#define PZK_FR_R2 0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, \
                  0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u
// 2^256 mod P: one in Montgomery form
#define PZK_FR_ONE 0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u, \
                   0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u
constexpr uint32_t PINV = 0xefffffffu;  // -P^-1 mod 2^32

PZK_HD void copy_words(uint32_t (&v)[NW], const uint32_t (&c)[NW]) {
  for (int i = 0; i < NW; ++i) v[i] = c[i];
}

// A modulus of the column loop: its words (p), -p^-1 mod 2^32 (pinv),
// 2^512 mod p (r2) and 2^256 mod p (one). Words come as local arrays of
// literals, which device code takes as constants once unrolled.
struct FrModulus {
  static constexpr uint32_t pinv = PINV;
  PZK_HD static void p(uint32_t (&v)[NW]) {
    const uint32_t c[NW] = {PZK_FR_P};
    copy_words(v, c);
  }
  PZK_HD static void r2(uint32_t (&v)[NW]) {
    const uint32_t c[NW] = {PZK_FR_R2};
    copy_words(v, c);
  }
  PZK_HD static void one(uint32_t (&v)[NW]) {
    const uint32_t c[NW] = {PZK_FR_ONE};
    copy_words(v, c);
  }
};

template <class M>
struct Elem {
  uint32_t w[NW];
};
using Fe = Elem<FrModulus>;

template <class M = FrModulus>
PZK_HD Elem<M> zero() {
  Elem<M> r;
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

template <class M = FrModulus>
PZK_HD Elem<M> one_mont() {
  Elem<M> r;
  M::one(r.w);
  return r;
}

// r = x - P if x >= P (x given as 8 words plus a ninth, top word)
template <class M>
PZK_HD Elem<M> reduce_once(const uint32_t x[NW], uint32_t top) {
  uint32_t p[NW];
  M::p(p);
  Elem<M> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)x[i] - p[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  if (top == 0 && borrow) {
#pragma unroll
    for (int i = 0; i < NW; ++i) d.w[i] = x[i];
  }
  return d;
}

// a + b mod P, a, b < P
template <class M>
PZK_HD Elem<M> add(const Elem<M>& a, const Elem<M>& b) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] + b.w[i] + c;
    s[i] = (uint32_t)v;
    c = v >> 32;
  }
  return reduce_once<M>(s, (uint32_t)c);
}

// a - b mod P, a, b < P
template <class M>
PZK_HD Elem<M> sub(const Elem<M>& a, const Elem<M>& b) {
  uint32_t p[NW];
  M::p(p);
  Elem<M> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] - b.w[i] - borrow;
    d.w[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      uint64_t v = (uint64_t)d.w[i] + p[i] + c;
      d.w[i] = (uint32_t)v;
      c = v >> 32;
    }
  }
  return d;
}

// Montgomery product a * b / 2^256 mod P (CIOS). a < 2^256, b < P gives
// t < 2P before the final subtract, so the result is canonical.
template <class M>
PZK_HD Elem<M> mul(const Elem<M>& a, const Elem<M>& b) {
  uint32_t p[NW];
  M::p(p);
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t v = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + c;
      t[j] = (uint32_t)v;
      c = v >> 32;
    }
    uint64_t v = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)v;
    t[NW + 1] = (uint32_t)(v >> 32);
    uint32_t m = t[0] * M::pinv;
    v = (uint64_t)t[0] + (uint64_t)m * p[0];
    c = v >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      v = (uint64_t)t[j] + (uint64_t)m * p[j] + c;
      t[j - 1] = (uint32_t)v;
      c = v >> 32;
    }
    v = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)v;
    t[NW] = t[NW + 1] + (uint32_t)(v >> 32);
  }
  return reduce_once<M>(t, t[NW]);
}

template <class M>
PZK_HD Elem<M> sqr(const Elem<M>& a) { return mul(a, a); }

template <class M>
PZK_HD Elem<M> to_mont(const Elem<M>& a) {
  Elem<M> b;
  M::r2(b.w);
  return mul(a, b);
}

template <class M>
PZK_HD Elem<M> from_mont(const Elem<M>& a) {
  Elem<M> one = zero<M>();
  one.w[0] = 1;
  return mul(a, one);
}

template <class M>
PZK_HD Elem<M> select(bool c, const Elem<M>& a, const Elem<M>& b) {
  return c ? a : b;
}

// 16 little-endian 16-bit limbs (int64 each) at x[i * stride] -> words
template <class M = FrModulus>
PZK_HD Elem<M> load_limbs(const int64_t* x, long stride) {
  Elem<M> r;
  for (int i = 0; i < NW; ++i)
    r.w[i] = (uint32_t)(x[(2 * i) * stride] & 0xFFFF) |
             ((uint32_t)(x[(2 * i + 1) * stride] & 0xFFFF) << 16);
  return r;
}

template <class M>
PZK_HD void store_limbs(const Elem<M>& a, int64_t* x, long stride) {
  for (int i = 0; i < NW; ++i) {
    x[(2 * i) * stride] = a.w[i] & 0xFFFF;
    x[(2 * i + 1) * stride] = a.w[i] >> 16;
  }
}

// Montgomery-form constant stored as 8 words at c
template <class M = FrModulus>
PZK_HD Elem<M> load_words(const uint32_t* c) {
  Elem<M> r;
  for (int i = 0; i < NW; ++i) r.w[i] = c[i];
  return r;
}

// The per-thread arithmetic as a policy: poseidon.cuh and babyjubjub.cuh
// write their algorithms once over a policy A (an element is an A::Fe), and
// run them with one thread a lane (Lane, here) or a team of threads a lane
// (frt::Team, fr_team.cuh).
struct Lane {
  using Fe = fr::Fe;
  PZK_HD Fe zero() const { return fr::zero(); }
  PZK_HD Fe one() const { return one_mont(); }
  PZK_HD Fe small(uint32_t v) const {
    Fe x = fr::zero();
    x.w[0] = v;
    return x;
  }
  PZK_HD Fe add(const Fe& a, const Fe& b) const { return fr::add(a, b); }
  PZK_HD Fe sub(const Fe& a, const Fe& b) const { return fr::sub(a, b); }
  PZK_HD Fe mul(const Fe& a, const Fe& b) const { return fr::mul(a, b); }
  PZK_HD Fe sqr(const Fe& a) const { return fr::mul(a, a); }
  PZK_HD Fe to_mont(const Fe& a) const { return fr::to_mont(a); }
  PZK_HD Fe from_mont(const Fe& a) const { return fr::from_mont(a); }
  // entry idx of a table of 8-word Montgomery constants
  PZK_HD Fe at(const uint32_t* base, int idx) const {
    return load_words(base + NW * idx);
  }
  PZK_HD Fe load(const int64_t* x, long stride) const {
    return load_limbs(x, stride);
  }
  PZK_HD void store(const Fe& a, int64_t* x, long stride) const {
    store_limbs(a, x, stride);
  }
  // whether any lane that runs in step with this one has p set: one lane
  PZK_HD bool any(bool p) const { return p; }
};

// a^(P-2) in Montgomery form, square-and-multiply from the top bit of the
// exponent: a^-1 for a != 0, and 0 for a = 0 (ops/field.inv's convention).
// 256 squarings and 127 products (popcount of P - 2) for Fr; M is the
// modulus whose P - 2 is the exponent (its lowest word at least 2).
template <class A, class M = FrModulus>
PZK_HD typename A::Fe inv(const A& f, const typename A::Fe& a) {
  uint32_t p[NW];
  M::p(p);
  typename A::Fe r = f.one();
#pragma unroll
  for (int w = NW - 1; w >= 0; --w) {
    const uint32_t e = w == 0 ? p[0] - 2 : p[w];     // P - 2: no borrow
#pragma unroll 1
    for (int b = 31; b >= 0; --b) {
      r = f.sqr(r);
      if ((e >> b) & 1) r = f.mul(r, a);
    }
  }
  return r;
}

}  // namespace fr
