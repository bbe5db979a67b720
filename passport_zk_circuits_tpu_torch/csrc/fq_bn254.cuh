// BN254's base field Fq and its quadratic extension Fq2 = Fq[u]/(u^2 + 1),
// one element a thread: the coordinates of the Groth16 prover's G1 and G2
// points (K10, csrc/msm.cu; K11, csrc/fixed_base.cu).
//
// Counterpart of the field arithmetic under ops/weierstrass.CurveCtx
// (bignum.StaticMod over q) and ops/g2.G2Ctx (Fq2, Karatsuba), which the
// plain versions use. An Fq element is fr_bn254.cuh's Elem over the modulus
// q: 8 little-endian 32-bit words in Montgomery form (x * 2^256 mod q),
// always canonical, multiplied by the one CIOS column loop of
// fr_bn254.cuh. An Fq2 element is a pair (c0, c1) = c0 + c1 u.
//
// F1 (Fq) and F2 (Fq2) are the field policies of bn254_curve.cuh's point
// formulas: the same static interface (zero, one, add, sub, mul, sqr, inv,
// is_zero, the words of an element in memory, the port's 16-bit limbs in
// and out), so G1 and G2 share the formulas as ops/weierstrass and ops/g2
// do. Everything is __host__ __device__, so g++ builds it for the host
// tests (tests/torch_msm_host_check.cc).
#pragma once

#include "fr_bn254.cuh"

// q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
#define PZK_FQ_Q 0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, \
                 0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u
// 2^512 mod q
#define PZK_FQ_R2 0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u, \
                  0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u
// 2^256 mod q: one in Montgomery form
#define PZK_FQ_ONE 0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, \
                   0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u

namespace fq {

using fr::NW;

struct Modulus {
  static constexpr uint32_t pinv = 0xe4866389u;  // -q^-1 mod 2^32
  PZK_HD static void p(uint32_t (&v)[NW]) {
    const uint32_t c[NW] = {PZK_FQ_Q};
    fr::copy_words(v, c);
  }
  PZK_HD static void r2(uint32_t (&v)[NW]) {
    const uint32_t c[NW] = {PZK_FQ_R2};
    fr::copy_words(v, c);
  }
  PZK_HD static void one(uint32_t (&v)[NW]) {
    const uint32_t c[NW] = {PZK_FQ_ONE};
    fr::copy_words(v, c);
  }
};

using Fe = fr::Elem<Modulus>;

// Fq as a field policy
struct F1 {
  using Fe = fq::Fe;
  static constexpr int WORDS = NW;  // 32-bit words of an element in memory

  PZK_HD static Fe zero() { return fr::zero<Modulus>(); }
  PZK_HD static Fe one() { return fr::one_mont<Modulus>(); }
  PZK_HD static Fe add(const Fe& a, const Fe& b) { return fr::add(a, b); }
  PZK_HD static Fe sub(const Fe& a, const Fe& b) { return fr::sub(a, b); }
  PZK_HD static Fe mul(const Fe& a, const Fe& b) { return fr::mul(a, b); }
  PZK_HD static Fe sqr(const Fe& a) { return fr::mul(a, a); }
  // a^(q-2): 1/a, and 0 for a = 0
  PZK_HD static Fe inv(const Fe& a) { return fr::inv<F1, Modulus>(F1{}, a); }
  PZK_HD static bool is_zero(const Fe& a) {
    uint32_t o = 0;
    for (int i = 0; i < NW; ++i) o |= a.w[i];
    return o == 0;
  }
  // the words of an element at w[0..WORDS)
  PZK_HD static Fe get(const uint32_t* w) { return fr::load_words<Modulus>(w); }
  PZK_HD static void put(const Fe& a, uint32_t* w) {
    for (int i = 0; i < NW; ++i) w[i] = a.w[i];
  }
  // column j of a (16, n) limb tensor, x = its base + j: normal form in,
  // Montgomery form out (and back for store)
  PZK_HD static Fe load(const int64_t* x, long n) {
    return fr::to_mont(fr::load_limbs<Modulus>(x, n));
  }
  PZK_HD static void store(const Fe& a, int64_t* x, long n) {
    fr::store_limbs(fr::from_mont(a), x, n);
  }
};

struct Fe2 {
  Fe c0, c1;
};

// Fq2 = Fq[u]/(u^2 + 1) as a field policy (groth16/pairing.FQ2)
struct F2 {
  using Fe = Fe2;
  static constexpr int WORDS = 2 * NW;

  PZK_HD static Fe zero() { return {F1::zero(), F1::zero()}; }
  PZK_HD static Fe one() { return {F1::one(), F1::zero()}; }
  PZK_HD static Fe add(const Fe& a, const Fe& b) {
    return {F1::add(a.c0, b.c0), F1::add(a.c1, b.c1)};
  }
  PZK_HD static Fe sub(const Fe& a, const Fe& b) {
    return {F1::sub(a.c0, b.c0), F1::sub(a.c1, b.c1)};
  }
  // Karatsuba: a0 b0, a1 b1, (a0 + a1)(b0 + b1); re = m0 - m1 (u^2 = -1),
  // im = t - m0 - m1
  PZK_HD static Fe mul(const Fe& a, const Fe& b) {
    const fq::Fe m0 = F1::mul(a.c0, b.c0), m1 = F1::mul(a.c1, b.c1);
    const fq::Fe t = F1::mul(F1::add(a.c0, a.c1), F1::add(b.c0, b.c1));
    return {F1::sub(m0, m1), F1::sub(F1::sub(t, m0), m1)};
  }
  // (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u
  PZK_HD static Fe sqr(const Fe& a) {
    const fq::Fe m = F1::mul(a.c0, a.c1);
    return {F1::mul(F1::add(a.c0, a.c1), F1::sub(a.c0, a.c1)), F1::add(m, m)};
  }
  // 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2); 0 for a = 0
  PZK_HD static Fe inv(const Fe& a) {
    const fq::Fe n = F1::inv(F1::add(F1::sqr(a.c0), F1::sqr(a.c1)));
    return {F1::mul(a.c0, n), F1::mul(F1::sub(F1::zero(), a.c1), n)};
  }
  PZK_HD static bool is_zero(const Fe& a) {
    return F1::is_zero(a.c0) && F1::is_zero(a.c1);
  }
  PZK_HD static Fe get(const uint32_t* w) {
    return {F1::get(w), F1::get(w + NW)};
  }
  PZK_HD static void put(const Fe& a, uint32_t* w) {
    F1::put(a.c0, w);
    F1::put(a.c1, w + NW);
  }
  // column j of a (16, 2, n) limb tensor (limb, component, point), x = its
  // base + j
  PZK_HD static Fe load(const int64_t* x, long n) {
    return {F1::load(x, 2 * n), F1::load(x + n, 2 * n)};
  }
  PZK_HD static void store(const Fe& a, int64_t* x, long n) {
    F1::store(a.c0, x, 2 * n);
    F1::store(a.c1, x + n, 2 * n);
  }
};

}  // namespace fq
