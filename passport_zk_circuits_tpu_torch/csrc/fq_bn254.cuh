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
#include "warp.cuh"

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
  static constexpr int TEAM = 1;    // threads an element

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
  // the words of an element at w[0..WORDS), w 16-byte aligned: on the
  // device two 16-byte loads or stores (the points' and buckets' words are
  // read and written whole, never word by word)
  PZK_HD static Fe get(const uint32_t* w) {
#if defined(__CUDA_ARCH__)
    const uint4 a = reinterpret_cast<const uint4*>(w)[0];
    const uint4 b = reinterpret_cast<const uint4*>(w)[1];
    Fe r;
    r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
    r.w[4] = b.x, r.w[5] = b.y, r.w[6] = b.z, r.w[7] = b.w;
    return r;
#else
    return fr::load_words<Modulus>(w);
#endif
  }
  PZK_HD static void put(const Fe& a, uint32_t* w) {
#if defined(__CUDA_ARCH__)
    uint4* v = reinterpret_cast<uint4*>(w);
    v[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
    v[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
#else
    for (int i = 0; i < NW; ++i) w[i] = a.w[i];
#endif
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

#if defined(__CUDA_ARCH__)
// fr_bn254.cuh's product as one function that every product of a kernel
// calls (internal linkage: a copy per source), not a copy of its unrolled
// loop at every call site: an inlined point add is some 16 of those, about
// 100 KB of code, and K10's kernels ran out of the instruction cache
static __device__ __noinline__ Fe mul_call(const Fe a, const Fe b) {
  return fr::mul(a, b);
}
#endif

// Fq as K10's field policy: F1 with its product a call on the device (the
// host build runs the same loop inline)
struct F1Call : F1 {
  PZK_HD static Fe mul(const Fe& a, const Fe& b) {
#if defined(__CUDA_ARCH__)
    return mul_call(a, b);
#else
    return fr::mul(a, b);
#endif
  }
  PZK_HD static Fe sqr(const Fe& a) { return mul(a, a); }
  PZK_HD static Fe inv(const Fe& a) {
    return fr::inv<F1Call, Modulus>(F1Call{}, a);
  }
};

struct Fe2 {
  Fe c0, c1;
};

// Fq2 = Fq[u]/(u^2 + 1) as a field policy (groth16/pairing.FQ2)
struct F2 {
  using Fe = Fe2;
  static constexpr int WORDS = 2 * NW;
  static constexpr int TEAM = 1;

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

// Fq2 over a pair of neighbouring threads on F1Call, thread i holding
// component c_i of every element (wp::Group<2>, this_group): a G2 point is
// then 24 words a thread, as a G1 point is, where one thread holding all 48
// words of a Jacobian G2 point and a full add's temporaries spills. The
// same static interface as F2 and the same words in memory (a thread reads
// and writes its own half), so bn254_curve.cuh's formulas run on it
// unchanged; every answer they branch on (is_zero) is the pair's, so both
// threads take every branch together, and the exchange names the pair
// alone (from_group). A product is schoolbook over the pair: thread 0
// a0 b0 - a1 b1, thread 1 a1 b0 + a0 b1, two products of Fq a thread.
struct F2Pair {
  using Fe = fq::Fe;
  static constexpr int WORDS = 2 * NW;
  static constexpr int TEAM = 2;    // threads an element

  PZK_HD static wp::Group<2> g() { return wp::this_group<2>(); }
  // the other thread's component of a
  PZK_HD static Fe other(const Fe& a) {
    const wp::Group<2> p = g();
    Fe r;
#pragma unroll
    for (int k = 0; k < NW; ++k) r.w[k] = p.from_group(a.w[k], p.i ^ 1u);
    return r;
  }
  PZK_HD static Fe pick(bool c, const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int k = 0; k < NW; ++k) r.w[k] = c ? a.w[k] : b.w[k];
    return r;
  }

  PZK_HD static Fe zero() { return F1Call::zero(); }
  PZK_HD static Fe one() {
    return pick(g().i == 0, F1Call::one(), F1Call::zero());
  }
  PZK_HD static Fe add(const Fe& a, const Fe& b) { return F1Call::add(a, b); }
  PZK_HD static Fe sub(const Fe& a, const Fe& b) { return F1Call::sub(a, b); }
  PZK_HD static Fe mul(const Fe& a, const Fe& b) {
    const bool one = g().i == 1;
    const Fe ao = other(a), bo = other(b);
    const Fe m1 = F1Call::mul(pick(one, ao, a), b);        // a0 b0 | a0 b1
    const Fe m2 = F1Call::mul(pick(one, a, ao), bo);       // a1 b1 | a1 b0
    return F1Call::add(m1, pick(one, m2, F1Call::sub(F1Call::zero(), m2)));
  }
  // (a0 + a1 u)^2: thread 0 (a0 + a1)(a0 - a1), thread 1 2 a1 a0
  PZK_HD static Fe sqr(const Fe& a) {
    const bool one = g().i == 1;
    const Fe ao = other(a);
    return F1Call::mul(pick(one, F1Call::add(a, a), F1Call::add(a, ao)),
                   pick(one, ao, F1Call::sub(a, ao)));
  }
  // 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2), the pair's one inversion
  // of Fq computed by both; 0 for a = 0
  PZK_HD static Fe inv(const Fe& a) {
    const Fe s = F1Call::sqr(a);
    const Fe n = F1Call::inv(F1Call::add(s, other(s)));
    return F1Call::mul(pick(g().i == 1, F1Call::sub(F1Call::zero(), a), a), n);
  }
  PZK_HD static bool is_zero(const Fe& a) {
    const wp::Group<2> p = g();
    const bool z = F1Call::is_zero(a);
    const bool zo = p.from_group(z, p.i ^ 1u);  // both threads exchange
    return z && zo;
  }
  PZK_HD static Fe get(const uint32_t* w) {
    return F1Call::get(w + g().i * NW);
  }
  PZK_HD static void put(const Fe& a, uint32_t* w) {
    F1Call::put(a, w + g().i * NW);
  }
  PZK_HD static Fe load(const int64_t* x, long n) {
    return F1Call::load(x + g().i * n, 2 * n);
  }
  PZK_HD static void store(const Fe& a, int64_t* x, long n) {
    F1Call::store(a, x + g().i * n, 2 * n);
  }
};

}  // namespace fq
