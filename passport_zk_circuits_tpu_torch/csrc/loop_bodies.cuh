// The field-op bodies that K8 (loop_bench.cu) loops n times in one kernel,
// per lane, on (16, B) 16-bit limbs. __host__ __device__ and free of CUDA
// intrinsics, so g++ compiles the same arithmetic for the host tests.
//
// Counterparts of the loop bodies of tools/microbench_kernel.py, the JAX
// package's microbenchmark. Its MXU formulations (modmul_mxu,
// modmul_rows_mxu_barrett, barrett_mxu_only, with outputs in [0, 2P)) exist
// for the TPU's matrix unit and do not carry over; the card's two modmul
// formulations stand in for them, both canonical (< P): the TPU's own
// 16-bit schoolbook plus static Barrett (ModmulBarrett16, as
// ops/pallas_field.py's modmul) and 32-bit CIOS Montgomery
// (ModmulMont32, fr_bn254.cuh, what the port's kernels use).
//
// A body is a struct with a state type S, enter (limbs -> S, applied to x
// and to c once), step (S, S) -> S and leave (S -> limbs). The elementwise
// bodies (PerLimb) also give the step of one limb, limb (T, T) -> T: their
// 16 limbs are 16 independent chains, and K8 runs each on a thread of its
// own (limb_thread).
#pragma once

#include <type_traits>

#include "fr_bn254.cuh"

namespace loopb {

constexpr int NL = 16;
constexpr uint32_t MASK = 0xFFFFu;
constexpr int LIMB_BLOCK = 128;   // K8's threads a block for PerLimb bodies

#define PZK_P16 0x0001u, 0xf000u, 0xf593u, 0x43e1u, 0x7091u, 0x79b9u, \
                0xe848u, 0x2833u, 0x585du, 0x8181u, 0x45b6u, 0xb850u, \
                0xa029u, 0xe131u, 0x4e72u, 0x3064u
// floor(2^512 / P), 17 limbs: the static Barrett constant
#define PZK_MU16 0x9259u, 0xe1deu, 0x3a6bu, 0x2070u, 0x0ae6u, 0x9e88u, \
                 0x5200u, 0x1448u, 0x0147u, 0x8073u, 0xa586u, 0xb074u, \
                 0x4a7au, 0x23a0u, 0x4626u, 0x4a47u, 0x0005u

struct L16 {
  uint32_t v[NL];
};

PZK_HD L16 load16(const int64_t* x, long stride) {
  L16 r;
  for (int i = 0; i < NL; ++i) r.v[i] = (uint32_t)x[i * stride];
  return r;
}

PZK_HD void store16(const L16& a, int64_t* x, long stride) {
  for (int i = 0; i < NL; ++i) x[i * stride] = a.v[i];
}

// Low NO limbs of a * b (NA and NB normalized 16-bit limbs), normalized.
// Column sums of 16-bit halves stay below 2^22 in 32-bit accumulators.
template <int NA, int NB, int NO>
PZK_HD void mul16(const uint32_t* a, const uint32_t* b, uint32_t* out) {
  uint32_t acc[NO];
#pragma unroll
  for (int k = 0; k < NO; ++k) acc[k] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (i + j >= NO) continue;
      const uint32_t p = a[i] * b[j];
      acc[i + j] += p & MASK;
      if (i + j + 1 < NO) acc[i + j + 1] += p >> 16;
    }
  }
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < NO; ++k) {
    const uint32_t t = acc[k] + carry;
    out[k] = t & MASK;
    carry = t >> 16;
  }
}

// a - b over N limbs; returns the borrow out
template <int N>
PZK_HD uint32_t sub16(const uint32_t* a, const uint32_t* b, uint32_t* d) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t t = a[i] + 0x10000u - b[i] - borrow;
    d[i] = t & MASK;
    borrow = 1u - (t >> 16);
  }
  return borrow;
}

// x mod P for x < 2^512 (32 normalized limbs): static Barrett with b = 2^16,
// k = 16, as ops/pallas_field.py's barrett_static. The quotient estimate is
// off by at most 2; two conditional subtracts leave r < P.
PZK_HD L16 barrett16(const uint32_t x[2 * NL]) {
  const uint32_t mu[NL + 1] = {PZK_MU16};
  const uint32_t p[NL + 1] = {PZK_P16, 0u};
  uint32_t q2[2 * NL + 2], r2[NL + 1], r[NL + 1], d[NL + 1];
  mul16<NL + 1, NL + 1, 2 * NL + 2>(x + NL - 1, mu, q2);
  mul16<NL + 1, NL, NL + 1>(q2 + NL + 1, p, r2);
  sub16<NL + 1>(x, r2, r);
  for (int rep = 0; rep < 2; ++rep) {
    const uint32_t borrow = sub16<NL + 1>(r, p, d);
#pragma unroll
    for (int i = 0; i <= NL; ++i) r[i] = borrow ? r[i] : d[i];
  }
  L16 out;
#pragma unroll
  for (int i = 0; i < NL; ++i) out.v[i] = r[i];
  return out;
}

template <class S>
struct Identity {
  PZK_HD static S enter(const L16& x) { return x; }
  PZK_HD static L16 leave(const S& x) { return x; }
};

// A body whose step works on each limb alone, Body::limb(x, c) on limbs
// held as T
template <class Body, class T>
struct PerLimb {
  using Limb = T;
  struct S {
    T v[NL];
  };
  PZK_HD static S enter(const L16& x) {
    S r;
    for (int i = 0; i < NL; ++i) r.v[i] = (T)x.v[i];
    return r;
  }
  PZK_HD static L16 leave(const S& x) {
    L16 r;
    for (int i = 0; i < NL; ++i) r.v[i] = (uint32_t)x.v[i];
    return r;
  }
  PZK_HD static S step(const S& x, const S& c) {
    S r;
#pragma unroll
    for (int i = 0; i < NL; ++i) r.v[i] = Body::limb(x.v[i], c.v[i]);
    return r;
  }
};

// whether Body is a PerLimb body
template <class Body, class = void>
constexpr bool per_limb = false;
template <class Body>
constexpr bool per_limb<Body, std::void_t<typename Body::Limb>> = true;

// whether K8 runs Body's chain as K7's team lane body (a team_chain tag)
template <class Body, class = void>
constexpr bool team_chain = false;
template <class Body>
constexpr bool team_chain<Body, std::void_t<decltype(Body::team_chain)>> =
    Body::team_chain;

// (x * c + 1) & 0xFFFF per limb, u32
struct U32MulAdd : PerLimb<U32MulAdd, uint32_t> {
  PZK_HD static uint32_t limb(uint32_t x, uint32_t c) {
    return (x * c + 1u) & MASK;
  }
};

// The same in int32 lanes. The product can pass 2^31, and signed overflow
// is undefined in C++, so it is taken in unsigned arithmetic: the low 16
// bits are those of the wrapped int32 product.
struct I32MulAdd : PerLimb<I32MulAdd, int32_t> {
  PZK_HD static int32_t limb(int32_t x, int32_t c) {
    return (int32_t)(((uint32_t)x * (uint32_t)c + 1u) & MASK);
  }
};

// ((x & 0xFFFF) + (c >> 1)) & 0xFFFF per limb
struct MaskShiftAdd : PerLimb<MaskShiftAdd, uint32_t> {
  PZK_HD static uint32_t limb(uint32_t x, uint32_t c) {
    return ((x & MASK) + (c >> 1)) & MASK;
  }
};

// (x * c) mod 2^256: the low 16 limbs of the 16-bit schoolbook product
struct School : Identity<L16> {
  using S = L16;
  PZK_HD static S step(const S& x, const S& c) {
    S r;
    mul16<NL, NL, NL>(x.v, c.v, r.v);
    return r;
  }
};

// (x * c) mod P, the TPU's formulation: 16-bit schoolbook, static Barrett
struct ModmulBarrett16 : Identity<L16> {
  using S = L16;
  PZK_HD static S step(const S& x, const S& c) {
    uint32_t t[2 * NL];
    mul16<NL, NL, 2 * NL>(x.v, c.v, t);
    return barrett16(t);
  }
};

// (x * c) mod P, the card's formulation: CIOS Montgomery on 32-bit words,
// into Montgomery form once at entry and out once at exit. Host-only: its
// team_chain tag sends K8's card launch to K7's team lane body
// (frs::mul_chain_lane), which computes the same chain; the host tests
// hold that body and this one to the same results.
struct ModmulMont32 {
  static constexpr bool team_chain = true;
  using S = fr::Fe;
  PZK_HD static S enter(const L16& x) {
    fr::Fe w;
    for (int i = 0; i < fr::NW; ++i)
      w.w[i] = x.v[2 * i] | (x.v[2 * i + 1] << 16);
    return fr::to_mont(w);
  }
  PZK_HD static L16 leave(const S& x) {
    const fr::Fe w = fr::from_mont(x);
    L16 r;
    for (int i = 0; i < fr::NW; ++i) {
      r.v[2 * i] = w.w[i] & MASK;
      r.v[2 * i + 1] = w.w[i] >> 16;
    }
    return r;
  }
  PZK_HD static S step(const S& x, const S& c) { return fr::mul(x, c); }
};

// (x + x * 2^256) mod P: the Barrett reduction alone (c is unused)
struct BarrettOnly : Identity<L16> {
  using S = L16;
  PZK_HD static S step(const S& x, const S&) {
    uint32_t t[2 * NL];
    for (int i = 0; i < NL; ++i) t[i] = t[NL + i] = x.v[i];
    return barrett16(t);
  }
};

// Body ids, in the order of ops/cuda_loop.BODIES
#define PZK_LOOP_BODIES(X)                                                  \
  X(0, U32MulAdd) X(1, I32MulAdd) X(2, MaskShiftAdd) X(3, School)           \
  X(4, ModmulBarrett16) X(5, ModmulMont32) X(6, BarrettOnly)

// n_iter steps x <- step(x, c) from x = a, on one lane
template <class Body>
PZK_HD L16 run(const L16& a, const L16& c, int n_iter) {
  typename Body::S x = Body::enter(a);
  const typename Body::S k = Body::enter(c);
  for (int i = 0; i < n_iter; ++i) x = Body::step(x, k);
  return Body::leave(x);
}

// An empty asm that may change x: the compiler cannot see through a chain
// of steps and replace it by its closed form (x + n * k for
// mask_shift_add), which would time nothing. It emits no instruction.
PZK_HD void opaque(uint32_t& x) { asm volatile("" : "+r"(x)); }
PZK_HD void opaque(int32_t& x) { asm volatile("" : "+r"(x)); }
PZK_HD void opaque(L16& s) {
#pragma unroll
  for (int i = 0; i < NL; ++i) opaque(s.v[i]);
}

// K8's thread of a PerLimb body: thread idx of a launch of at least NL * B
// threads carries element idx of the (16, B) layout, limb idx / B of lane
// idx % B, through its n_iter steps; a thread past the last element stores
// nothing. Neighbouring threads take neighbouring lanes of one limb, so a
// warp's loads and stores are 256 contiguous bytes.
template <class Body>
PZK_HD void limb_thread(const int64_t* a, const int64_t* c, int64_t* out,
                        int n_iter, long idx, long B) {
  using T = typename Body::Limb;
  if (idx >= NL * B) return;
  T x = (T)(uint32_t)a[idx];
  const T k = (T)(uint32_t)c[idx];
  for (int i = 0; i < n_iter; ++i) {
    x = Body::limb(x, k);
    opaque(x);
  }
  out[idx] = (uint32_t)x;
}

}  // namespace loopb
