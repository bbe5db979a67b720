// BN254 G1 (y^2 = x^3 + 3 over Fq) and G2 (the twist over Fq2) point
// formulas, one point a thread, written once over a field policy F
// (fq_bn254.cuh: fq::F1 for G1, fq::F2 for G2).
//
// Counterpart of ops/weierstrass.py's jac_double (:111), jac_add (:129),
// jac_add_affine (:156) and to_affine (:162), which run over
// weierstrass.CurveCtx and g2.G2Ctx. Those compute the add and the double
// on every lane and select; here a thread branches on its own case:
//   * infinity on either side gives the other operand;
//   * P == Q goes to the doubling;
//   * P == -Q gives infinity;
//   * to_affine of infinity gives (0, 0), as the plain version's.
// A Jacobian point (X, Y, Z) is (X / Z^2, Y / Z^3), infinity any point with
// Z = 0. The representatives differ from the plain formulas' (a = 0 here,
// other formulas), but an affine point is unique, so every affine output
// equals the plain version's.
#pragma once

#include "fq_bn254.cuh"

namespace ec {

template <class F>
struct Jac {
  typename F::Fe X, Y, Z;
};

template <class F>
struct Aff {
  typename F::Fe x, y;
};

// words of a point in memory: affine x, y; Jacobian X, Y, Z
template <class F>
constexpr int AFF_WORDS = 2 * F::WORDS;
template <class F>
constexpr int JAC_WORDS = 3 * F::WORDS;

template <class F>
PZK_HD Jac<F> infinity() {
  return {F::one(), F::one(), F::zero()};
}

template <class F>
PZK_HD bool is_inf(const Jac<F>& P) {
  return F::is_zero(P.Z);
}

template <class F>
PZK_HD Aff<F> get_aff(const uint32_t* w) {
  return {F::get(w), F::get(w + F::WORDS)};
}

template <class F>
PZK_HD Jac<F> get_jac(const uint32_t* w) {
  return {F::get(w), F::get(w + F::WORDS), F::get(w + 2 * F::WORDS)};
}

template <class F>
PZK_HD void put_jac(const Jac<F>& P, uint32_t* w) {
  F::put(P.X, w);
  F::put(P.Y, w + F::WORDS);
  F::put(P.Z, w + 2 * F::WORDS);
}

template <class F>
PZK_HD void put_aff(const Aff<F>& a, uint32_t* w) {
  F::put(a.x, w);
  F::put(a.y, w + F::WORDS);
}

// 2P for a = 0 (dbl-2009-l): 2 products, 5 squarings. Infinity (Z = 0)
// stays infinity.
template <class F>
PZK_HD Jac<F> dbl(const Jac<F>& P) {
  using E = typename F::Fe;
  const E A = F::sqr(P.X), B = F::sqr(P.Y), C = F::sqr(B);
  E D = F::sub(F::sub(F::sqr(F::add(P.X, B)), A), C);
  D = F::add(D, D);                                  // 4 X Y^2
  const E M = F::add(F::add(A, A), A);               // 3 X^2
  const E X3 = F::sub(F::sqr(M), F::add(D, D));
  E C8 = F::add(C, C);
  C8 = F::add(C8, C8);
  C8 = F::add(C8, C8);                               // 8 Y^4
  const E Y3 = F::sub(F::mul(M, F::sub(D, X3)), C8);
  const E YZ = F::mul(P.Y, P.Z);
  return {X3, Y3, F::add(YZ, YZ)};
}

// The end of both additions: U1 = X1 Z2^2, S1 = Y1 Z2^3 and the other
// operand's U2, S2, with Z3 = zz * H
template <class F>
PZK_HD Jac<F> add_tail(const Jac<F>& P, const typename F::Fe& U1,
                       const typename F::Fe& S1, const typename F::Fe& U2,
                       const typename F::Fe& S2, const typename F::Fe& zz) {
  using E = typename F::Fe;
  const E H = F::sub(U2, U1), R = F::sub(S2, S1);
  if (F::is_zero(H)) return F::is_zero(R) ? dbl(P) : infinity<F>();
  const E HH = F::sqr(H);
  const E HHH = F::mul(H, HH);
  const E V = F::mul(U1, HH);
  const E X3 = F::sub(F::sub(F::sqr(R), HHH), F::add(V, V));
  const E Y3 = F::sub(F::mul(R, F::sub(V, X3)), F::mul(S1, HHH));
  return {X3, Y3, F::mul(zz, H)};
}

// P + Q for an affine Q that is not infinity (Z2 = 1): 8 products, 3
// squarings
template <class F>
PZK_HD Jac<F> add_mixed(const Jac<F>& P, const Aff<F>& Q) {
  using E = typename F::Fe;
  if (is_inf(P)) return {Q.x, Q.y, F::one()};
  const E Z1Z1 = F::sqr(P.Z);
  const E U2 = F::mul(Q.x, Z1Z1);
  const E S2 = F::mul(Q.y, F::mul(P.Z, Z1Z1));
  return add_tail(P, P.X, P.Y, U2, S2, P.Z);
}

// P + Q, both Jacobian: 12 products, 4 squarings
template <class F>
PZK_HD Jac<F> add(const Jac<F>& P, const Jac<F>& Q) {
  using E = typename F::Fe;
  if (is_inf(P)) return Q;
  if (is_inf(Q)) return P;
  const E Z1Z1 = F::sqr(P.Z), Z2Z2 = F::sqr(Q.Z);
  const E U1 = F::mul(P.X, Z2Z2), U2 = F::mul(Q.X, Z1Z1);
  const E S1 = F::mul(P.Y, F::mul(Q.Z, Z2Z2));
  const E S2 = F::mul(Q.Y, F::mul(P.Z, Z1Z1));
  return add_tail(P, U1, S1, U2, S2, F::mul(P.Z, Q.Z));
}

// (X / Z^2, Y / Z^3) with one Fermat inversion; infinity gives (0, 0)
template <class F>
PZK_HD Aff<F> to_affine(const Jac<F>& P) {
  using E = typename F::Fe;
  const E zi = F::inv(P.Z);                          // 0 for infinity
  const E zi2 = F::sqr(zi);
  return {F::mul(P.X, zi2), F::mul(P.Y, F::mul(zi2, zi))};
}

}  // namespace ec
