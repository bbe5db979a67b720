// BabyJubJub (a x^2 + y^2 = 1 + d x^2 y^2 over BN254 Fr) in extended
// twisted-Edwards coordinates, per lane, Montgomery-form field elements.
// __host__ __device__ so g++ compiles it too.
#pragma once

#include "fr_bn254.cuh"

namespace bjj {

constexpr uint32_t A = 168700;
constexpr uint32_t D = 168696;

struct Point {
  fr::Fe X, Y, Z, T;
};

PZK_HD fr::Fe small_mont(uint32_t v) {
  fr::Fe x = fr::zero();
  x.w[0] = v;
  return fr::to_mont(x);
}

// Unified addition add-2008-hwcd, in the order of ops/babyjubjub.add:
// 9 products plus the two by the curve constants a_m, d_m (Montgomery form)
PZK_HD Point add(const Point& p, const Point& q, const fr::Fe& a_m,
                 const fr::Fe& d_m) {
  fr::Fe Aa = fr::mul(p.X, q.X);
  fr::Fe Bb = fr::mul(p.Y, q.Y);
  fr::Fe Cc = fr::mul(fr::mul(p.T, q.T), d_m);
  fr::Fe Dd = fr::mul(p.Z, q.Z);
  fr::Fe E = fr::sub(
      fr::sub(fr::mul(fr::add(p.X, p.Y), fr::add(q.X, q.Y)), Aa), Bb);
  fr::Fe F = fr::sub(Dd, Cc);
  fr::Fe G = fr::add(Dd, Cc);
  fr::Fe H = fr::sub(Bb, fr::mul(Aa, a_m));
  Point r;
  r.X = fr::mul(E, F);
  r.Y = fr::mul(G, H);
  r.Z = fr::mul(F, G);
  r.T = fr::mul(E, H);
  return r;
}

// One LSB-first double-and-add step: acc += base if bit; base doubles
PZK_HD void ladder_step(Point& acc, Point& base, bool bit, const fr::Fe& a_m,
                        const fr::Fe& d_m) {
  Point added = add(acc, base, a_m, d_m);
  if (bit) acc = added;
  base = add(base, base, a_m, d_m);
}

}  // namespace bjj
