// BabyJubJub (a x^2 + y^2 = 1 + d x^2 y^2 over BN254 Fr) in extended
// twisted-Edwards coordinates, Montgomery-form field elements, generic in
// the arithmetic policy A (fr::Lane: one thread a lane; frt::Team: a team
// of threads a lane). __host__ __device__ so g++ compiles it too.
#pragma once

#include "fr_bn254.cuh"

namespace bjj {

constexpr uint32_t A = 168700;
constexpr uint32_t D = 168696;

template <class Fe>
struct Point {
  Fe X, Y, Z, T;
};

// Unified addition add-2008-hwcd, in the order of ops/babyjubjub.add:
// 9 products plus the two by the curve constants a_m, d_m (Montgomery
// form). The first five products are independent, then two, then four.
template <class F>
PZK_HD Point<typename F::Fe> add(const F& f, const Point<typename F::Fe>& p,
                                 const Point<typename F::Fe>& q,
                                 const typename F::Fe& a_m,
                                 const typename F::Fe& d_m) {
  using Fe = typename F::Fe;
  const Fe Aa = f.mul(p.X, q.X);
  const Fe Bb = f.mul(p.Y, q.Y);
  const Fe Cc = f.mul(f.mul(p.T, q.T), d_m);
  const Fe Dd = f.mul(p.Z, q.Z);
  const Fe E = f.sub(
      f.sub(f.mul(f.add(p.X, p.Y), f.add(q.X, q.Y)), Aa), Bb);
  const Fe Fv = f.sub(Dd, Cc);
  const Fe G = f.add(Dd, Cc);
  const Fe H = f.sub(Bb, f.mul(Aa, a_m));
  Point<Fe> r;
  r.X = f.mul(E, Fv);
  r.Y = f.mul(G, H);
  r.Z = f.mul(Fv, G);
  r.T = f.mul(E, H);
  return r;
}

template <class Fe>
PZK_HD Point<Fe> select(bool c, const Point<Fe>& p, const Point<Fe>& q) {
  Point<Fe> r;
  r.X = c ? p.X : q.X;
  r.Y = c ? p.Y : q.Y;
  r.Z = c ? p.Z : q.Z;
  r.T = c ? p.T : q.T;
  return r;
}

// One LSB-first double-and-add step: acc += base if bit; base doubles. The
// two additions are independent.
template <class F>
PZK_HD void ladder_step(const F& f, Point<typename F::Fe>& acc,
                        Point<typename F::Fe>& base, bool bit,
                        const typename F::Fe& a_m,
                        const typename F::Fe& d_m) {
  const Point<typename F::Fe> added = add(f, acc, base, a_m, d_m);
  base = add(f, base, base, a_m, d_m);
  acc = select(bit, added, acc);
}

// The ladder of one lane (K5): bits (nbits, B) in {0, 1}, LSB first;
// bx, by: (16, B) affine base. Returns acc = scalar * base, extended,
// Montgomery form, from the identity (0, 1, 1, 0).
template <class F>
PZK_HD Point<typename F::Fe> ladder(const F& f, const int64_t* bits,
                                    const int64_t* bx, const int64_t* by,
                                    int nbits, long lane, long B) {
  using Fe = typename F::Fe;
  const Fe a_m = f.to_mont(f.small(A));
  const Fe d_m = f.to_mont(f.small(D));
  Point<Fe> base;
  base.X = f.to_mont(f.load(bx + lane, B));
  base.Y = f.to_mont(f.load(by + lane, B));
  base.Z = f.one();
  base.T = f.mul(base.X, base.Y);
  Point<Fe> acc;
  acc.X = f.zero();
  acc.Y = f.one();
  acc.Z = f.one();
  acc.T = f.zero();
  for (int i = 0; i < nbits; ++i)
    ladder_step(f, acc, base, bits[(long)i * B + lane] != 0, a_m, d_m);
  return acc;
}

}  // namespace bjj
