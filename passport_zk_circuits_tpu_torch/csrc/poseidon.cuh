// circomlib PoseidonEx permutation over BN254 Fr, generic in the state
// width T (2..17). Two forms of one schedule:
// - permute<T, A>: one lane's whole state in the calling thread, over an
//   arithmetic policy A: one thread a lane (fr::Lane, the host tests' form)
//   or a team of threads a lane (frt::Team, K4's climb below);
// - permute_split<T, S>: K3. One lane's permutation split over a group of
//   threads, each state element over a team of them (fr_slice.cuh).
// __host__ __device__ so g++ compiles it too.
//
// The schedule is the optimized one of ops/poseidon.py and
// utils/poseidon_ref.py: 4 full rounds (the last one mixing with the sparse
// pre-matrix P), nP partial rounds with the s0 row / s1 column maps, 4 full
// rounds, the last of which is folded into the output mix.
#pragma once

#include "fr_bn254.cuh"
#include "fr_slice.cuh"

namespace poseidon {

// Constant pack for width T, every entry 8 Montgomery-form words, in order:
//   C: 8T + nP round constants; M: T*T, entry (j, i) at j*T + i;
//   P: T*T, same layout; S: nP rows of 2T - 1.
struct Consts {
  const uint32_t* c;
  const uint32_t* m;
  const uint32_t* p;
  const uint32_t* s;
};

// entries in the pack of width T
PZK_HD int pack_entries(int T, int nP) {
  return 8 * T + nP + 2 * T * T + nP * (2 * T - 1);
}

PZK_HD Consts unpack(const uint32_t* pack, int T, int nP) {
  Consts k;
  k.c = pack;
  k.m = k.c + fr::NW * (8 * T + nP);
  k.p = k.m + fr::NW * T * T;
  k.s = k.p + fr::NW * T * T;
  return k;
}

template <class A>
PZK_HD typename A::Fe sigma(const A& f, const typename A::Fe& x) {
  const typename A::Fe x2 = f.sqr(x);
  const typename A::Fe x4 = f.sqr(x2);
  return f.mul(x4, x);
}

// st <- st * mat: out[i] = sum_j mat[j][i] * st[j]
template <int T, class A>
PZK_HD void mix(const A& f, typename A::Fe st[T], const uint32_t* mat) {
  typename A::Fe out[T];
  for (int i = 0; i < T; ++i) {
    out[i] = f.mul(f.at(mat, i), st[0]);
    for (int j = 1; j < T; ++j)
      out[i] = f.add(out[i], f.mul(f.at(mat, j * T + i), st[j]));
  }
  for (int i = 0; i < T; ++i) st[i] = out[i];
}

template <int T, class A>
PZK_HD void full_round(const A& f, typename A::Fe st[T], const uint32_t* c,
                       const uint32_t* mat) {
  for (int i = 0; i < T; ++i) st[i] = f.add(sigma(f, st[i]), f.at(c, i));
  mix<T>(f, st, mat);
}

// One permutation of the Montgomery-form state st (in place). On return
// st[0..n_outs) hold the PoseidonEx outputs.
template <int T, class A>
PZK_HD void permute(const A& f, typename A::Fe st[T], const uint32_t* pack,
                    int nP) {
  const Consts k = unpack(pack, T, nP);
  for (int i = 0; i < T; ++i) st[i] = f.add(st[i], f.at(k.c, i));
  for (int r = 0; r < 3; ++r)
    full_round<T>(f, st, k.c + fr::NW * (r + 1) * T, k.m);
  full_round<T>(f, st, k.c + fr::NW * 4 * T, k.p);
  for (int r = 0; r < nP; ++r) {
    const uint32_t* row = k.s + fr::NW * (2 * T - 1) * r;
    st[0] = f.add(sigma(f, st[0]), f.at(k.c, 5 * T + r));
    typename A::Fe new0 = f.mul(f.at(row, 0), st[0]);
    for (int i = 1; i < T; ++i)
      new0 = f.add(new0, f.mul(f.at(row, i), st[i]));
    for (int i = 1; i < T; ++i)
      st[i] = f.add(st[i], f.mul(st[0], f.at(row, T + i - 1)));
    st[0] = new0;
  }
  for (int r = 0; r < 3; ++r)
    full_round<T>(f, st, k.c + fr::NW * (5 * T + nP + r * T), k.m);
  for (int i = 0; i < T; ++i) st[i] = sigma(f, st[i]);
  mix<T>(f, st, k.m);
}

// -- K3: one lane's permutation split over its state elements --------------
//
// A thread on its own walks a permutation as one chain of dependent
// products, at T = 6 about 1,300 of them; on an H100 a thread's 256-bit
// product costs about 1,240 clocks. K3 splits a lane over a group:
// - each state element over its own team of TW = 8 / W threads, W words a
//   thread (fr_slice.cuh), so a product's 128 multiply-adds run W columns
//   a thread;
// - the elements side by side, rounded up to a power of two (threads past
//   T hold zero and run the same instructions, their results masked):
//   2 elements x 4 threads at T = 2, 4 x 4 at T = 3, 4, 8 x 4 at T = 5-8,
//   16 x 2 at T = 9-16, 32 x 1 at T = 17.
// A full round is the element's own S-box (3 products), then its output
// column of the mix: the T elements come by shuffle, and the T products are
// independent (unrolled by two). A partial round is four products, in step
// across the group: element 0's S-box x^2, x^4, x^5 and row[0] * y, beside
// which element i forms row[i] * st_i (in the first) and, with y broadcast,
// y * s1[i] (in the last); new0 is summed over the group by a shuffle
// butterfly. So a partial round waits on 4 team products and log2 of the
// elements' shuffled additions, instead of 2T + 2 products of one thread.

// elements of the group for width T: the power of two at or above T
PZK_HD constexpr int split_width(int T) {
  return T <= 2 ? 2 : T <= 4 ? 4 : T <= 8 ? 8 : T <= 16 ? 16 : 32;
}

// words a thread of an element's team holds: two (a team of four) where
// the lane fits a warp that way, else as few as fit. On an H100 at t = 2,
// 3, 4, 6 (tools/k3_designs) W = 2 ran 6-10 % faster than W = 1 and
// 25-89 % faster than W = 4 or 8.
PZK_HD constexpr int slice_words(int T) {
  return split_width(T) <= 8 ? 2 : split_width(T) / 4;
}

// threads a lane: elements x threads an element
PZK_HD constexpr int lane_threads(int T, int W) {
  return split_width(T) * (fr::NW / W);
}

// out_e = sum_j mat[j][e] * x_j, x_j held by element j's team; zero for
// the elements past T. No full unroll over T: 16 widths of a forced unroll
// once made poseidon.cu build for over 15 minutes.
template <int T, class S>
PZK_HD typename S::Fe mix_split(const S& f, const typename S::Fe& x,
                                const uint32_t* mat) {
  const unsigned ic = f.e < T ? f.e : T - 1;
  typename S::Fe acc = f.zero();
#pragma unroll 2
  for (int j = 0; j < T; ++j)
    acc = f.add(acc, f.mul(f.at(mat, j * T + ic), f.elem(x, j)));
  return S::select(f.e < T, acc, f.zero());
}

// One permutation of the Montgomery-form state, this thread's slice of
// element f.e in st (zero for f.e >= T), in place; every thread of the
// group must call it (the exchanges need the whole warp).
template <int T, class S>
PZK_HD void permute_split(const S& f, typename S::Fe& st,
                          const uint32_t* pack, int nP) {
  using Fe = typename S::Fe;
  const Consts k = unpack(pack, T, nP);
  const bool on = f.e < T;
  const bool lead = f.e == 0;
  const unsigned ic = on ? f.e : T - 1;      // constants' column, clamped
  st = S::select(on, f.add(st, f.at(k.c, ic)), st);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) {
    const Fe c = f.at(k.c + fr::NW * (r + 1) * T, ic);
    st = mix_split<T>(f, f.add(sigma(f, st), c), r < 3 ? k.m : k.p);
  }
#pragma unroll 1
  for (int r = 0; r < nP; ++r) {
    const uint32_t* row = k.s + fr::NW * (2 * T - 1) * r;
    const Fe ra = f.at(row, ic);
    // element 0 squares itself; element i >= 1 forms row[i] * st_i
    const Fe a = f.mul(st, S::select(lead, st, ra));
    // element 0's S-box and round constant (the others follow in step)
    const Fe y = f.add(f.mul(f.sqr(a), st), f.at(k.c, 5 * T + r));
    // element 0 forms row[0] * y; element i >= 1 y * s1[i]
    const Fe d = f.mul(f.elem(y, 0),
                       S::select(lead, ra, f.at(row, T + ic - 1)));
    // new0 = row[0] * y + sum of row[i] * st_i, summed over the group
    Fe sum = S::select(lead, d, S::select(on, a, f.zero()));
#pragma unroll
    for (unsigned m = 1; m < (unsigned)split_width(T); m <<= 1)
      sum = f.add(sum, f.elem(sum, f.e ^ m));
    st = S::select(lead, sum, S::select(on, f.add(st, d), f.zero()));
  }
#pragma unroll 1
  for (int r = 0; r < 4; ++r) {
    Fe x = sigma(f, st);
    if (r < 3) x = f.add(x, f.at(k.c + fr::NW * (5 * T + nP + r * T), ic));
    st = mix_split<T>(f, x, k.m);
  }
}

// K3's lane body, W words a thread: state (16 T, B) canonical limbs,
// element j in rows 16j..16j+15; out (16 n_outs, B). A lane past the batch
// (lane >= B) runs on lane B - 1 and stores nothing.
template <int T, int W, int GL>
PZK_HD void poseidon_lane(const wp::Group<GL>& g, const int64_t* state,
                          int64_t* out, const uint32_t* pack, int nP,
                          int n_outs, long lane, long B) {
  static_assert(GL == lane_threads(T, W), "a lane's group");
  const frs::Slice<W, GL> f = frs::make_slice<W>(g);
  const long mine = lane < B ? lane : B - 1;
  const unsigned ic = f.e < T ? f.e : T - 1;
  typename frs::Slice<W, GL>::Fe st =
      f.to_mont(f.load(state + 16L * ic * B + mine, B));
  st = f.select(f.e < T, st, f.zero());
  permute_split<T>(f, st, pack, nP);
  const typename frs::Slice<W, GL>::Fe r = f.from_mont(st);
  if (lane < B && (int)f.e < n_outs) f.store(r, out + 16L * f.e * B + lane, B);
}

// The SMT root climb of one lane (K4); returns the root in Montgomery form.
// sibs: (16 N, B) deepest level first; lr, top, inew: (N, B) flags; leaf:
// (16, B) = Poseidon(key, value, 1); pack3: the t = 3 pack. Per level: hash
// (L, R) ordered by the key bit, then keep the hash while on the top path,
// the leaf where the leaf is inserted, zero below it. A level's hash reaches
// the root only where top is set, so lanes that run in step (f.any: a warp)
// skip the permutation together when none of them is on the top path there;
// the selects are those of every level, so the root is the same.
template <class A>
PZK_HD typename A::Fe smt_climb(const A& f, const int64_t* sibs,
                                const int64_t* lr, const int64_t* top,
                                const int64_t* inew, const int64_t* leaf,
                                const uint32_t* pack3, int nP, int n_levels,
                                long lane, long B) {
  using Fe = typename A::Fe;
  const Fe leaf_m = f.to_mont(f.load(leaf + lane, B));
  Fe child = f.zero();
  for (int i = 0; i < n_levels; ++i) {
    const long at = (long)i * B + lane;
    const bool live = top[at] != 0;
    const Fe below = inew[at] != 0 ? leaf_m : f.zero();
    if (!f.any(live)) {
      child = below;
      continue;
    }
    const Fe sib = f.to_mont(f.load(sibs + 16L * i * B + lane, B));
    const bool right = lr[at] != 0;
    Fe st[3] = {f.zero(), right ? sib : child, right ? child : sib};
    permute<3>(f, st, pack3, nP);
    child = live ? st[0] : below;
  }
  return child;
}

}  // namespace poseidon
