// circomlib PoseidonEx permutation over BN254 Fr, generic in the state
// width T (2..17) and in the arithmetic policy A: one thread a lane
// (fr::Lane, K3) or a team of threads a lane (frt::Team, K4). Also the SMT
// root climb of one lane (K4). __host__ __device__ so g++ compiles it too.
//
// The schedule is the optimized one of ops/poseidon.py and
// utils/poseidon_ref.py: 4 full rounds (the last one mixing with the sparse
// pre-matrix P), nP partial rounds with the s0 row / s1 column maps, 4 full
// rounds, the last of which is folded into the output mix.
#pragma once

#include "fr_bn254.cuh"

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
