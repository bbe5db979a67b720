// circomlib PoseidonEx permutation over BN254 Fr, per lane, generic in the
// state width T (2..17). __host__ __device__ so g++ compiles it too.
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

PZK_HD Consts unpack(const uint32_t* pack, int T, int nP) {
  Consts k;
  k.c = pack;
  k.m = k.c + fr::NW * (8 * T + nP);
  k.p = k.m + fr::NW * T * T;
  k.s = k.p + fr::NW * T * T;
  return k;
}

PZK_HD fr::Fe at(const uint32_t* base, int idx) {
  return fr::load_words(base + fr::NW * idx);
}

PZK_HD fr::Fe sigma(const fr::Fe& x) {
  fr::Fe x2 = fr::sqr(x);
  fr::Fe x4 = fr::sqr(x2);
  return fr::mul(x4, x);
}

// st <- st * mat: out[i] = sum_j mat[j][i] * st[j]
template <int T>
PZK_HD void mix(fr::Fe st[T], const uint32_t* mat) {
  fr::Fe out[T];
  for (int i = 0; i < T; ++i) {
    out[i] = fr::mul(at(mat, i), st[0]);
    for (int j = 1; j < T; ++j)
      out[i] = fr::add(out[i], fr::mul(at(mat, j * T + i), st[j]));
  }
  for (int i = 0; i < T; ++i) st[i] = out[i];
}

template <int T>
PZK_HD void full_round(fr::Fe st[T], const uint32_t* c, const uint32_t* mat) {
  for (int i = 0; i < T; ++i) st[i] = fr::add(sigma(st[i]), at(c, i));
  mix<T>(st, mat);
}

// One permutation of the Montgomery-form state st (in place). On return
// st[0..n_outs) hold the PoseidonEx outputs.
template <int T>
PZK_HD void permute(fr::Fe st[T], const uint32_t* pack, int nP) {
  const Consts k = unpack(pack, T, nP);
  for (int i = 0; i < T; ++i) st[i] = fr::add(st[i], at(k.c, i));
  for (int r = 0; r < 3; ++r) full_round<T>(st, k.c + fr::NW * (r + 1) * T, k.m);
  full_round<T>(st, k.c + fr::NW * 4 * T, k.p);
  for (int r = 0; r < nP; ++r) {
    const uint32_t* row = k.s + fr::NW * (2 * T - 1) * r;
    st[0] = fr::add(sigma(st[0]), at(k.c, 5 * T + r));
    fr::Fe new0 = fr::mul(at(row, 0), st[0]);
    for (int i = 1; i < T; ++i) new0 = fr::add(new0, fr::mul(at(row, i), st[i]));
    for (int i = 1; i < T; ++i)
      st[i] = fr::add(st[i], fr::mul(st[0], at(row, T + i - 1)));
    st[0] = new0;
  }
  for (int r = 0; r < 3; ++r)
    full_round<T>(st, k.c + fr::NW * (5 * T + nP + r * T), k.m);
  for (int i = 0; i < T; ++i) st[i] = sigma(st[i]);
  mix<T>(st, k.m);
}

}  // namespace poseidon
