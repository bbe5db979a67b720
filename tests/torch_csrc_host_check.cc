// Host-only C interface over the port's __host__ __device__ kernel headers,
// compiled with g++ by tests/test_torch_csrc_host.py so that the kernels'
// per-lane arithmetic is checked on the CPU, bit for bit, against the plain
// PyTorch versions. Values cross as canonical 16-bit limbs in int64, the
// layout of the port's tensors (batch of one: stride 1).
#include <stdint.h>
#include <ucontext.h>

#include <functional>
#include <vector>

#include "babyjubjub.cuh"
#include "bignum.cuh"
#include "fr_bn254.cuh"
#include "fr_slice.cuh"
#include "fr_team.cuh"
#include "loop_bodies.cuh"
#include "poseidon.cuh"
#include "sha256.cuh"
#include "warp.cuh"

#include "torch_host_threads.h"

namespace {
// fr_team.cuh's team: TEAM threads, thread j holding word j
void run_team(const std::function<void(const frt::Team&)>& fn) {
  run_threads(frt::TEAM, [&](unsigned j) {
    fn(frt::make_team(wp::Group<frt::TEAM>{j, 0}));
  });
}
}  // namespace

// K3's lane body (poseidon::poseidon_lane) on lanes 0..B of a batch of B,
// the kernel's layouts, a group of lane_threads(T) coroutines a lane; lane
// B runs past the batch, on lane B - 1, and must store nothing
template <int T>
void split_lanes(const int64_t* state, const uint32_t* pack, int nP,
                 int n_outs, int B, int64_t* out) {
  constexpr int W = poseidon::slice_words(T);
  constexpr int GL = poseidon::lane_threads(T, W);
  for (long lane = 0; lane <= B; ++lane)
    run_threads(GL, [&](unsigned i) {
      poseidon::poseidon_lane<T, W>(wp::Group<GL>{i, 0}, state, out, pack,
                                    nP, n_outs, lane, B);
    });
}

// K2's lane body (bnw::pow_lane) on B lanes, a warp of coroutines a lane
template <int W>
void warp_pow_lanes(const int64_t* sig, const int64_t* n, const int64_t* mu,
                    int k, int B, unsigned long long e, int64_t* out) {
  std::vector<uint32_t> scratch((size_t)B * bn::powmod_lane_words(k / 2));
  for (long lane = 0; lane < B; ++lane)
    run_threads(32, [&](unsigned l) {
      bnw::pow_lane<W>(bnw::Warp{l, 0}, sig, n, mu, out, k, lane, B, e,
                       scratch.data());
    });
}

// bnw::r2_mod_n on one lane: n (k limbs), mu (k + 1 limbs) -> k limbs
template <int W>
void warp_r2(const int64_t* n, const int64_t* mu, int k, int64_t* out) {
  run_threads(32, [&](unsigned l) {
    bnw::Mod<W> M;
    M.g = bnw::Warp{l, 0};
    M.K = k / 2;
    uint32_t m[W], r2[W];
    for (int w = 0; w < W; ++w) {
      const int j = (int)l * W + w;
      M.n[w] = j < M.K ? bnw::load_word(n, 1, k, j) : 0u;
      m[w] = j < M.K ? bnw::load_word(mu, 1, k + 1, j) : 0u;
    }
    bnw::r2_mod_n(M, m, r2);
    for (int w = 0; w < W; ++w) {
      const int j = (int)l * W + w;
      if (j < M.K) {
        out[2 * j] = r2[w] & 0xFFFF;
        out[2 * j + 1] = r2[w] >> 16;
      }
    }
  });
}

// K7's lane body (frs::mul_chain_lane) on lanes 0..B of a batch of B, a
// team of 8 / W coroutines a lane; lane B runs past the batch and must
// store nothing
template <int W>
void chain_lanes(const int64_t* a, const int64_t* c, int c_bcast,
                 int64_t* out, int n, int B) {
  constexpr int TW = fr::NW / W;
  for (long lane = 0; lane <= B; ++lane)
    run_threads(TW, [&](unsigned i) {
      frs::mul_chain_lane<W>(wp::Group<TW>{i, 0}, a, c, c_bcast, out, n,
                             lane, B);
    });
}

// K6's lane body (frs::mul_lane) on lanes 0..B of a batch of B, a team of
// 8 / W coroutines a lane; lane B runs past the batch and must store
// nothing
template <int W>
void mul_lanes(const int64_t* a, const int64_t* b, int b_bcast, int64_t* out,
               int B) {
  constexpr int TW = fr::NW / W;
  for (long lane = 0; lane <= B; ++lane)
    run_threads(TW, [&](unsigned i) {
      frs::mul_lane<W>(wp::Group<TW>{i, 0}, a, b, b_bcast, out, lane, B);
    });
}

// K8's threads of a PerLimb body on a batch of B: every thread of the
// launch, whole blocks of LIMB_BLOCK; -1 for a body that is not PerLimb
template <class Body>
int limb_launch(const int64_t* a, const int64_t* c, int n_iter, int64_t* out,
                int B) {
  if constexpr (loopb::per_limb<Body>) {
    const long blocks =
        ((long)loopb::NL * B + loopb::LIMB_BLOCK - 1) / loopb::LIMB_BLOCK;
    for (long idx = 0; idx < blocks * loopb::LIMB_BLOCK; ++idx)
      loopb::limb_thread<Body>(a, c, out, n_iter, idx, B);
    return 0;
  } else {
    return -1;
  }
}

static fr::Fe load(const int64_t* x) { return fr::to_mont(fr::load_limbs(x, 1)); }
static void store(const fr::Fe& a, int64_t* x) { fr::store_limbs(fr::from_mont(a), x, 1); }

extern "C" {

void host_fr_mul(const int64_t* a, const int64_t* b, int64_t* out) {
  store(fr::mul(load(a), load(b)), out);
}

void host_fr_sqr(const int64_t* a, int64_t* out) { store(fr::sqr(load(a)), out); }

void host_fr_add_sub(const int64_t* a, const int64_t* b, int64_t* sum,
                     int64_t* diff) {
  store(fr::add(load(a), load(b)), sum);
  store(fr::sub(load(a), load(b)), diff);
}

void host_sha256_compress(uint32_t* st, const uint32_t* blk) {
  sha::compress(st, blk);
}

// state: 3 elements of 16 limbs; out: the first output element
void host_poseidon3(const int64_t* state, const uint32_t* pack, int nP,
                    int64_t* out) {
  fr::Fe st[3];
  for (int j = 0; j < 3; ++j) st[j] = load(state + 16 * j);
  poseidon::permute<3>(fr::Lane(), st, pack, nP);
  store(st[0], out);
}

// x * y mod n, k 16-bit limbs each (k even, k <= 64), mu of k + 1 limbs
void host_barrett_mulmod(const int64_t* x, const int64_t* y, const int64_t* n,
                         const int64_t* mu, int k, int64_t* out) {
  const int K = k / 2;
  uint32_t X[32], Y[32], N[32], MU[33], R[32], scratch[5 * 32 + 3];
  bn::load_limbs(x, 1, k, X, 1);
  bn::load_limbs(y, 1, k, Y, 1);
  bn::load_limbs(n, 1, k, N, 1);
  bn::load_limbs(mu, 1, k + 1, MU, 1);
  bn::mulmod(X, Y, N, MU, K, R, scratch, 1);
  bn::store_limbs(R, 1, k, out, 1);
}

void host_pow_mod(const int64_t* x, const int64_t* n, const int64_t* mu,
                  int k, unsigned long long e, int64_t* out) {
  const int K = k / 2;
  uint32_t X[32], N[32], MU[33], R[32], scratch[5 * 32 + 3];
  bn::load_limbs(x, 1, k, X, 1);
  bn::load_limbs(n, 1, k, N, 1);
  bn::load_limbs(mu, 1, k + 1, MU, 1);
  bn::powmod(X, e, N, MU, K, R, scratch, 1);
  bn::store_limbs(R, 1, k, out, 1);
}

// acc, base: X, Y, Z, T of 16 limbs each, updated in place
void host_ladder_step(int64_t* acc, int64_t* base, int bit) {
  const fr::Lane f;
  const fr::Fe a_m = f.to_mont(f.small(bjj::A));
  const fr::Fe d_m = f.to_mont(f.small(bjj::D));
  bjj::Point<fr::Fe> p, q;
  fr::Fe* pf[4] = {&p.X, &p.Y, &p.Z, &p.T};
  fr::Fe* qf[4] = {&q.X, &q.Y, &q.Z, &q.T};
  for (int i = 0; i < 4; ++i) {
    *pf[i] = load(acc + 16 * i);
    *qf[i] = load(base + 16 * i);
  }
  bjj::ladder_step(f, p, q, bit != 0, a_m, d_m);
  for (int i = 0; i < 4; ++i) {
    store(*pf[i], acc + 16 * i);
    store(*qf[i], base + 16 * i);
  }
}

// fr::inv (Fermat) with one thread a lane
void host_fr_inv(const int64_t* a, int64_t* out) {
  store(fr::inv(fr::Lane(), load(a)), out);
}

// The team arithmetic of fr_team.cuh on one element, its eight threads
// emulated: op 0 mul, 1 sqr, 2 add, 3 sub, 4 inv, 5 to_mont then
// from_mont. a, b, out: 16 canonical limbs; a and b go in through the
// team's own to_mont, out comes back through its from_mont.
void host_team_op(int op, const int64_t* a, const int64_t* b, int64_t* out) {
  run_team([&](const frt::Team& tm) {
    const uint32_t x = tm.to_mont(tm.load(a, 1));
    const uint32_t y = tm.to_mont(tm.load(b, 1));
    uint32_t r = x;
    switch (op) {
      case 0: r = tm.mul(x, y); break;
      case 1: r = tm.sqr(x); break;
      case 2: r = tm.add(x, y); break;
      case 3: r = tm.sub(x, y); break;
      case 4: r = fr::inv(tm, x); break;
      default: break;
    }
    tm.store(tm.from_mont(r), out, 1);
  });
}

// One t = 3 permutation with a team a lane; state: 3 x 16 limbs
void host_team_poseidon3(const int64_t* state, const uint32_t* pack, int nP,
                         int64_t* out) {
  run_team([&](const frt::Team& tm) {
    uint32_t st[3];
    for (int j = 0; j < 3; ++j) st[j] = tm.to_mont(tm.load(state + 16 * j, 1));
    poseidon::permute<3>(tm, st, pack, nP);
    tm.store(tm.from_mont(st[0]), out, 1);
  });
}

// K4's climb on B lanes, the kernel's layouts (see csrc/poseidon.cu), one
// lane at a time: with one thread a lane (team = 0) or a team (team = 1)
void host_smt_climb(int team, const int64_t* sibs, const int64_t* lr,
                    const int64_t* top, const int64_t* inew,
                    const int64_t* leaf, const uint32_t* pack3, int nP,
                    int n_levels, int B, int64_t* out) {
  for (long lane = 0; lane < B; ++lane) {
    if (team) {
      run_team([&](const frt::Team& tm) {
        const uint32_t r = poseidon::smt_climb(tm, sibs, lr, top, inew, leaf,
                                               pack3, nP, n_levels, lane, B);
        tm.store(tm.from_mont(r), out + lane, B);
      });
    } else {
      const fr::Lane f;
      const fr::Fe r = poseidon::smt_climb(f, sibs, lr, top, inew, leaf,
                                           pack3, nP, n_levels, lane, B);
      f.store(f.from_mont(r), out + lane, B);
    }
  }
}

// K5 on B lanes with a team a lane, the kernel's layouts (see
// csrc/babyjubjub.cu): out (4, 16, B) extended, or (2, 16, B) affine
void host_team_ladder(int affine, const int64_t* bits, const int64_t* bx,
                      const int64_t* by, int nbits, int B, int64_t* out) {
  const long plane = 16L * B;
  for (long lane = 0; lane < B; ++lane) {
    run_team([&](const frt::Team& tm) {
      const bjj::Point<uint32_t> acc =
          bjj::ladder(tm, bits, bx, by, nbits, lane, B);
      uint32_t res[4] = {acc.X, acc.Y, acc.Z, acc.T};
      if (affine) {
        const uint32_t zinv = fr::inv(tm, acc.Z);
        res[0] = tm.mul(acc.X, zinv);
        res[1] = tm.mul(acc.Y, zinv);
      }
      for (int k = 0; k < (affine ? 2 : 4); ++k)
        tm.store(tm.from_mont(res[k]), out + k * plane + lane, B);
    });
  }
}

// n_iter steps of K8's body number `body` (csrc/loop_bodies.cuh) on one
// lane; a, c, out: 16 limbs. Returns -1 for an unknown body.
int host_loop(int body, const int64_t* a, const int64_t* c, int n_iter,
              int64_t* out) {
  switch (body) {
#define HOST_LOOP_CASE(id, T)                                          \
  case id:                                                             \
    loopb::store16(loopb::run<loopb::T>(loopb::load16(a, 1),           \
                                        loopb::load16(c, 1), n_iter),  \
                   out, 1);                                            \
    return 0;
    PZK_LOOP_BODIES(HOST_LOOP_CASE)
  }
  return -1;
}

// K8's launch of body number `body` as one thread a (limb, lane): a, c, out
// (16, B). Returns -1 for a body K8 does not run that way.
int host_loop_limbs(int body, const int64_t* a, const int64_t* c, int n_iter,
                    int64_t* out, int B) {
  switch (body) {
#define HOST_LIMB_CASE(id, T) \
  case id:                    \
    return limb_launch<loopb::T>(a, c, n_iter, out, B);
    PZK_LOOP_BODIES(HOST_LIMB_CASE)
  }
  return -1;
}

// K3 at width t on B lanes: state (16 t, B), out (16 n_outs, B). Returns
// -1 for a width the host build does not instantiate.
int host_poseidon_split(const int64_t* state, const uint32_t* pack, int t,
                        int nP, int n_outs, int B, int64_t* out) {
  switch (t) {
    case 2: split_lanes<2>(state, pack, nP, n_outs, B, out); return 0;
    case 3: split_lanes<3>(state, pack, nP, n_outs, B, out); return 0;
    case 6: split_lanes<6>(state, pack, nP, n_outs, B, out); return 0;
    case 12: split_lanes<12>(state, pack, nP, n_outs, B, out); return 0;
    case 17: split_lanes<17>(state, pack, nP, n_outs, B, out); return 0;
  }
  return -1;
}

// K2 on B lanes of k limbs: sig, n, out (k, B), mu (k + 1, B). Returns -1
// for a width W = ceil(k / 64) the host build does not instantiate (it
// has 1, 2 and 5: k = 308 is 154 words, the top thread's empty).
int host_warp_pow_mod(const int64_t* sig, const int64_t* n, const int64_t* mu,
                      int k, int B, unsigned long long e, int64_t* out) {
  switch ((k / 2 + 31) / 32) {
    case 1: warp_pow_lanes<1>(sig, n, mu, k, B, e, out); return 0;
    case 2: warp_pow_lanes<2>(sig, n, mu, k, B, e, out); return 0;
    case 5: warp_pow_lanes<5>(sig, n, mu, k, B, e, out); return 0;
  }
  return -1;
}

int host_warp_r2(const int64_t* n, const int64_t* mu, int k, int64_t* out) {
  switch ((k / 2 + 31) / 32) {
    case 1: warp_r2<1>(n, mu, k, out); return 0;
    case 2: warp_r2<2>(n, mu, k, out); return 0;
    case 5: warp_r2<5>(n, mu, k, out); return 0;
  }
  return -1;
}

// K1's many-message plan for n messages of nb[i] SHA blocks and B lanes:
// for thread t of thread block b, thread_msg[32 b + t] is the caller's
// index of the message it hashes (-1 past the batch) and thread_lane[32 b
// + t] its lane. Returns the launch's number of thread blocks.
int host_sha_many_map(int n, const int* nb, int B, int* thread_msg,
                      long* thread_lane) {
  static int64_t base[sha::MAX_MSGS];        // message i is at base + i
  const int64_t* msg[sha::MAX_MSGS];
  int64_t* out[sha::MAX_MSGS];
  int is224[sha::MAX_MSGS] = {};
  for (int i = 0; i < n; ++i) msg[i] = out[i] = base + i;
  const sha::Many m = sha::plan_many(n, msg, out, nb, is224, B);
  const int blocks = sha::many_blocks(m);
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < sha::MANY_THREADS; ++t) {
      const sha::Chunk c = sha::block_chunk(m, b);
      const long lane = c.lane0 + t;
      thread_msg[b * sha::MANY_THREADS + t] =
          lane < B ? (int)(m.msg[c.slot] - base) : -1;
      thread_lane[b * sha::MANY_THREADS + t] = lane;
    }
  return blocks;
}

// K1's many-message entry on the host: every thread of every thread block
// of the launch (sha::many_thread); msg[i] (16 nb[i], B), out[i] (8, B)
void host_sha_many(int n, const int64_t* const* msg, int64_t* const* out,
                   const int* nb, const int* is224, int B) {
  const sha::Many m = sha::plan_many(n, msg, out, nb, is224, B);
  for (int b = 0; b < sha::many_blocks(m); ++b)
    for (int t = 0; t < sha::MANY_THREADS; ++t) sha::many_thread(m, b, t);
}

// K7 with a team of 8 / W threads a lane: a, out (16, B); c (16, B) or
// (16, 1) when c_bcast. Returns -1 for a W that does not divide 8.
int host_fr_chain(int W, const int64_t* a, const int64_t* c, int c_bcast,
                  int64_t* out, int n, int B) {
  switch (W) {
    case 1: chain_lanes<1>(a, c, c_bcast, out, n, B); return 0;
    case 2: chain_lanes<2>(a, c, c_bcast, out, n, B); return 0;
    case 4: chain_lanes<4>(a, c, c_bcast, out, n, B); return 0;
    case 8: chain_lanes<8>(a, c, c_bcast, out, n, B); return 0;
  }
  return -1;
}

// K6 with a team of 8 / W threads a lane: a, out (16, B); b (16, B) or
// (16, 1) when b_bcast. Returns -1 for a W that does not divide 8.
int host_fr_mul_team(int W, const int64_t* a, const int64_t* b, int b_bcast,
                     int64_t* out, int B) {
  switch (W) {
    case 1: mul_lanes<1>(a, b, b_bcast, out, B); return 0;
    case 2: mul_lanes<2>(a, b, b_bcast, out, B); return 0;
    case 4: mul_lanes<4>(a, b, b_bcast, out, B); return 0;
    case 8: mul_lanes<8>(a, b, b_bcast, out, B); return 0;
  }
  return -1;
}

}  // extern "C"
