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
#include "fr_team.cuh"
#include "loop_bodies.cuh"
#include "poseidon.cuh"
#include "sha256.cuh"

// A team's TEAM threads as coroutines on one host thread, with a slot
// each: sync() passes control to the next thread, round robin, so when a
// thread's sync() returns, every thread has reached the same point.
namespace {
struct Exchange {
  ucontext_t main_ctx, ctx[frt::TEAM];
  unsigned cur = 0;
  uint32_t slot[frt::TEAM];

  void sync() {
    const unsigned me = cur;
    cur = (me + 1) % frt::TEAM;
    swapcontext(&ctx[me], &ctx[cur]);
  }
};

Exchange* current_ex = nullptr;                              // the team run
const std::function<void(const frt::Team&)>* current_fn = nullptr;

void run_thread(int j) { (*current_fn)(frt::make_team((unsigned)j, 0)); }

// Run fn(team) as the TEAM threads of one team, in step at every shuffle
// and ballot. A thread that returns hands over to the next; the last one
// back to the caller.
void run_team(const std::function<void(const frt::Team&)>& fn) {
  Exchange ex;
  std::vector<std::vector<char>> stacks(frt::TEAM,
                                        std::vector<char>(1 << 18));
  for (int j = 0; j < frt::TEAM; ++j) {
    getcontext(&ex.ctx[j]);
    ex.ctx[j].uc_stack.ss_sp = stacks[j].data();
    ex.ctx[j].uc_stack.ss_size = stacks[j].size();
    ex.ctx[j].uc_link = j + 1 < frt::TEAM ? &ex.ctx[j + 1] : &ex.main_ctx;
    makecontext(&ex.ctx[j], (void (*)())run_thread, 1, j);
  }
  current_ex = &ex;
  current_fn = &fn;
  swapcontext(&ex.main_ctx, &ex.ctx[0]);
  current_ex = nullptr;
}
}  // namespace

// The team exchange fr_team.cuh asks a host build for
namespace frt {
uint32_t team_from(unsigned j, uint32_t x, unsigned src) {
  current_ex->slot[j] = x;
  current_ex->sync();
  const uint32_t r = current_ex->slot[src];
  current_ex->sync();
  return r;
}

unsigned team_ballot(unsigned j, bool p) {
  current_ex->slot[j] = p;
  current_ex->sync();
  unsigned m = 0;
  for (int k = 0; k < TEAM; ++k) m |= (current_ex->slot[k] != 0 ? 1u : 0u) << k;
  current_ex->sync();
  return m;
}
}  // namespace frt

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

}  // extern "C"
