// Host-only C interface over the port's __host__ __device__ kernel headers,
// compiled with g++ by tests/test_torch_csrc_host.py so that the kernels'
// per-lane arithmetic is checked on the CPU, bit for bit, against the plain
// PyTorch versions. Values cross as canonical 16-bit limbs in int64, the
// layout of the port's tensors (batch of one: stride 1).
#include <stdint.h>

#include "babyjubjub.cuh"
#include "bignum.cuh"
#include "fr_bn254.cuh"
#include "loop_bodies.cuh"
#include "poseidon.cuh"
#include "sha256.cuh"

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
  poseidon::permute<3>(st, pack, nP);
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
  const fr::Fe a_m = bjj::small_mont(bjj::A), d_m = bjj::small_mont(bjj::D);
  bjj::Point p, q;
  fr::Fe* pf[4] = {&p.X, &p.Y, &p.Z, &p.T};
  fr::Fe* qf[4] = {&q.X, &q.Y, &q.Z, &q.T};
  for (int i = 0; i < 4; ++i) {
    *pf[i] = load(acc + 16 * i);
    *qf[i] = load(base + 16 * i);
  }
  bjj::ladder_step(p, q, bit != 0, a_m, d_m);
  for (int i = 0; i < 4; ++i) {
    store(*pf[i], acc + 16 * i);
    store(*qf[i], base + 16 * i);
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
