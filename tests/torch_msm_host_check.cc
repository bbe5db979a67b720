// Host build of the Groth16 prover kernels' bodies (K10: csrc/msm.cuh, K11:
// csrc/fixed_base.cuh) and of the headers under them (fq_bn254.cuh,
// bn254_curve.cuh), for tests/test_torch_msm_host.py.
//
// The pzk_msm_* and pzk_fixed_base entries take the arguments of
// csrc/msm.cu's and csrc/fixed_base.cu's C entries (the stream is ignored)
// and run every thread of the launch in turn, so ops/cuda_msm.execute
// drives them as it drives the card's kernels; K10's G2 arithmetic
// (fq::F2Pair) runs each item's two threads as coroutines that exchange
// their words (tests/torch_host_threads.h). The host_* entries expose
// the field and point arithmetic on the port's normal-form 16-bit limbs.
#include <stdint.h>

#include "fixed_base.cuh"
#include "msm.cuh"

#include "torch_host_threads.h"

namespace {

template <class F>
ec::Jac<F> scaled(const ec::Aff<F>& a, const typename F::Fe& z) {
  // (x z^2, y z^3, z): the same point in another Jacobian representation
  const typename F::Fe z2 = F::sqr(z);
  return {F::mul(a.x, z2), F::mul(a.y, F::mul(z2, z)), z};
}

template <class F>
int field_op(int op, const int64_t* a, const int64_t* b, int64_t* out) {
  const typename F::Fe x = F::load(a, 1), y = F::load(b, 1);
  typename F::Fe r;
  switch (op) {
    case 0: r = F::mul(x, y); break;
    case 1: r = F::sqr(x); break;
    case 2: r = F::inv(x); break;
    case 3: r = F::add(x, y); break;
    case 4: r = F::sub(x, y); break;
    default: return 1;
  }
  F::store(r, out, 1);
  return 0;
}

template <class F>
int point_op(int op, const int64_t* p, int p_inf, const int64_t* q, int q_inf,
             const int64_t* z, int64_t* out) {
  const long cw = F::WORDS * 2;  // limbs of a coordinate
  const ec::Aff<F> P{F::load(p, 1), F::load(p + cw, 1)};
  const ec::Aff<F> Q{F::load(q, 1), F::load(q + cw, 1)};
  const typename F::Fe zp = F::load(z, 1);
  const ec::Jac<F> Pj = p_inf ? ec::infinity<F>() : scaled(P, zp);
  const ec::Jac<F> Qj = q_inf ? ec::infinity<F>() : scaled(Q, F::sqr(zp));
  ec::Jac<F> r;
  switch (op) {
    case 0: r = ec::add(Pj, Qj); break;
    case 1:
      if (q_inf) return 1;
      r = ec::add_mixed(Pj, Q);
      break;
    case 2: r = ec::dbl(Pj); break;
    default: return 1;
  }
  const ec::Aff<F> a = ec::to_affine(r);
  F::store(a.x, out, 1);
  F::store(a.y, out + cw, 1);
  return 0;
}

// body(i) for items 0..n-1: G1's one thread an item, or G2's pair of
// coroutines an item
template <class Body>
void items(int g2, long n, const Body& body) {
  for (long i = 0; i < n; ++i) {
    if (g2)
      run_threads(2, [&](unsigned) { body(i); });
    else
      body(i);
  }
}

}  // namespace

extern "C" {

// op 0 mul, 1 sqr, 2 inv, 3 add, 4 sub over Fq (g2 = 0: 16 limbs) or Fq2
// (g2 = 1: (16, 2) limbs, limb-major)
int host_field_op(int g2, int op, const int64_t* a, const int64_t* b,
                  int64_t* out) {
  return g2 ? field_op<fq::F2>(op, a, b, out) : field_op<fq::F1>(op, a, b, out);
}

// op 0 P + Q (both Jacobian), 1 P + Q (Q affine, mixed), 2 2P; P and Q
// affine limbs (x then y), P scaled to Jacobian by z, Q by z^2; out: the
// affine result ((0, 0) for infinity)
int host_point_op(int g2, int op, const int64_t* p, int p_inf,
                  const int64_t* q, int q_inf, const int64_t* z,
                  int64_t* out) {
  return g2 ? point_op<fq::F2>(op, p, p_inf, q, q_inf, z, out)
            : point_op<fq::F1>(op, p, p_inf, q, q_inf, z, out);
}

int pzk_msm_points(int g2, const int64_t* px, const int64_t* py, long n,
                   uint32_t* out, void*) {
  for (long j = 0; j < n; ++j)
    g2 ? msm::points_thread<fq::F2>(px, py, n, out, j)
       : msm::points_thread<fq::F1Call>(px, py, n, out, j);
  return 0;
}

int pzk_msm_round(int g2, const uint32_t* pts, const int32_t* idx,
                  const uint32_t* in, const int32_t* src, long nout, long per,
                  uint32_t* out, void*) {
  long n = 0;              // threads of the launch that hold a slot
  while ((n / 32) * 32 * per + n % 32 < nout) ++n;
  items(g2, n, [&](long i) {
    g2 ? msm::round_thread<fq::F2Pair>(pts, idx, in, src, nout, per, out, i)
       : msm::round_thread<fq::F1Call>(pts, idx, in, src, nout, per, out, i);
  });
  return 0;
}

int pzk_msm_sum(int g2, const uint32_t* in, int aff, const int32_t* start,
                const int32_t* stop, const int32_t* dest, long nrun,
                uint32_t* out, uint32_t* last, void*) {
  items(g2, nrun, [&](long s) {
    g2 ? msm::sum_thread<fq::F2Pair>(in, aff, start, stop, dest, out, last, s)
       : msm::sum_thread<fq::F1Call>(in, aff, start, stop, dest, out, last,
                                     s);
  });
  return 0;
}

int pzk_msm_reduce(int g2, const uint32_t* buckets, const int32_t* dig,
                   const int32_t* first, const int32_t* dest, long ngroup,
                   uint32_t* out, uint32_t* last, void*) {
  items(g2, ngroup, [&](long g) {
    g2 ? msm::reduce_thread<fq::F2Pair>(buckets, dig, first, dest, out, last,
                                        g)
       : msm::reduce_thread<fq::F1Call>(buckets, dig, first, dest, out, last,
                                        g);
  });
  return 0;
}

int pzk_msm_horner(int g2, const uint32_t* wsum, int nwin, int c, long L,
                   int64_t* ox, int64_t* oy, void*) {
  items(g2, L, [&](long l) {
    g2 ? msm::horner_thread<fq::F2Pair>(wsum, nwin, c, L, ox, oy, l)
       : msm::horner_thread<fq::F1Call>(wsum, nwin, c, L, ox, oy, l);
  });
  return 0;
}

int pzk_fixed_base(int g2, const int64_t* scal, long B, const uint32_t* table,
                   int64_t* ox, int64_t* oy, void*) {
  for (long i = 0; i < B; ++i)
    g2 ? fb::mul_thread<fq::F2>(scal, B, table, ox, oy, i)
       : fb::mul_thread<fq::F1>(scal, B, table, ox, oy, i);
  return 0;
}

}  // extern "C"
