// K10's per-thread bodies: Pippenger's bucket method over BN254 G1 or G2
// (F = fq::F1 or fq::F2) with signed windows. csrc/msm.cu launches them; a
// host build runs them thread by thread (tests/torch_msm_host_check.cc).
//
// The plan (ops/cuda_msm.Schedule, plain PyTorch glue over indices only):
//   * a window is c bits of the scalar, c picked from the point count
//     (8..16), its digit signed: in [-(2^(c-1) - 1), 2^(c-1)], the carry
//     taken into the next window, so a window has 2^(c-1) buckets and the
//     top one of ceil(255 / c) windows takes the last carry (r < 2^254);
//   * every (lane, window, digit, point) with a non-zero digit is an item,
//     sorted by its bucket (lane, window, |digit|); a negative digit adds
//     the point with y -> q - y;
//   * round_thread adds pairs of a bucket's points in affine form, a run of
//     consecutive pairs a thread sharing one inversion (Montgomery's trick:
//     5 products and a squaring an add); each round halves every bucket,
//     and the rounds go on while they hold enough adds to fill the card;
//   * sum_thread adds a run of what is left of a bucket (affine points by
//     mixed adds, Jacobian partial sums by full adds) into one Jacobian
//     point: a Groth16 witness is mostly 0 and 1, so one bucket may hold
//     most of the points, and short runs spread its tail over many threads
//     in passes until each bucket has one;
//   * reduce_thread takes a group of a window's non-empty buckets (16 of a
//     window that holds at least half the digits up to its largest, one
//     bucket of a sparser one) and gives sum_b digit_b B_b by a running sum
//     from the top, stepping over empty digits by a short double-and-add:
//     its work follows the non-empty buckets; sum_thread joins a window's
//     groups, again in passes;
//   * horner_thread runs a lane's windows from the top (c doublings and an
//     add a window) and converts the result to affine normal-form limbs.
#pragma once

#include "bn254_curve.cuh"

namespace msm {

// Point j of the (16[, 2], n) normal-form limb tensors px, py as affine
// Montgomery words at out + j * AFF_WORDS (the key's points, converted once)
template <class F>
PZK_HD void points_thread(const int64_t* px, const int64_t* py, long n,
                          uint32_t* out, long j) {
  const ec::Aff<F> a{F::load(px + j, n), F::load(py + j, n)};
  ec::put_aff(a, out + j * ec::AFF_WORDS<F>);
}

// An affine point of a round is infinity when it is (0, 0), which no point
// of either curve is (y^2 = x^3 + b, b != 0)
template <class F>
PZK_HD bool aff_inf(const ec::Aff<F>& a) {
  return F::is_zero(a.x) && F::is_zero(a.y);
}

// Element a of a round's input: in round 0 (idx given) item a, the key's
// point idx[a] >> 1 of pts, negated when idx[a] & 1; in a later round the
// affine point a of in
template <class F>
PZK_HD ec::Aff<F> element(const uint32_t* pts, const int32_t* idx,
                          const uint32_t* in, long a) {
  if (idx) {
    const int32_t v = idx[a];
    ec::Aff<F> p = ec::get_aff<F>(pts + (long)(v >> 1) * ec::AFF_WORDS<F>);
    if (v & 1) p.y = F::sub(F::zero(), p.y);
    return p;
  }
  return ec::get_aff<F>(in + a * ec::AFF_WORDS<F>);
}

// What a round does with its pair (p, q): the sum by the chord (ADD) or
// the tangent (DBL), one of them (TAKE_P: q absent or infinity; TAKE_Q: p
// infinity), or infinity (ZERO: q = -p)
enum Pair { TAKE_P = 0, TAKE_Q = 1, ZERO = 2, ADD = 3, DBL = 4 };

// The pair's kind and the denominator of its slope (one when it has none)
template <class F>
PZK_HD int pair_kind(const ec::Aff<F>& p, const ec::Aff<F>& q, bool paired,
                     typename F::Fe& den) {
  den = F::one();
  if (!paired || aff_inf(q)) return TAKE_P;
  if (aff_inf(p)) return TAKE_Q;
  const typename F::Fe dx = F::sub(q.x, p.x);
  if (!F::is_zero(dx)) {
    den = dx;
    return ADD;
  }
  const typename F::Fe y2 = F::add(p.y, p.y);
  if (!F::is_zero(F::sub(p.y, q.y)) || F::is_zero(y2)) return ZERO;
  den = y2;
  return DBL;
}

// The pair's sum, dinv the inverse of its denominator: for the chord
// l = (y2 - y1) / (x2 - x1), for the tangent l = 3 x1^2 / (2 y1); then
// x3 = l^2 - x1 - x2, y3 = l (x1 - x3) - y1
template <class F>
PZK_HD ec::Aff<F> pair_sum(int kind, const ec::Aff<F>& p,
                           const ec::Aff<F>& q, const typename F::Fe& dinv) {
  using E = typename F::Fe;
  if (kind == TAKE_P) return p;
  if (kind == TAKE_Q) return q;
  if (kind == ZERO) return {F::zero(), F::zero()};
  E l;
  if (kind == ADD) {
    l = F::mul(F::sub(q.y, p.y), dinv);
  } else {
    const E xx = F::sqr(p.x);
    l = F::mul(F::add(F::add(xx, xx), xx), dinv);
  }
  const E x3 = F::sub(F::sub(F::sqr(l), p.x), q.x);   // q.x = p.x for DBL
  return {x3, F::sub(F::mul(l, F::sub(p.x, x3)), p.y)};
}

// Thread i of a round, lane i % 32 of its warp's span of 32 * per output
// slots: slots t = span + i % 32 + 32 k, k < per, below nout (a warp's
// loads and stores then fall on neighbouring slots). Slot t is the sum of
// input elements a and a + 1 (src[t] = 2a + 1), or element a alone (src[t]
// = 2a), as affine words at out + t * AFF_WORDS. Montgomery's trick over
// the thread's slots: the forward pass keeps each slot's prefix product of
// denominators in the slot itself (out and the input never overlap), one
// inversion, then the backward pass turns the prefixes into each slot's
// inverse and writes the sums.
template <class F>
PZK_HD void round_thread(const uint32_t* pts, const int32_t* idx,
                         const uint32_t* in, const int32_t* src, long nout,
                         long per, uint32_t* out, long i) {
  using E = typename F::Fe;
  constexpr int AW = ec::AFF_WORDS<F>;
  const long t0 = (i / 32) * 32 * per + i % 32;
  long t1 = t0 + 32 * per;                    // past this thread's slots
  if (t1 > nout) t1 = t0 + (nout - t0 + 31) / 32 * 32;
  E acc = F::one();
#pragma unroll 1
  for (long t = t0; t < t1; t += 32) {
    const long a = src[t] >> 1;
    const bool paired = src[t] & 1;
    const ec::Aff<F> p = element<F>(pts, idx, in, a);
    const ec::Aff<F> q = paired ? element<F>(pts, idx, in, a + 1) : p;
    E den;
    if (pair_kind(p, q, paired, den) >= ADD) {
      F::put(acc, out + t * AW);
      acc = F::mul(acc, den);
    }
  }
  E inv = F::inv(acc);
#pragma unroll 1
  for (long t = t1 - 32; t >= t0; t -= 32) {
    const long a = src[t] >> 1;
    const bool paired = src[t] & 1;
    const ec::Aff<F> p = element<F>(pts, idx, in, a);
    const ec::Aff<F> q = paired ? element<F>(pts, idx, in, a + 1) : p;
    E den, dinv = F::one();
    const int kind = pair_kind(p, q, paired, den);
    if (kind >= ADD) {
      dinv = F::mul(inv, F::get(out + t * AW));
      inv = F::mul(inv, den);
    }
    ec::put_aff(pair_sum(kind, p, q, dinv), out + t * AW);
  }
}

// Where item s of a pass goes: a bucket's or a window's sum, once whole, to
// slot dest[s] >= 0 of last; a partial sum to slot s of out (read by the
// next pass)
template <class F>
PZK_HD uint32_t* sum_slot(const int32_t* dest, uint32_t* out, uint32_t* last,
                          long s) {
  return dest[s] >= 0 ? last + (long)dest[s] * ec::JAC_WORDS<F>
                      : out + s * ec::JAC_WORDS<F>;
}

// Run s: elements start[s] .. stop[s] - 1 of in added into one Jacobian
// point at sum_slot(s): affine elements (aff; (0, 0) infinity) by mixed
// adds, Jacobian ones by full adds
template <class F>
PZK_HD void sum_thread(const uint32_t* in, int aff, const int32_t* start,
                       const int32_t* stop, const int32_t* dest,
                       uint32_t* out, uint32_t* last, long s) {
  ec::Jac<F> acc = ec::infinity<F>();
#pragma unroll 1
  for (long e = start[s]; e < stop[s]; ++e) {
    if (aff) {
      const ec::Aff<F> a = ec::get_aff<F>(in + e * ec::AFF_WORDS<F>);
      if (!aff_inf(a)) acc = ec::add_mixed(acc, a);
    } else {
      acc = ec::add(acc, ec::get_jac<F>(in + e * ec::JAC_WORDS<F>));
    }
  }
  ec::put_jac(acc, sum_slot<F>(dest, out, last, s));
}

// k p for 1 <= k < 2^31, by double-and-add from the top bit
template <class F>
PZK_HD ec::Jac<F> times(const ec::Jac<F>& p, uint32_t k) {
  int top = 30;
  while (!((k >> top) & 1)) --top;
  ec::Jac<F> r = p;
#pragma unroll 1
  for (int b = top - 1; b >= 0; --b) {
    r = ec::dbl(r);
    if ((k >> b) & 1) r = ec::add(r, p);
  }
  return r;
}

// Group g: the non-empty buckets first[g] .. first[g + 1] - 1 of one
// lane-window (Jacobian, at buckets + b * JAC_WORDS), their digits dig[b]
// ascending; sum_slot(g) gets sum_b dig[b] B_b by the running sum from the
// top: t the sum of the buckets so far, s += (dig[b] - dig[b - 1]) t, the
// step one add when the digits are neighbours (a dense window) and a
// double-and-add over a gap (and for the group's lowest digit)
template <class F>
PZK_HD void reduce_thread(const uint32_t* buckets, const int32_t* dig,
                          const int32_t* first, const int32_t* dest,
                          uint32_t* out, uint32_t* last, long g) {
  ec::Jac<F> t = ec::infinity<F>(), s = ec::infinity<F>();
  const long lo = first[g];
#pragma unroll 1
  for (long b = first[g + 1] - 1; b >= lo; --b) {
    t = ec::add(t, ec::get_jac<F>(buckets + b * ec::JAC_WORDS<F>));
    const uint32_t gap = (uint32_t)(dig[b] - (b > lo ? dig[b - 1] : 0));
    s = ec::add(s, gap == 1 ? t : times(t, gap));
  }
  ec::put_jac(s, sum_slot<F>(dest, out, last, g));
}

// Lane l of L: sum_w 2^(c w) W_w over its nwin window sums (lane-major,
// window w at l * nwin + w), as affine normal-form limbs at column l of the
// (16[, 2], L) outputs ox, oy; infinity gives (0, 0). Doublings of
// infinity (empty top windows) are skipped.
template <class F>
PZK_HD void horner_thread(const uint32_t* wsum, int nwin, int c, long L,
                          int64_t* ox, int64_t* oy, long l) {
  const uint32_t* w0 = wsum + l * nwin * ec::JAC_WORDS<F>;
  ec::Jac<F> acc = ec::get_jac<F>(w0 + (nwin - 1) * ec::JAC_WORDS<F>);
#pragma unroll 1
  for (int w = nwin - 2; w >= 0; --w) {
    if (!ec::is_inf(acc)) {
#pragma unroll 1
      for (int d = 0; d < c; ++d) acc = ec::dbl(acc);
    }
    acc = ec::add(acc, ec::get_jac<F>(w0 + w * ec::JAC_WORDS<F>));
  }
  const ec::Aff<F> a = ec::to_affine(acc);
  F::store(a.x, ox + l, L);
  F::store(a.y, oy + l, L);
}

}  // namespace msm
