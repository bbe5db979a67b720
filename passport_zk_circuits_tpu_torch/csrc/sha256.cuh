// SHA-256 compression of one 512-bit block, per lane (FIPS 180-4).
// __host__ __device__ so g++ compiles the same code for the host tests.
#pragma once

#include <stdint.h>

#include "fr_bn254.cuh"  // PZK_HD

namespace sha {

PZK_HD uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

// st: 8 state words, updated in place; blk: 16 big-endian message words.
// Both loops unroll fully, so the round constants fold into immediates and
// the 16-word schedule window stays in registers.
PZK_HD void compress(uint32_t st[8], const uint32_t blk[16]) {
  const uint32_t K[64] = {
      0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
      0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
      0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
      0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
      0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
      0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
      0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
      0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
      0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
      0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
      0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
      0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
      0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = blk[i];
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + K[i] + wi;
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// 16 words of block blk of a (16 nb, B) message, at lane
PZK_HD void load_block(uint32_t w[16], const int64_t* msg, int blk, long B,
                       long lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    w[i] = (uint32_t)msg[(16L * blk + i) * B + lane];
}

// One lane of a (16 nb, B) message: its digest words to out (8, B), the
// IV of SHA-224 when is224. Block i + 1's words are loaded before block i
// is compressed, so each block's global loads are in flight during the
// rounds before it.
PZK_HD void hash_lane(const int64_t* msg, int64_t* out, int nb, bool is224,
                      long B, long lane) {
  const uint32_t iv256[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                             0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                             0x1f83d9abu, 0x5be0cd19u};
  const uint32_t iv224[8] = {0xc1059ed8u, 0x367cd507u, 0x3070dd17u,
                             0xf70e5939u, 0xffc00b31u, 0x68581511u,
                             0x64f98fa7u, 0xbefa4fa4u};
  uint32_t st[8], cur[16], nxt[16] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = is224 ? iv224[i] : iv256[i];
  if (nb > 0) load_block(cur, msg, 0, B, lane);
  for (int blk = 0; blk < nb; ++blk) {
    if (blk + 1 < nb) load_block(nxt, msg, blk + 1, B, lane);
    compress(st, cur);
#pragma unroll
    for (int i = 0; i < 16; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[(long)i * B + lane] = st[i];
}

// K1's many-message entry: up to MAX_MSGS messages of B lanes each, every
// one with its own block count and IV, hashed by one launch. A thread
// block is one warp of one message, so no warp straddles two block counts;
// each message takes lane_chunks(B) thread blocks, the messages with the
// most SHA blocks first.
constexpr int MAX_MSGS = 4;
constexpr int MANY_THREADS = 32;

struct Many {
  const int64_t* msg[MAX_MSGS];  // (16 nb, B) words
  int64_t* out[MAX_MSGS];        // (8, B) digest words
  int nb[MAX_MSGS];
  int is224[MAX_MSGS];
  int n;                         // messages
  int B;                         // lanes of each
};

PZK_HD int lane_chunks(int B) { return (B + MANY_THREADS - 1) / MANY_THREADS; }

PZK_HD int many_blocks(const Many& m) { return m.n * lane_chunks(m.B); }

// The plan of one launch: the caller's n <= MAX_MSGS messages, ordered by
// block count, most first (a stable insertion sort).
PZK_HD Many plan_many(int n, const int64_t* const* msg, int64_t* const* out,
                      const int* nb, const int* is224, int B) {
  Many m;
  m.n = n;
  m.B = B;
  for (int i = 0; i < n; ++i) {
    int j = i;
    for (; j > 0 && m.nb[j - 1] < nb[i]; --j) {
      m.msg[j] = m.msg[j - 1];
      m.out[j] = m.out[j - 1];
      m.nb[j] = m.nb[j - 1];
      m.is224[j] = m.is224[j - 1];
    }
    m.msg[j] = msg[i];
    m.out[j] = out[i];
    m.nb[j] = nb[i];
    m.is224[j] = is224[i];
  }
  return m;
}

// Thread block b of a plan: the message it hashes (its place in the plan)
// and the first of its lanes
struct Chunk {
  int slot;
  long lane0;
};

PZK_HD Chunk block_chunk(const Many& m, int b) {
  const int c = lane_chunks(m.B);
  return {b / c, (long)(b % c) * MANY_THREADS};
}

// Thread t of thread block b; a lane past the batch does nothing
PZK_HD void many_thread(const Many& m, int b, int t) {
  const Chunk c = block_chunk(m, b);
  const long lane = c.lane0 + t;
  if (lane >= m.B) return;
  hash_lane(m.msg[c.slot], m.out[c.slot], m.nb[c.slot], m.is224[c.slot] != 0,
            m.B, lane);
}

}  // namespace sha
