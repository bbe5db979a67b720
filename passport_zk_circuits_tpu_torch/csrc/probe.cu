// K9: a battery of probes, each checking one thing that the port's kernels
// rely on now or that their later redesigns will need, checked bit for bit
// against a plain version by ops/cuda_probe.py. Replaces the TPU battery
// run_kernel of tools/probe_mosaic.py, which probed what the Pallas TPU
// compiler accepts.
//
// One kernel runs any set of probes. A by-value table (Plan) gives each
// probe (a role) its pointers, its n, its first block and its number of
// blocks; a block finds its role from blockIdx.x and runs that probe's body,
// so every warp of a block takes one branch. Each probe moves a few
// kilobytes and does a few thousand operations: eight launches in series
// were eight launch latencies, so the battery runs in one launch, and its
// time is that of its slowest block: smem_dynamic_large, 819 KB through
// one SM, whose rate grows with the warps it keeps in flight.
//
// All blocks have kThreads threads and one dynamic shared buffer, sized to
// the largest role of the launch. Blocks run in clusters of two, so each
// role's range starts on an even block and has an even length
// (ops/cuda_probe.battery_plan): cluster_dsmem's pairs never straddle two
// roles.
//
// Two C entry points: pzk_probe (one role; refused_launch asks for 2048
// threads a block) and pzk_probe_battery (a table of roles). The ids are
// the order of ops/cuda_probe.KERNEL_PROBES. All data crosses as int64.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace probe {

constexpr int kThreads = 1024;
constexpr int kMaxRoles = 8;
constexpr int kAsyncWords = 2048;   // cp_async, bulk_copy_mbarrier: 16 KB
constexpr int kSmemUnroll = 4;      // smem_dynamic_large: loads in flight
constexpr int kChunk = 128;         // cluster_dsmem: words a chunk

enum Id {
  kBasic, kMulWide, kSmem, kRefused, kShflCarry, kCpAsync, kBulkCopy,
  kMmaS8, kCluster, kIds
};

struct Role {
  const int64_t* in0;
  const int64_t* in1;
  int64_t* out;
  int id, n, first, blocks;
};

struct Plan {
  Role role[kMaxRoles];
  int count;
};

// 0 basic: int64 limb I/O, out = (a * a + (a >> 3)) & 0xFFFF
__device__ void basic(const Role& r, int b) {
  const int i = b * kThreads + threadIdx.x;
  if (i >= r.n) return;
  const uint32_t x = (uint32_t)r.in0[i];
  r.out[i] = (x * x + (x >> 3)) & 0xFFFFu;
}

// 1 mul_wide: out[i] = low 32 bits of the 64-bit product a*b,
// out[n + i] = __umulhi(a, b)
__device__ void mul_wide(const Role& r, int b) {
  const int i = b * kThreads + threadIdx.x;
  if (i >= r.n) return;
  const uint32_t x = (uint32_t)r.in0[i], y = (uint32_t)r.in1[i];
  r.out[i] = (uint32_t)((uint64_t)x * y);
  r.out[r.n + i] = __umulhi(x, y);
}

// 2 smem_dynamic_large: n 32-bit words through dynamic shared memory (n * 4
// bytes, above the 48 KB static limit) in one block, read back reversed.
// One SM moves the 819 KB, at the rate of the loads it keeps in flight:
// kSmemUnroll a thread, from global memory on the way in and from shared
// memory on the way out (tools/kernel_designs --kernel k9 times the
// choices).
__device__ void smem_large(const Role& r, int b, uint32_t* sm) {
  if (b != 0) return;                  // the pair's second block is idle
  const int n = r.n;
  const int64_t* __restrict__ in = r.in0;
  int64_t* __restrict__ out = r.out;
  for (int base = 0; base < n; base += kThreads * kSmemUnroll) {
    uint32_t v[kSmemUnroll];
#pragma unroll
    for (int u = 0; u < kSmemUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      v[u] = i < n ? (uint32_t)in[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kSmemUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < n) sm[i] = v[u];
    }
  }
  __syncthreads();
  for (int base = 0; base < n; base += kThreads * kSmemUnroll) {
    uint32_t v[kSmemUnroll];
#pragma unroll
    for (int u = 0; u < kSmemUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      v[u] = i < n ? sm[n - 1 - i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kSmemUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < n) out[i] = v[u];
    }
  }
}

// 4 shfl_carry: 16 threads hold the 16 limbs (< 2^17) of one number and
// propagate carries with __shfl_up_sync: out = the number mod 2^256 in
// 16-bit limbs. After the first round every carry is 0 or 1, and a run of
// carries moves up one limb a round, so 17 rounds resolve all of them.
// n = B numbers, limb-major (16, B); every thread reaches every shuffle.
__device__ void shfl_carry(const Role& r, int b) {
  const int t = b * kThreads + threadIdx.x;
  const int B = r.n, elem = t / 16, limb = t % 16;
  const bool live = elem < B;
  uint32_t v = live ? (uint32_t)r.in0[(long)limb * B + elem] : 0u;
  for (int k = 0; k < 17; ++k) {
    const uint32_t carry = v >> 16;
    const uint32_t in = __shfl_up_sync(0xFFFFFFFFu, carry, 1, 16);
    v = (v & 0xFFFFu) + (limb == 0 ? 0u : in);
  }
  if (live) r.out[(long)limb * B + elem] = v;
}

// 5 cp_async: one block copies the kAsyncWords int64 (16 bytes a copy) from
// global to shared memory with cp.async, waits, and writes them rotated by
// one
__device__ void cp_async(const Role& r, int b, int64_t* sm) {
  if (b != 0) return;
  for (int i = 2 * threadIdx.x; i < kAsyncWords; i += 2 * kThreads) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(sm + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(r.in0 + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int i = threadIdx.x; i < kAsyncWords; i += kThreads)
    r.out[i] = sm[(i + 1) % kAsyncWords];
}

// 6 bulk_copy_mbarrier: one thread issues a 1-D cp.async.bulk of the whole
// buffer, which completes on an mbarrier (transaction bytes); every thread
// waits on the barrier's phase and writes the buffer reversed. sm is
// 128-byte aligned; the barrier follows the buffer.
__device__ void bulk_copy(const Role& r, int b, int64_t* sm) {
  if (b != 0) return;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + kAsyncWords);
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(bar);
  const uint32_t bytes = kAsyncWords * sizeof(int64_t);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar_addr),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_addr),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(
            (uint32_t)__cvta_generic_to_shared(sm)),
        "l"(r.in0), "r"(bytes), "r"(bar_addr)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_addr), "r"(0)
        : "memory");
  }
  for (int i = threadIdx.x; i < kAsyncWords; i += kThreads)
    r.out[i] = sm[kAsyncWords - 1 - i];
}

// 7 mma_s8: a warp per 16x8x32 tile (n tiles), D = A (16x32, s8) * B
// (32x8, s8) in s32 with mma.sync.m16n8k32; A, B, D row-major int64 per
// tile. Fragment layout of the PTX ISA (groupID = lane / 4, tig = lane % 4):
//   A reg r byte j: row groupID + 8 (r & 1), col 4 tig + j + 16 (r >> 1)
//   B reg r byte j: row 4 tig + j + 16 r, col groupID
//   D reg r: row groupID + 8 (r >> 1), col 2 tig + (r & 1)
__device__ void mma_s8(const Role& r, int b) {
  const int tile = b * (kThreads / 32) + threadIdx.x / 32;
  if (tile >= r.n) return;             // a whole warp
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int64_t* a = r.in0 + (long)tile * 16 * 32;
  const int64_t* bm = r.in1 + (long)tile * 32 * 8;
  int64_t* d = r.out + (long)tile * 16 * 8;
  uint32_t ra[4], rb[2];
  for (int k = 0; k < 4; ++k) {
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
      const int row = g + 8 * (k & 1), col = 4 * tig + j + 16 * (k >> 1);
      w |= ((uint32_t)a[row * 32 + col] & 0xFFu) << (8 * j);
    }
    ra[k] = w;
  }
  for (int k = 0; k < 2; ++k) {
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
      const int row = 4 * tig + j + 16 * k;
      w |= ((uint32_t)bm[row * 8 + g] & 0xFFu) << (8 * j);
    }
    rb[k] = w;
  }
  int32_t rd[4] = {0, 0, 0, 0};
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(rd[0]), "=r"(rd[1]), "=r"(rd[2]), "=r"(rd[3])
      : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "r"(rb[0]),
        "r"(rb[1]), "r"(rd[0]), "r"(rd[1]), "r"(rd[2]), "r"(rd[3]));
  for (int k = 0; k < 4; ++k)
    d[(g + 8 * (k >> 1)) * 8 + 2 * tig + (k & 1)] = rd[k];
}

// 8 cluster_dsmem: out's chunk c of kChunk words is in's chunk c ^ 1. A
// cluster of two holds 2 kThreads words; block r of it puts the chunks of
// parity r in shared memory, and after a cluster barrier reads the other
// parity's chunk at the same place in its neighbour's, through distributed
// shared memory. Both blocks of a pair are of this role, and every thread
// reaches both barriers.
__device__ void cluster_dsmem(const Role& r, int b, int64_t* sm) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const long i = (long)(b & ~1) * kThreads +
                 (2 * (t / kChunk) + (b & 1)) * kChunk + t % kChunk;
  const bool live = i < r.n;
  sm[threadIdx.x] = live ? r.in0[i] : 0;
  cluster.sync();
  const int64_t* other =
      cluster.map_shared_rank(sm, (int)cluster.block_rank() ^ 1);
  if (live) r.out[i] = other[threadIdx.x];
  cluster.sync();  // the neighbour may not exit while it is being read
}

// Dynamic shared bytes a block of this role uses
int smem_bytes(int id, int n) {
  switch (id) {
    case kSmem: return n * (int)sizeof(uint32_t);
    case kCpAsync: return kAsyncWords * (int)sizeof(int64_t);
    case kBulkCopy: return kAsyncWords * (int)sizeof(int64_t) + 8;
    case kCluster: return kThreads * (int)sizeof(int64_t);
    default: return 0;
  }
}

}  // namespace probe

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(probe::kThreads)
    probe_battery_kernel(const __grid_constant__ probe::Plan p) {
  using namespace probe;
  extern __shared__ __align__(128) unsigned char dyn[];
  int k = 0;
  while (k + 1 < p.count && (int)blockIdx.x >= p.role[k + 1].first) ++k;
  const Role r = p.role[k];              // in registers, not param space
  const int b = (int)blockIdx.x - r.first;
  switch (r.id) {
    case kBasic:
    case kRefused: basic(r, b); break;
    case kMulWide: mul_wide(r, b); break;
    case kSmem: smem_large(r, b, reinterpret_cast<uint32_t*>(dyn)); break;
    case kShflCarry: shfl_carry(r, b); break;
    case kCpAsync: cp_async(r, b, reinterpret_cast<int64_t*>(dyn)); break;
    case kBulkCopy: bulk_copy(r, b, reinterpret_cast<int64_t*>(dyn)); break;
    case kMmaS8: mma_s8(r, b); break;
    case kCluster: cluster_dsmem(r, b, reinterpret_cast<int64_t*>(dyn)); break;
  }
}

// Check the table (roles back to back from block 0, each on an even block
// with an even count; a fixed size where the body has one), size the
// shared buffer and launch. threads: kThreads, or refused_launch's 2048.
static int launch(const probe::Plan& p, int threads, cudaStream_t stream) {
  using namespace probe;
  if (p.count < 1 || p.count > kMaxRoles) return (int)cudaErrorInvalidValue;
  int blocks = 0, bytes = 0;
  for (int k = 0; k < p.count; ++k) {
    const Role& r = p.role[k];
    if (r.id < 0 || r.id >= kIds || r.first != blocks || r.blocks < 2 ||
        r.blocks % 2 || r.n < 0)
      return (int)cudaErrorInvalidValue;
    if ((r.id == kCpAsync || r.id == kBulkCopy) && r.n != kAsyncWords)
      return (int)cudaErrorInvalidValue;
    if (r.id == kCluster && r.n % (2 * kThreads))
      return (int)cudaErrorInvalidValue;
    blocks += r.blocks;
    const int need = smem_bytes(r.id, r.n);
    bytes = need > bytes ? need : bytes;
  }
  cudaError_t rc = cudaFuncSetAttribute(
      probe_battery_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (rc != cudaSuccess) return (int)rc;
  probe_battery_kernel<<<blocks, threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// One probe, its table's one role at block 0
extern "C" int pzk_probe(int id, const int64_t* in0, const int64_t* in1,
                         int64_t* out, int n, int blocks,
                         cudaStream_t stream) {
  probe::Plan p{};
  p.count = 1;
  p.role[0] = {in0, in1, out, id, n, 0, blocks};
  return launch(p, id == probe::kRefused ? 2048 : probe::kThreads, stream);
}

// count roles in one launch: role k runs probe id[k] on in0[k], in1[k] (or
// null), out[k] with n[k] over blocks[k] blocks from first[k]; host arrays,
// read here.
extern "C" int pzk_probe_battery(int count, const int* id,
                                 const int64_t* const* in0,
                                 const int64_t* const* in1,
                                 int64_t* const* out, const int* n,
                                 const int* first, const int* blocks,
                                 cudaStream_t stream) {
  if (count < 1 || count > probe::kMaxRoles)
    return (int)cudaErrorInvalidValue;
  probe::Plan p{};
  p.count = count;
  for (int k = 0; k < count; ++k) {
    if (id[k] == probe::kRefused) return (int)cudaErrorInvalidValue;
    p.role[k] = {in0[k], in1[k], out[k], id[k], n[k], first[k], blocks[k]};
  }
  return launch(p, probe::kThreads, stream);
}
