// K9: a battery of tiny kernels, each probing one thing that the port's
// kernels rely on now or that their later redesigns will need, checked bit
// for bit against a plain version by ops/cuda_probe.py. Replaces the TPU
// battery run_kernel of tools/probe_mosaic.py, which probed what the Pallas
// TPU compiler accepts. Each probe moves a few kilobytes (the shared memory
// probe 400 KB) and does a few thousand operations: every one is bound by
// launch latency, and the battery exists to fail loudly, not to be fast.
//
// One C entry point, pzk_probe(id, in0, in1, out, n, stream); the ids are
// the order of ops/cuda_probe.KERNEL_PROBES. All data crosses as int64.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// 0 basic: int64 limb I/O, out = (a * a + (a >> 3)) & 0xFFFF
__global__ void basic_kernel(const int64_t* __restrict__ a,
                             int64_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = (uint32_t)a[i];
  out[i] = (x * x + (x >> 3)) & 0xFFFFu;
}

// 1 mul_wide: out[i] = low 32 bits of the 64-bit product a*b,
// out[n + i] = __umulhi(a, b)
__global__ void mul_wide_kernel(const int64_t* __restrict__ a,
                                const int64_t* __restrict__ b,
                                int64_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = (uint32_t)a[i], y = (uint32_t)b[i];
  out[i] = (uint32_t)((uint64_t)x * y);
  out[n + i] = __umulhi(x, y);
}

// 2 smem_dynamic_large: n 32-bit words through dynamic shared memory
// (n * 4 bytes, above the 48 KB static limit), read back reversed
__global__ void smem_kernel(const int64_t* __restrict__ a,
                            int64_t* __restrict__ out, int n) {
  extern __shared__ uint32_t sm[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) sm[i] = (uint32_t)a[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = sm[n - 1 - i];
}

// 4 shfl_carry: 16 threads hold the 16 limbs (< 2^17) of one number and
// propagate carries with __shfl_up_sync: out = the number mod 2^256 in
// 16-bit limbs. After the first round every carry is 0 or 1, and a run of
// carries moves up one limb a round, so 17 rounds resolve all of them.
__global__ void shfl_carry_kernel(const int64_t* __restrict__ a,
                                  int64_t* __restrict__ out, int B) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int elem = t / 16, limb = t % 16;
  const bool live = elem < B;
  uint32_t v = live ? (uint32_t)a[(long)limb * B + elem] : 0u;
  for (int r = 0; r < 17; ++r) {
    const uint32_t carry = v >> 16;
    const uint32_t in = __shfl_up_sync(0xFFFFFFFFu, carry, 1, 16);
    v = (v & 0xFFFFu) + (limb == 0 ? 0u : in);
  }
  if (live) out[(long)limb * B + elem] = v;
}

// 5 cp_async: one block copies n int64 (16 bytes a copy) from global to
// shared memory with cp.async, waits, and writes them rotated by one
constexpr int kAsyncWords = 2048;

__global__ void cp_async_kernel(const int64_t* __restrict__ a,
                                int64_t* __restrict__ out) {
  __shared__ alignas(16) int64_t sm[kAsyncWords];
  for (int i = 2 * threadIdx.x; i < kAsyncWords; i += 2 * blockDim.x) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(sm + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(a + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int i = threadIdx.x; i < kAsyncWords; i += blockDim.x)
    out[i] = sm[(i + 1) % kAsyncWords];
}

// 6 bulk_copy_mbarrier: one thread issues a 1-D cp.async.bulk of the whole
// buffer, which completes on an mbarrier (transaction bytes); every thread
// waits on the barrier's phase and writes the buffer reversed
__global__ void bulk_copy_kernel(const int64_t* __restrict__ a,
                                 int64_t* __restrict__ out) {
  __shared__ alignas(128) int64_t sm[kAsyncWords];
  __shared__ alignas(8) uint64_t bar;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
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
        "l"(a), "r"(bytes), "r"(bar_addr)
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
  for (int i = threadIdx.x; i < kAsyncWords; i += blockDim.x)
    out[i] = sm[kAsyncWords - 1 - i];
}

// 7 mma_s8: one warp per 16x8x32 tile, D = A (16x32, s8) * B (32x8, s8) in
// s32 with mma.sync.m16n8k32; A, B, D row-major int64 per tile. Fragment
// layout of the PTX ISA (groupID = lane / 4, tig = lane % 4):
//   A reg r byte j: row groupID + 8 (r & 1), col 4 tig + j + 16 (r >> 1)
//   B reg r byte j: row 4 tig + j + 16 r, col groupID
//   D reg r: row groupID + 8 (r >> 1), col 2 tig + (r & 1)
__global__ void mma_s8_kernel(const int64_t* __restrict__ A,
                              const int64_t* __restrict__ Bm,
                              int64_t* __restrict__ D) {
  const int lane = threadIdx.x, g = lane / 4, tig = lane % 4;
  const int64_t* a = A + (long)blockIdx.x * 16 * 32;
  const int64_t* b = Bm + (long)blockIdx.x * 32 * 8;
  int64_t* d = D + (long)blockIdx.x * 16 * 8;
  uint32_t ra[4], rb[2];
  for (int r = 0; r < 4; ++r) {
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
      const int row = g + 8 * (r & 1), col = 4 * tig + j + 16 * (r >> 1);
      w |= ((uint32_t)a[row * 32 + col] & 0xFFu) << (8 * j);
    }
    ra[r] = w;
  }
  for (int r = 0; r < 2; ++r) {
    uint32_t w = 0;
    for (int j = 0; j < 4; ++j) {
      const int row = 4 * tig + j + 16 * r;
      w |= ((uint32_t)b[row * 8 + g] & 0xFFu) << (8 * j);
    }
    rb[r] = w;
  }
  int32_t rd[4] = {0, 0, 0, 0};
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(rd[0]), "=r"(rd[1]), "=r"(rd[2]), "=r"(rd[3])
      : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "r"(rb[0]),
        "r"(rb[1]), "r"(rd[0]), "r"(rd[1]), "r"(rd[2]), "r"(rd[3]));
  for (int r = 0; r < 4; ++r)
    d[(g + 8 * (r >> 1)) * 8 + 2 * tig + (r & 1)] = rd[r];
}

// 8 cluster_dsmem: clusters of two blocks; each block puts its chunk of
// blockDim.x words in shared memory, and after a cluster barrier reads its
// neighbour's chunk through distributed shared memory
__global__ void __cluster_dims__(2, 1, 1)
    cluster_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out) {
  __shared__ int64_t sm[128];
  cg::cluster_group cluster = cg::this_cluster();
  const long base = (long)blockIdx.x * blockDim.x;
  sm[threadIdx.x] = a[base + threadIdx.x];
  cluster.sync();
  const int64_t* other =
      cluster.map_shared_rank(sm, (int)cluster.block_rank() ^ 1);
  out[base + threadIdx.x] = other[threadIdx.x];
  cluster.sync();  // the neighbour may not exit while it is being read
}

extern "C" int pzk_probe(int id, const int64_t* in0, const int64_t* in1,
                         int64_t* out, int n, cudaStream_t stream) {
  switch (id) {
    case 0:
      basic_kernel<<<(n + 127) / 128, 128, 0, stream>>>(in0, out, n);
      break;
    case 1:
      mul_wide_kernel<<<(n + 127) / 128, 128, 0, stream>>>(in0, in1, out, n);
      break;
    case 2: {
      const int bytes = n * (int)sizeof(uint32_t);
      cudaError_t rc = cudaFuncSetAttribute(
          smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (rc != cudaSuccess) return (int)rc;
      smem_kernel<<<1, 1024, bytes, stream>>>(in0, out, n);
      break;
    }
    case 3:  // refused_launch: more threads per block than the card allows
      basic_kernel<<<1, 2048, 0, stream>>>(in0, out, n);
      break;
    case 4:
      shfl_carry_kernel<<<(16 * n + 127) / 128, 128, 0, stream>>>(in0, out,
                                                                  n);
      break;
    case 5:
      if (n != kAsyncWords) return (int)cudaErrorInvalidValue;
      cp_async_kernel<<<1, 128, 0, stream>>>(in0, out);
      break;
    case 6:
      if (n != kAsyncWords) return (int)cudaErrorInvalidValue;
      bulk_copy_kernel<<<1, 128, 0, stream>>>(in0, out);
      break;
    case 7:
      mma_s8_kernel<<<n, 32, 0, stream>>>(in0, in1, out);
      break;
    case 8:
      if (n % 256) return (int)cudaErrorInvalidValue;
      cluster_kernel<<<n / 128, 128, 0, stream>>>(in0, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
