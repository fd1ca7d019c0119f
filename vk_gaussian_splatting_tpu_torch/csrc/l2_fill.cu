// What L2 can deliver into shared memory on this card: the measured ceiling
// of the copy probe P2 (csrc/bench_radix_ab.cu), by three means.
//
// The work is P2's: `copies` copies of `copy_blocks` (16, 128) f32 blocks
// (8 KB each) at block offsets c % 1024 of a source whose first 8 MB the
// 50 MB L2 holds after the first pass; block b of the grid takes copies
// [b * copies / grid, (b + 1) * copies / grid). Every byte lands in shared
// memory:
//   l2_fill_bulk:    bulk copies (cp.async.bulk) on mbarriers, `depth`
//                    pieces of `piece_blocks` blocks in flight a block,
//                    issued `lanes` at a time by lanes of one warp;
//   l2_fill_vector:  16-byte loads (L2 only, ld.global.cg) by every thread,
//                    U a thread in flight, stored to shared memory;
//   l2_fill_cpasync: 16-byte cp.async copies, U a thread a stage, `stages`
//                    stages in flight.
// Each pads its shared memory so that at most `per_sm` blocks fit an SM.
// Nothing is read back: this is a measurement, not a kernel of the port.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"
#include "tma.cuh"

namespace {

constexpr int BLOCK_BYTES = 16 * 128 * 4;
constexpr int OFFSET_CYCLE = 1024;
constexpr int SM_SHARED = 233472;      // an SM's shared memory, 228 KB
constexpr int BLOCK_RESERVED = 1024;   // shared memory the system keeps per block
constexpr int MAX_DEPTH = 32;

__device__ __forceinline__ void copy_range(int copies, int& c0, int& c1) {
  c0 = (int)((long long)blockIdx.x * copies / gridDim.x);
  c1 = (int)((long long)(blockIdx.x + 1) * copies / gridDim.x);
}

// lanes issue `lanes` consecutive pieces at a time, piece k by lane
// k % lanes into slot k % depth (lanes <= depth)
__global__ void __launch_bounds__(32) bulk_kernel(const unsigned char* __restrict__ src, int copies,
                                                   int copy_blocks, int piece_blocks, int depth,
                                                   int lanes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[MAX_DEPTH];
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const int lane = threadIdx.x;
  if (lane >= lanes) return;
  int c0, c1;
  copy_range(copies, c0, c1);
  const int ppc = copy_blocks / piece_blocks;
  const uint32_t piece_bytes = (uint32_t)piece_blocks * BLOCK_BYTES;
  const int n = (c1 - c0) * ppc;
  int c = c0, p = lane, slot = lane;
  uint32_t round = 0;
  for (; p >= ppc; p -= ppc) ++c;
  for (int k = lane; k < n; k += lanes) {
    if (round > 0) mbar_wait(&bars[slot], (round - 1) & 1u);
    mbar_expect_tx(&bars[slot], piece_bytes);
    bulk_load(ring + (size_t)slot * piece_bytes,
              src + ((size_t)(c % OFFSET_CYCLE) + (size_t)p * piece_blocks) * BLOCK_BYTES,
              piece_bytes, &bars[slot]);
    for (p += lanes; p >= ppc; p -= ppc) ++c;
    slot += lanes;
    if (slot >= depth) {
      slot -= depth;
      ++round;
    }
  }
  // wait for this lane's last piece in each of its slots
  for (int k = n - 1; k >= 0 && k >= n - depth; --k)
    if (k % lanes == lane) mbar_wait(&bars[k % depth], (uint32_t)(k / depth) & 1u);
}

template <int U>
__global__ void vector_kernel(const unsigned char* __restrict__ src, int copies, int copy_blocks) {
  extern __shared__ __align__(128) unsigned char buf[];
  int c0, c1;
  copy_range(copies, c0, c1);
  const int chunk = blockDim.x * U * 16;
  const int chunks = copy_blocks * BLOCK_BYTES / chunk;
  for (int c = c0; c < c1; ++c) {
    const unsigned char* base = src + (size_t)(c % OFFSET_CYCLE) * BLOCK_BYTES;
    for (int t = 0; t < chunks; ++t) {
      const unsigned char* g = base + (size_t)t * chunk;
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = __ldcg(reinterpret_cast<const uint4*>(g + ((size_t)u * blockDim.x + threadIdx.x) * 16));
#pragma unroll
      for (int u = 0; u < U; ++u)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                         smem_addr(buf + ((size_t)u * blockDim.x + threadIdx.x) * 16)),
                     "r"(v[u].x), "r"(v[u].y), "r"(v[u].z), "r"(v[u].w)
                     : "memory");
    }
  }
}

template <int U, int STAGES>
__global__ void cpasync_kernel(const unsigned char* __restrict__ src, int copies, int copy_blocks) {
  extern __shared__ __align__(128) unsigned char buf[];
  int c0, c1;
  copy_range(copies, c0, c1);
  const int chunk = blockDim.x * U * 16;
  const int chunks = copy_blocks * BLOCK_BYTES / chunk;
  int stage = 0;
  for (int c = c0; c < c1; ++c) {
    const unsigned char* base = src + (size_t)(c % OFFSET_CYCLE) * BLOCK_BYTES;
    for (int t = 0; t < chunks; ++t) {
      const unsigned char* g = base + (size_t)t * chunk;
      unsigned char* s = buf + (size_t)stage * chunk;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t o = ((size_t)u * blockDim.x + threadIdx.x) * 16;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(s + o)), "l"(g + o)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 1) : "memory");
      if (++stage == STAGES) stage = 0;
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// `need` bytes of shared memory, padded so that at most per_sm blocks fit
// an SM; launches `kernel` or returns the error
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, int threads, int per_sm, int need, void* stream,
           Args... args) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (err != cudaSuccess) return (int)err;
  const int pad = SM_SHARED / per_sm - BLOCK_RESERVED - (int)attr.sharedSizeBytes;
  const int smem = need > pad ? need : pad;
  if (per_sm < 1 || need > pad || smem > dynamic_smem_limit((const void*)kernel))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// src: at least 1023 + copy_blocks blocks of 8 KB. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a configuration that does not fit).
extern "C" int l2_fill_bulk(const void* src, int grid, int per_sm, int copies, int copy_blocks,
                            int piece_blocks, int depth, int lanes, void* stream) {
  if (piece_blocks < 1 || copy_blocks % piece_blocks || depth < 1 || depth > MAX_DEPTH ||
      lanes < 1 || lanes > depth || lanes > 32)
    return (int)cudaErrorInvalidValue;
  return launch(bulk_kernel, grid, 32, per_sm, depth * piece_blocks * BLOCK_BYTES, stream,
                (const unsigned char*)src, copies, copy_blocks, piece_blocks, depth, lanes);
}

// threads * u * 16 must divide a copy; u is 4 or 8
extern "C" int l2_fill_vector(const void* src, int grid, int per_sm, int copies, int copy_blocks,
                              int threads, int u, void* stream) {
  if ((copy_blocks * BLOCK_BYTES) % (threads * u * 16)) return (int)cudaErrorInvalidValue;
  const int need = threads * u * 16;
  const unsigned char* s = (const unsigned char*)src;
  if (u == 4) return launch(vector_kernel<4>, grid, threads, per_sm, need, stream, s, copies, copy_blocks);
  if (u == 8) return launch(vector_kernel<8>, grid, threads, per_sm, need, stream, s, copies, copy_blocks);
  return (int)cudaErrorInvalidValue;
}

// (u, stages) is (2, 2), (4, 2) or (2, 4); threads * u * 16 must divide a copy
extern "C" int l2_fill_cpasync(const void* src, int grid, int per_sm, int copies, int copy_blocks,
                               int threads, int u, int stages, void* stream) {
  if ((copy_blocks * BLOCK_BYTES) % (threads * u * 16)) return (int)cudaErrorInvalidValue;
  const int need = threads * u * 16 * stages;
  const unsigned char* s = (const unsigned char*)src;
  if (u == 2 && stages == 2)
    return launch(cpasync_kernel<2, 2>, grid, threads, per_sm, need, stream, s, copies, copy_blocks);
  if (u == 4 && stages == 2)
    return launch(cpasync_kernel<4, 2>, grid, threads, per_sm, need, stream, s, copies, copy_blocks);
  if (u == 2 && stages == 4)
    return launch(cpasync_kernel<2, 4>, grid, threads, per_sm, need, stream, s, copies, copy_blocks);
  return (int)cudaErrorInvalidValue;
}
