// Bitonic sort of (rows, c) tiles by row 0, repeated: the probe P1.
//
// Replaces the Pallas kernel `kernel` of scripts/bench_roll.py:32 (called
// at :52), which loads one (R, C) f32 buffer into VMEM, sorts it by row 0
// with the full bitonic network of C (every column moves with its key;
// partners by pltpu.roll) once per grid step for REPS = 200 steps, and
// writes it back. Here one block takes one tile of a (T, rows, c) batch.
// T = 1 and reps = 200 computes what the Pallas kernel computes; T = 8160
// and reps = 1 is the 1080p frame's tile count, which the JAX script only
// projects from one buffer.
//
// The design (csrc/bitonic.cuh): the network runs on (key, column index)
// pairs, E a thread in registers (E = 8 up to c = 8192: 256 threads at c =
// 2048), and the rows move once at the end. Of the 66 stages of c = 2048,
// 30 pair columns inside a thread, 30 inside a warp by shuffles, and 6 (j
// >= 256) go through shared memory. `reps` runs of the network carry the
// index across, so the permutation composes and the rows still move once.
// Row 0 is written from the sorted keys, which are the input's bits. Rows
// 1 .. rows-1 come in by bulk copies (csrc/tma.cuh) into a ring of NBUF
// row slots, the first NBUF issued before the network starts, so their
// loads overlap it; each row is then gathered from its slot by the final
// index and stored with 16-byte writes, and its slot takes the row NBUF
// further on. At c = 2048 a block takes 48 KB (16 KB of pairs, 32 KB of
// ring) instead of the whole 128 KB tile, so four blocks share an SM.
//
// What bounds it on the H100: at T = 8160 the bytes, each tile read and
// written once (2 x 128 KB at rows 16, c 2048: 0.64 ms at 3.35 TB/s),
// against the network's operations (the take test and the pair's move per
// column and stage) and the gather; at T = 1 a single SM, so neither: the
// latency of the shuffles and of the shared stages' barriers.

#include <cuda_runtime.h>

#include "bitonic.cuh"
#include "smem.cuh"
#include "tma.cuh"

namespace {

constexpr int NBUF = 4;          // payload rows in flight, at most
constexpr int MAX_THREADS = 1024;

// Columns a thread holds at width c: 8 up to c = 8192, 16 at 16384 (wider
// tiles' pairs do not fit a block's shared memory).
int elems_of(int c) { return c <= 8 ? c : (c / 8 <= MAX_THREADS ? 8 : c / MAX_THREADS); }

// The lane-iota network, its want_min split by where its bits live. For a
// column e = e0 + i of a thread (e0 a multiple of E, i < E) in stage (k, j),
// want_min(e) = ((e & j) == 0) == ((e & k) == 0): with j < E the first
// test is i's, known at compile time; with k >= E the second is e0's, one
// value for the whole thread. So the stages inside a thread are unrolled
// with J (and K < E) as constants, and a stage across threads computes
// one want_min for all E columns: the same bits, fewer operations.

// In-thread stage J of a merge whose direction bit is K's (K < E, per
// column) or, for K = 0, `asc` = (e0 & k) == 0 for the whole thread.
template <int E, int K, int J>
__device__ __forceinline__ void iota_merge(float (&key)[E], int (&idx)[E], bool asc) {
  bool want[E];
#pragma unroll
  for (int i = 0; i < E; ++i) want[i] = ((i & J) == 0) == (K ? (i & K) == 0 : asc);
  bitonic::local_stage<E, J>(key, idx, want);
  if constexpr (J > 1) iota_merge<E, K, J / 2>(key, idx, asc);
}

// The merges k = K, 2K, ..., E, all inside the thread.
template <int E, int K>
__device__ __forceinline__ void iota_sort_in_thread(float (&key)[E], int (&idx)[E], int e0) {
  if constexpr (K <= E) {
    iota_merge<E, (K < E ? K : 0), K / 2>(key, idx, (e0 & K) == 0);
    iota_sort_in_thread<E, 2 * K>(key, idx, e0);
  }
}

// The full network of c columns over the thread's E (key, index) pairs.
template <int E>
__device__ __forceinline__ void iota_network(float (&key)[E], int (&idx)[E],
                                             bitonic::KeyIdx* pairs, int e0, int c,
                                             unsigned mask) {
  iota_sort_in_thread<E, 2>(key, idx, e0);
  bool want[E];
  for (int k = 2 * E; k <= c; k <<= 1) {
    const bool asc = (e0 & k) == 0;
    for (int j = k >> 1; j >= E; j >>= 1) {
      const bool w = ((e0 & j) == 0) == asc;
#pragma unroll
      for (int i = 0; i < E; ++i) want[i] = w;
      if (j < 32 * E)
        bitonic::shuffle_stage<E>(key, idx, want, j / E, mask);
      else
        bitonic::shared_stage<E>(pairs, key, idx, want, e0, j, true);
    }
    iota_merge<E, 0, E / 2>(key, idx, asc);
  }
}

template <int E>
__global__ void __launch_bounds__(MAX_THREADS)
bench_roll_kernel(const float* __restrict__ x, int rows, int c, int reps, int nbuf,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[NBUF];
  const bool exchange = c > 32 * E;   // some stages cross warps
  bitonic::KeyIdx* pairs = reinterpret_cast<bitonic::KeyIdx*>(smem);
  float* ring = reinterpret_cast<float*>(smem + (exchange ? (size_t)c * sizeof(bitonic::KeyIdx)
                                                          : 0));
  const size_t n = (size_t)rows * c;
  const float* tile = x + blockIdx.x * n;
  float* dst = out + blockIdx.x * n;
  const int e0 = threadIdx.x * E;
  const unsigned mask = blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  // Bulk copies need 16-byte rows; narrower tiles (c = 2) load each row by
  // hand into slot 0.
  const bool bulk = c % 4 == 0;
  const int payload = rows - 1;

  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < nbuf; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < nbuf && s < payload; ++s) {
      mbar_expect_tx(&bars[s], (uint32_t)c * sizeof(float));
      bulk_load(ring + (size_t)s * c, tile + (size_t)(1 + s) * c, (uint32_t)c * sizeof(float),
                &bars[s]);
    }
  }

  float key[E];
  int idx[E];
  bitonic::load_row<E>(key, tile + e0);
#pragma unroll
  for (int i = 0; i < E; ++i) idx[i] = e0 + i;
  for (int rep = 0; rep < reps; ++rep) iota_network<E>(key, idx, pairs, e0, c, mask);
  bitonic::store_row<E>(dst + e0, key);   // row 0: the sorted keys, the input's bits

  __syncthreads();  // the barriers' initialisation is visible to every waiting thread
  float v[E];
  for (int r = 0; r < payload; ++r) {
    const int s = bulk ? r % nbuf : 0;
    const float* slot = ring + (size_t)s * c;
    if (bulk) {
      mbar_wait(&bars[s], (uint32_t)(r / nbuf) & 1u);
    } else {
      bitonic::copy_block(ring, tile + (size_t)(1 + r) * c, c);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = slot[idx[i]];
    bitonic::store_row<E>(dst + (size_t)(1 + r) * c + e0, v);
    __syncthreads();  // every thread has read the slot
    if (bulk && threadIdx.x == 0 && r + nbuf < payload) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect_tx(&bars[s], (uint32_t)c * sizeof(float));
      bulk_load(ring + (size_t)s * c, tile + (size_t)(1 + r + nbuf) * c,
                (uint32_t)c * sizeof(float), &bars[s]);
    }
  }
}

const void* kernel_of(int e) {
  switch (e) {
    case 2: return (const void*)bench_roll_kernel<2>;
    case 4: return (const void*)bench_roll_kernel<4>;
    case 8: return (const void*)bench_roll_kernel<8>;
    case 16: return (const void*)bench_roll_kernel<16>;
    default: return nullptr;
  }
}

// Shared memory of a block at width c with `nbuf` ring slots.
size_t smem_bytes(int c, int nbuf) {
  const size_t exchange = c > 32 * elems_of(c) ? (size_t)c * sizeof(bitonic::KeyIdx) : 0;
  return exchange + (size_t)nbuf * c * sizeof(float);
}

}  // namespace

// The most dynamic shared memory one block may take on the current device.
extern "C" int bench_roll_smem_limit() {
  return dynamic_smem_limit(kernel_of(8));
}

// The least dynamic shared memory a block of (rows, c) tiles takes: the
// pairs' exchange and one ring slot (none for one row).
extern "C" int bench_roll_smem_need(int rows, int c) {
  return (int)smem_bytes(c, rows > 1 ? 1 : 0);
}

// Sort each of `tiles` (rows, c) tiles of x by row 0, `reps` times, into
// out, on `stream`; c a power of two, 2 <= c <= 16384. Returns
// cudaGetLastError().
extern "C" int bench_roll(const float* x, int tiles, int rows, int c, int reps, float* out,
                          void* stream) {
  if (c < 2 || c > 16 * MAX_THREADS || (c & (c - 1)) != 0 || rows < 1 || tiles < 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const int e = elems_of(c);
  const void* kernel = kernel_of(e);
  const int limit = bench_roll_smem_limit();
  int nbuf = rows - 1 < NBUF ? rows - 1 : NBUF;
  if (c % 4 != 0 && nbuf > 1) nbuf = 1;  // rows loaded by hand use slot 0 alone
  while (nbuf > 1 && smem_bytes(c, nbuf) > (size_t)limit) --nbuf;
  const size_t smem = smem_bytes(c, nbuf);
  if (kernel == nullptr || smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    void* args[] = {&x, &rows, &c, &reps, &nbuf, &out};
    err = cudaLaunchKernel(kernel, dim3(tiles), dim3(c / e), args, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
