// Bitonic sort stages over tiles, in three mask and layout styles: the
// probe P3.
//
// Replaces the Pallas kernel of scripts/bench_sort_stage.py:115
// (`make_call`, called at :132), which loads TPT tiles of (ROWS, 1024) f32
// into VMEM and runs N_STAGES bitonic compare-exchange stages over each
// (the full schedule of 1024 cut short or repeated), keyed by row ROWS - 1,
// every column moving with its key; each of its 4096 grid steps re-sorts
// the same block on one core. Here `blocks` blocks run at once, each doing
// all the work of the tiles, and block 0 writes the result: "ns per stage
// per tile" is then the whole card's throughput.
//
// The design (csrc/bitonic.cuh): every variant runs the stages on (key,
// column index) pairs and then permutes the rows once. The JAX variants
// keep their names, now asked of the pair network:
//
// - lane-iota: the tiles' pairs in shared memory, one pass per stage (a
//   thread per pair of columns, one barrier), want_min by index math;
// - lane-const: the same pass, want_min from the odd rows of the caller's
//   (2S, 1024) f32 table, read through L1 from device memory (at S = 55 it
//   is 450 KB; each stage reads one 4 KB row). The even rows (is_lo) pick
//   the partner in the JAX stage; here the partner is e ^ j by
//   construction, which is what is_lo selects in every table the probe
//   builds (probes/bench_sort_stage.np_masks);
// - sub8, the counterpart of "partners inside one vreg": a thread holds
//   four consecutive columns' pairs of a tile in registers (256 threads a
//   tile, two tiles at once); partners with j < 4 lie in the thread, j <
//   128 in the warp (__shfl_xor_sync), and only j >= 128 goes through
//   shared memory. want_min comes from the table, as in lane-const.
//
// Then each block permutes every row of its tiles, out[t, r, e] = x[t, r,
// idx_t(e)], four rows at a time: the rows are copied into shared memory,
// gathered by the final index into a second buffer there, and block 0
// stores that buffer. The barrier between the gather and the store keeps
// the gather in every block. A block takes tiles x 8 KB of pairs and 32 KB
// of rows (48 KB at the default 2 tiles), so four blocks of 512 threads
// share an SM.
//
// What bounds it on the H100: the operations of the network, the take
// test and the pair's move per column and stage (the bytes, a 256 KB input
// and output and the table, are nothing at 4096 blocks), against the
// latency of shared memory and barriers: a lane stage is one pass over the
// pairs in shared memory and one barrier; sub8's are registers, shuffles,
// or two barriers.

#include <cuda_runtime.h>

#include "bitonic.cuh"
#include "smem.cuh"

namespace {

using bitonic::KeyIdx;

// Where a lane stage's want_min comes from: index math on the column
// ("lane-iota"), or a row of the caller's table ("lane-const").
enum Masks { kIota = 0, kConst = 1 };

constexpr int C = 1024;            // columns of a tile (the JAX probe's C)
constexpr int HALF_SHIFT = 9;      // log2(C / 2)
constexpr int THREADS = 512;
constexpr int CHUNK = 4;           // rows permuted at once
constexpr int SUB8_E = 4;          // columns of a tile a sub8 thread holds
constexpr int SUB8_GROUP = C / SUB8_E;          // threads on one tile
constexpr int SUB8_TILES = THREADS / SUB8_GROUP;  // tiles in registers at once

// The shared memory of a block: the pairs of every tile, then two CHUNK-row
// buffers.
size_t smem_bytes(int tiles) {
  return (size_t)tiles * C * sizeof(KeyIdx) + 2 * (size_t)CHUNK * C * sizeof(float);
}

// Every row of the `tiles` tiles of x, permuted by its tile's final index
// (pairs[t * C + e].idx), into shared memory; block 0 stores them to out.
__device__ void permute_rows(const float* __restrict__ x, const KeyIdx* pairs, int tiles,
                             int rows, float* in, float* perm, float* __restrict__ out) {
  const int units = tiles * rows;   // rows of all tiles, contiguous in x
  for (int u0 = 0; u0 < units; u0 += CHUNK) {
    const int n = min(CHUNK, units - u0);
    bitonic::copy_block(in, x + (size_t)u0 * C, n * C);
    __syncthreads();
    for (int v = threadIdx.x; v < n * C; v += blockDim.x) {
      const int u = v / C, e = v % C;
      perm[v] = in[u * C + pairs[(u0 + u) / rows * C + e].idx];
    }
    __syncthreads();
    if (blockIdx.x == 0) bitonic::copy_block(out + (size_t)u0 * C, perm, n * C);
  }
}

// The lane variants: each tile's pairs in shared memory, one pass per stage.
template <int MASKS>
__global__ void __launch_bounds__(THREADS)
sort_stage_lane_kernel(const float* __restrict__ x, const float* __restrict__ masks,
                       const int* __restrict__ sched, int n_stages, int tiles, int rows,
                       int key_row, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  KeyIdx* pairs = reinterpret_cast<KeyIdx*>(smem);
  float* in = reinterpret_cast<float*>(pairs + (size_t)tiles * C);
  float* perm = in + CHUNK * C;
  for (int v = threadIdx.x; v < tiles * C; v += blockDim.x)
    pairs[v] = KeyIdx{__ldg(x + ((size_t)(v / C) * rows + key_row) * C + v % C), v % C};
  __syncthreads();
  const int n_pairs = tiles << HALF_SHIFT;
  for (int st = 0; st < n_stages; ++st) {
    const int k = __ldg(sched + 2 * st), j = __ldg(sched + 2 * st + 1);
    const float* want_min_row = masks + (size_t)(2 * st + 1) * C;
    for (int q = threadIdx.x; q < n_pairs; q += blockDim.x) {
      const int lo = bitonic::pair_lo(q & ((1 << HALF_SHIFT) - 1), j), hi = lo | j;
      KeyIdx* tile = pairs + (size_t)(q >> HALF_SHIFT) * C;
      const KeyIdx a = tile[lo], b = tile[hi];
      bool w_lo, w_hi;
      if (MASKS == kIota) {
        w_lo = bitonic::iota_want_min(lo, k, j);
        w_hi = bitonic::iota_want_min(hi, k, j);
      } else {
        w_lo = __ldg(want_min_row + lo) > 0.5f;
        w_hi = __ldg(want_min_row + hi) > 0.5f;
      }
      if (bitonic::takes(w_lo, a.key, b.key)) tile[lo] = b;
      if (bitonic::takes(w_hi, b.key, a.key)) tile[hi] = a;
    }
    __syncthreads();
  }
  permute_rows(x, pairs, tiles, rows, in, perm, out);
}

// sub8: SUB8_E columns' pairs a thread in registers, SUB8_TILES tiles at a
// time; the key is row rows - 1.
__global__ void __launch_bounds__(THREADS)
sort_stage_sub8_kernel(const float* __restrict__ x, const float* __restrict__ masks,
                       const int* __restrict__ sched, int n_stages, int tiles, int rows,
                       float* __restrict__ out) {
  constexpr int E = SUB8_E;
  extern __shared__ __align__(16) unsigned char smem[];
  KeyIdx* pairs = reinterpret_cast<KeyIdx*>(smem);
  float* in = reinterpret_cast<float*>(pairs + (size_t)tiles * C);
  float* perm = in + CHUNK * C;
  const int group = threadIdx.x / SUB8_GROUP;
  const int e0 = threadIdx.x % SUB8_GROUP * E;
  for (int t0 = 0; t0 < tiles; t0 += SUB8_TILES) {
    const int t = t0 + group;
    const bool active = t < tiles;   // whole warps: a group is 8 warps
    KeyIdx* tile = pairs + (size_t)t * C;
    float key[E];
    int idx[E];
    bool want[E];
    if (active) bitonic::load_row<E>(key, x + ((size_t)t * rows + rows - 1) * C + e0);
#pragma unroll
    for (int i = 0; i < E; ++i) idx[i] = e0 + i;
    for (int st = 0; st < n_stages; ++st) {
      const int j = __ldg(sched + 2 * st + 1);
      float w[E];
      bitonic::load_row<E>(w, masks + (size_t)(2 * st + 1) * C + e0);
#pragma unroll
      for (int i = 0; i < E; ++i) want[i] = w[i] > 0.5f;
      if (j >= 32 * E) {
        bitonic::shared_stage<E>(tile, key, idx, want, e0, j, active);
      } else if (active) {
        if (j < E)
          bitonic::local_stage<E>(key, idx, want, j);
        else
          bitonic::shuffle_stage<E>(key, idx, want, j / E, 0xffffffffu);
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < E; ++i) tile[e0 + i] = KeyIdx{key[i], idx[i]};
    }
  }
  __syncthreads();
  permute_rows(x, pairs, tiles, rows, in, perm, out);
}

int check_smem(const void* kernel, int tiles) {
  const size_t bytes = smem_bytes(tiles);
  if (bytes > (size_t)dynamic_smem_limit(kernel)) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int MASKS>
int launch_lane(const float* x, const float* masks, const int* sched, int n_stages, int tiles,
                int rows, int key_row, int blocks, float* out, void* stream) {
  if (rows < 1 || tiles < 0 || blocks < 1 || n_stages < 0 || key_row < 0 || key_row >= rows)
    return (int)cudaErrorInvalidValue;
  const int err = check_smem((const void*)sort_stage_lane_kernel<MASKS>, tiles);
  if (err != 0) return err;
  if (tiles > 0)
    sort_stage_lane_kernel<MASKS><<<blocks, THREADS, smem_bytes(tiles), (cudaStream_t)stream>>>(
        x, masks, sched, n_stages, tiles, rows, key_row, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The most dynamic shared memory one block may take on the current device.
extern "C" int bench_sort_stage_smem_limit() {
  return dynamic_smem_limit((const void*)sort_stage_lane_kernel<kIota>);
}

// The dynamic shared memory a block over `tiles` tiles takes (every variant).
extern "C" int bench_sort_stage_smem_need(int tiles) { return (int)smem_bytes(tiles); }

// Run the stages sched[2 s], sched[2 s + 1] = (k, j), s < n_stages, over the
// `tiles` (rows, 1024) tiles of x in each of `blocks` blocks on `stream`;
// block 0 writes the result to out. masks: the (2 n_stages, 1024) f32
// table (lane-const and sub8; lane-iota reads none). sub8 takes rows 1, 2,
// 4, 8, 16 or 32 and keys by row rows - 1. Each returns cudaGetLastError().
extern "C" int bench_sort_stage_lane_iota(const float* x, const float* masks, const int* sched,
                                          int n_stages, int tiles, int rows, int key_row,
                                          int blocks, float* out, void* stream) {
  return launch_lane<kIota>(x, masks, sched, n_stages, tiles, rows, key_row, blocks,
                                     out, stream);
}

extern "C" int bench_sort_stage_lane_const(const float* x, const float* masks, const int* sched,
                                           int n_stages, int tiles, int rows, int key_row,
                                           int blocks, float* out, void* stream) {
  return launch_lane<kConst>(x, masks, sched, n_stages, tiles, rows, key_row, blocks,
                                      out, stream);
}

extern "C" int bench_sort_stage_sub8(const float* x, const float* masks, const int* sched,
                                     int n_stages, int tiles, int rows, int key_row, int blocks,
                                     float* out, void* stream) {
  if (tiles < 0 || blocks < 1 || n_stages < 0 || key_row != rows - 1 || rows < 1 || rows > 32 ||
      (rows & (rows - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int err = check_smem((const void*)sort_stage_sub8_kernel, tiles);
  if (err != 0) return err;
  if (tiles > 0)
    sort_stage_sub8_kernel<<<blocks, THREADS, smem_bytes(tiles), (cudaStream_t)stream>>>(
        x, masks, sched, n_stages, tiles, rows, out);
  return (int)cudaGetLastError();
}
