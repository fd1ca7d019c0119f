// Bitonic sort stages over tiles in shared memory, in three mask and layout
// styles: the probe P3.
//
// Replaces the Pallas kernel of scripts/bench_sort_stage.py:115
// (`make_call`, called at :132), which loads TPT tiles of (ROWS, 1024) f32
// into VMEM and runs N_STAGES bitonic compare-exchange stages over each
// (the full schedule of 1024 cut short or repeated), keyed by row ROWS - 1,
// every column moving with its key; each of its 4096 grid steps re-sorts
// the same block on one core. Here `blocks` blocks run at once, each
// sorting its own copy of the tiles in its shared memory, and block 0
// writes the result: "ns per stage per tile" is then the whole card's
// throughput. The JAX variants keep their names:
//
// - lane-iota: want_min from the column's index (csrc/bitonic.cuh, kIota);
// - lane-const: want_min from the odd rows of the caller's (2S, 1024) f32
//   table, read through L1 from device memory (at S = 55 it is 450 KB, more
//   than a block's shared memory; each stage reads one 4 KB row of it).
//   The even rows (is_lo) pick the partner in the JAX stage; here the
//   partner is e ^ j by construction, which is what is_lo selects in every
//   table the probe builds (probes/bench_sort_stage.np_masks);
// - sub8, the counterpart of "partners inside one vreg": a thread holds
//   its column of each tile in registers; partners with j < 32 lie in the
//   same warp and are exchanged by __shfl_xor_sync, and only stages with
//   j >= 32 go through shared memory (store, barrier, read the partner,
//   barrier). want_min comes from the table, as in lane-const.
//
// What bounds it on the H100: f32 operations (about 10 mask and compare
// operations per column and stage, plus one select per row) against the
// latency of shared memory and barriers: a stage is one pass over the
// tiles in shared memory and one barrier (sub8: registers, or two
// barriers). TPT x ROWS x 1024 x 4 B = 128 KB at the defaults, so one block
// per SM; sizes beyond the card's shared memory are refused.

#include <cuda_runtime.h>

#include "bitonic.cuh"
#include "smem.cuh"

namespace {

constexpr int C = 1024;            // columns of a tile (the JAX probe's C)
constexpr int HALF_SHIFT = 9;      // log2(C / 2)
constexpr int THREADS = 1024;
constexpr int SUB8_VALUES = 32;    // floats of tile columns a sub8 thread holds

template <int MASKS>
__global__ void __launch_bounds__(THREADS)
sort_stage_smem_kernel(const float* __restrict__ x, const float* __restrict__ masks,
                       const int* __restrict__ sched, int n_stages, int tiles, int rows,
                       int key_row, float* __restrict__ out) {
  extern __shared__ __align__(16) float s[];
  const int n = tiles * rows * C;
  bitonic::copy_block(s, x, n);
  __syncthreads();
  for (int st = 0; st < n_stages; ++st) {
    const int k = __ldg(sched + 2 * st), j = __ldg(sched + 2 * st + 1);
    bitonic::stage<MASKS>(s, tiles, rows, C, HALF_SHIFT, key_row, k, j,
                          masks + (size_t)(2 * st + 1) * C);
    __syncthreads();
  }
  if (blockIdx.x == 0) bitonic::copy_block(out, s, n);
}

// sub8: thread e owns column e of up to SUB8_VALUES / ROWS tiles at a time,
// in registers; the key is row ROWS - 1.
template <int ROWS>
__global__ void __launch_bounds__(THREADS)
sort_stage_sub8_kernel(const float* __restrict__ x, const float* __restrict__ masks,
                       const int* __restrict__ sched, int n_stages, int tiles,
                       float* __restrict__ out) {
  constexpr int GROUP = SUB8_VALUES / ROWS;   // tiles in registers at once
  constexpr int KEY = ROWS - 1;
  extern __shared__ __align__(16) float s[];  // [GROUP][ROWS][C]
  const int e = threadIdx.x;
  float v[GROUP][ROWS];
  for (int t0 = 0; t0 < tiles; t0 += GROUP) {
    const int nt = min(GROUP, tiles - t0);
#pragma unroll
    for (int t = 0; t < GROUP; ++t) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        v[t][r] = t < nt ? __ldg(x + ((size_t)(t0 + t) * ROWS + r) * C + e) : 0.0f;
    }
    for (int st = 0; st < n_stages; ++st) {
      const int j = __ldg(sched + 2 * st + 1);
      const bool want_min = __ldg(masks + (size_t)(2 * st + 1) * C + e) > 0.5f;
      if (j < 32) {
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          if (t >= nt) continue;  // nt is the same for the whole block
          const float k_self = v[t][KEY];
          const float k_part = __shfl_xor_sync(0xffffffffu, k_self, j);
          const bool take = want_min ? k_part < k_self : k_part > k_self;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float p = __shfl_xor_sync(0xffffffffu, v[t][r], j);
            v[t][r] = take ? p : v[t][r];
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          if (t < nt) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) s[(t * ROWS + r) * C + e] = v[t][r];
          }
        }
        __syncthreads();
        const int p = e ^ j;
#pragma unroll
        for (int t = 0; t < GROUP; ++t) {
          if (t >= nt) continue;
          const float k_part = s[(t * ROWS + KEY) * C + p];
          const bool take = want_min ? k_part < v[t][KEY] : k_part > v[t][KEY];
          if (take) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) v[t][r] = s[(t * ROWS + r) * C + p];
          }
        }
        __syncthreads();
      }
    }
    if (blockIdx.x == 0) {
#pragma unroll
      for (int t = 0; t < GROUP; ++t) {
        if (t < nt) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) out[((size_t)(t0 + t) * ROWS + r) * C + e] = v[t][r];
        }
      }
    }
  }
}

template <int MASKS>
int launch_smem(const float* x, const float* masks, const int* sched, int n_stages, int tiles,
                int rows, int key_row, int blocks, float* out, void* stream) {
  if (rows < 1 || tiles < 0 || blocks < 1 || n_stages < 0 || key_row < 0 || key_row >= rows)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)tiles * rows * C * sizeof(float);
  if (bytes > (size_t)dynamic_smem_limit((const void*)sort_stage_smem_kernel<MASKS>))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sort_stage_smem_kernel<MASKS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0)
    sort_stage_smem_kernel<MASKS><<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
        x, masks, sched, n_stages, tiles, rows, key_row, out);
  return (int)cudaGetLastError();
}

template <int ROWS>
int launch_sub8_rows(const float* x, const float* masks, const int* sched, int n_stages,
                     int tiles, int blocks, float* out, void* stream) {
  constexpr int GROUP = SUB8_VALUES / ROWS;
  const int bytes = (tiles < GROUP ? tiles : GROUP) * ROWS * C * (int)sizeof(float);
  if (bytes > dynamic_smem_limit((const void*)sort_stage_sub8_kernel<ROWS>))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sort_stage_sub8_kernel<ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0)
    sort_stage_sub8_kernel<ROWS><<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
        x, masks, sched, n_stages, tiles, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The most dynamic shared memory one block of the lane variants may take
// on the current device.
extern "C" int bench_sort_stage_smem_limit() {
  return dynamic_smem_limit((const void*)sort_stage_smem_kernel<bitonic::kIota>);
}

// Run the stages sched[2 s], sched[2 s + 1] = (k, j), s < n_stages, over the
// `tiles` (rows, 1024) tiles of x in each of `blocks` blocks on `stream`;
// block 0 writes the result to out. masks: the (2 n_stages, 1024) f32
// table (lane-const and sub8; lane-iota reads none). sub8 takes rows 1, 2,
// 4, 8, 16 or 32 and keys by row rows - 1. Each returns cudaGetLastError().
extern "C" int bench_sort_stage_lane_iota(const float* x, const float* masks, const int* sched,
                                          int n_stages, int tiles, int rows, int key_row,
                                          int blocks, float* out, void* stream) {
  return launch_smem<bitonic::kIota>(x, masks, sched, n_stages, tiles, rows, key_row, blocks,
                                     out, stream);
}

extern "C" int bench_sort_stage_lane_const(const float* x, const float* masks, const int* sched,
                                           int n_stages, int tiles, int rows, int key_row,
                                           int blocks, float* out, void* stream) {
  return launch_smem<bitonic::kConst>(x, masks, sched, n_stages, tiles, rows, key_row, blocks,
                                      out, stream);
}

extern "C" int bench_sort_stage_sub8(const float* x, const float* masks, const int* sched,
                                     int n_stages, int tiles, int rows, int key_row, int blocks,
                                     float* out, void* stream) {
  if (tiles < 0 || blocks < 1 || n_stages < 0 || key_row != rows - 1)
    return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return launch_sub8_rows<1>(x, masks, sched, n_stages, tiles, blocks, out, stream);
    case 2: return launch_sub8_rows<2>(x, masks, sched, n_stages, tiles, blocks, out, stream);
    case 4: return launch_sub8_rows<4>(x, masks, sched, n_stages, tiles, blocks, out, stream);
    case 8: return launch_sub8_rows<8>(x, masks, sched, n_stages, tiles, blocks, out, stream);
    case 16: return launch_sub8_rows<16>(x, masks, sched, n_stages, tiles, blocks, out, stream);
    case 32: return launch_sub8_rows<32>(x, masks, sched, n_stages, tiles, blocks, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
