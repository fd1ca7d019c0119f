// Bitonic compare-exchange stages over tiles held in shared memory: the
// stage that the probes P1 (csrc/bench_roll.cu) and P3
// (csrc/bench_sort_stage.cu) share.
//
// A tile is (rows, c) floats, row-major, c a power of two; a stage (k, j)
// pairs column e with its partner e ^ j and sorts by one key row. Column e
// takes its partner's whole column when
//
//   want_min(e) ? key(e ^ j) < key(e) : key(e ^ j) > key(e),
//   want_min(e) = ((e & j) == 0) == ((e & k) == 0),
//
// which is the JAX probes' `stage` (pltpu.roll up and down, selected by
// is_lo = (e & j) == 0). One thread owns a pair (lo, hi = lo | j): it reads
// both keys, and rewrites the rows of a column only where that column
// takes its partner. No other thread touches the pair in the stage, so one
// __syncthreads() between stages is all the ordering a stage needs.

#pragma once

#include <cuda_runtime.h>

namespace bitonic {

// Where a stage's want_min comes from: index math on the column (the JAX
// variant "lane-iota"), or a row of a table the caller passes ("lane-const"),
// read through L1 from device memory.
enum Masks { kIota = 0, kConst = 1 };

// The q-th pair of a stage with partner distance j: its low column (bit j
// clear); the high column is lo | j.
__device__ __forceinline__ int pair_lo(int q, int j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// One stage (k, j) over `tiles` consecutive (rows, c) tiles at `s`, keyed
// by row `key_row`; `half_shift` = log2(c / 2). kConst reads want_min of
// column e from want_min_row[e] (> 0.5 is true). The caller synchronises
// the block after it.
template <int MASKS>
__device__ __forceinline__ void stage(float* s, int tiles, int rows, int c, int half_shift,
                                      int key_row, int k, int j,
                                      const float* __restrict__ want_min_row) {
  const int pairs = tiles << half_shift;
  for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
    const int lo = pair_lo(q & ((1 << half_shift) - 1), j), hi = lo | j;
    float* tile = s + (size_t)(q >> half_shift) * rows * c;
    const float k_lo = tile[key_row * c + lo], k_hi = tile[key_row * c + hi];
    bool w_lo, w_hi;
    if (MASKS == kIota) {
      w_lo = (lo & k) == 0;      // is_lo, so want_min = asc
      w_hi = (hi & k) != 0;      // not is_lo, so want_min = !asc
    } else {
      w_lo = __ldg(want_min_row + lo) > 0.5f;
      w_hi = __ldg(want_min_row + hi) > 0.5f;
    }
    const bool take_lo = w_lo ? k_hi < k_lo : k_hi > k_lo;
    const bool take_hi = w_hi ? k_lo < k_hi : k_lo > k_hi;
    if (!(take_lo || take_hi)) continue;
    for (int r = 0; r < rows; ++r) {
      const float a = tile[r * c + lo], b = tile[r * c + hi];
      if (take_lo) tile[r * c + lo] = b;
      if (take_hi) tile[r * c + hi] = a;
    }
  }
}

// Copy n floats between device and shared memory with the block's threads,
// 16 bytes a thread where both ends allow it.
__device__ __forceinline__ void copy_block(float* __restrict__ dst, const float* __restrict__ src,
                                           int n) {
  int done = 0;
  if ((((size_t)dst | (size_t)src) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

}  // namespace bitonic
