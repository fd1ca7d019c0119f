// Bitonic compare-exchange stages on (key, column index) pairs: the
// network the probes P1 (csrc/bench_roll.cu) and P3
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
// is_lo = (e & j) == 0), or want_min(e) read from a table. That decision
// reads the keys alone, so the network runs on (key, index) pairs: column
// e takes its partner's pair exactly where it would take its partner's
// column, each column by its own test (a table may make both columns of a
// pair take, or neither, and so duplicate a column). Afterwards column e of
// the result is column index(e) of the input, row for row: the rows move
// once, by one gather, whatever the schedule, the table or the ties.
//
// The pairs live in registers, E consecutive columns to a thread: a stage
// with j < E pairs columns inside a thread, one with j < 32 E columns of one
// warp (__shfl_xor_sync), and only the stages beyond go through shared
// memory. P3's lane variants keep the pairs in shared memory instead, one
// pass per stage (bench_sort_stage.cu).

#pragma once

#include <cuda_runtime.h>

namespace bitonic {

// A column's key and the input column it holds, moved as one 8-byte word.
struct __align__(8) KeyIdx {
  float key;
  int idx;
};

// The take test of the row-moving form, unchanged: strict compares, so NaN
// and equal keys never take.
__device__ __forceinline__ bool takes(bool want_min, float self, float partner) {
  return want_min ? partner < self : partner > self;
}

// want_min of column e in stage (k, j) by index math (the JAX variant
// "lane-iota").
__device__ __forceinline__ bool iota_want_min(int e, int k, int j) {
  return ((e & j) == 0) == ((e & k) == 0);
}

// The q-th pair of a stage with partner distance j: its low column (bit j
// clear); the high column is lo | j.
__device__ __forceinline__ int pair_lo(int q, int j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// A stage with partner distance J < E: both columns of each pair in this
// thread's registers, each taking the other's pair by its own test.
template <int E, int J>
__device__ __forceinline__ void local_stage(float (&key)[E], int (&idx)[E], const bool (&want)[E]) {
  static_assert(J < E, "both columns of a pair must lie in the thread");
#pragma unroll
  for (int lo = 0; lo < E; ++lo) {
    if (lo & J) continue;
    const int hi = lo | J;
    const float k_lo = key[lo], k_hi = key[hi];
    const int i_lo = idx[lo], i_hi = idx[hi];
    const bool t_lo = takes(want[lo], k_lo, k_hi), t_hi = takes(want[hi], k_hi, k_lo);
    key[lo] = t_lo ? k_hi : k_lo;
    idx[lo] = t_lo ? i_hi : i_lo;
    key[hi] = t_hi ? k_lo : k_hi;
    idx[hi] = t_hi ? i_lo : i_hi;
  }
}

// local_stage for a runtime j < E.
template <int E, int J = 1>
__device__ __forceinline__ void local_stage(float (&key)[E], int (&idx)[E], const bool (&want)[E],
                                            int j) {
  if constexpr (J < E) {
    if (j == J)
      local_stage<E, J>(key, idx, want);
    else
      local_stage<E, 2 * J>(key, idx, want, j);
  }
}

// A stage whose partners lie `lanes` = j / E lanes away in the warp; `mask`
// names the warp's threads.
template <int E>
__device__ __forceinline__ void shuffle_stage(float (&key)[E], int (&idx)[E], const bool (&want)[E],
                                              int lanes, unsigned mask) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float k_p = __shfl_xor_sync(mask, key[i], lanes);
    const int i_p = __shfl_xor_sync(mask, idx[i], lanes);
    const bool t = takes(want[i], key[i], k_p);
    key[i] = t ? k_p : key[i];
    idx[i] = t ? i_p : idx[i];
  }
}

// A stage whose partners lie in other warps: every pair through `s` (the
// tile's c slots), columns e0 .. e0 + E - 1 this thread's. Every thread of
// the block calls it (`active` false for one without a tile): it holds two
// barriers, before the partners are read and before `s` may be written
// again.
template <int E>
__device__ __forceinline__ void shared_stage(KeyIdx* s, float (&key)[E], int (&idx)[E],
                                             const bool (&want)[E], int e0, int j, bool active) {
  if (active) {
#pragma unroll
    for (int i = 0; i < E; ++i) s[e0 + i] = KeyIdx{key[i], idx[i]};
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const KeyIdx p = s[(e0 + i) ^ j];
      const bool t = takes(want[i], key[i], p.key);
      key[i] = t ? p.key : key[i];
      idx[i] = t ? p.idx : idx[i];
    }
  }
  __syncthreads();
}

// E floats at `src` (16-byte aligned when E is a multiple of 4) into
// registers, and back.
template <int E>
__device__ __forceinline__ void load_row(float (&v)[E], const float* __restrict__ src) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src + i));
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = __ldg(src + i);
  }
}

template <int E>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4)
      reinterpret_cast<float4*>(dst + i)[0] = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) dst[i] = v[i];
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
