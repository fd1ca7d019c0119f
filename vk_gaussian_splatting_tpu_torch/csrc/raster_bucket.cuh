// What the bucket-grid tile kernels share (csrc/raster_bucket_fwd.cu, K3,
// and csrc/raster_bucket_bwd.cu, K4): a tile's six window spans and the
// merge of their depth-sorted runs into one list, in shared memory. (The
// compaction of the lanes each blend step's cull keeps, which K2 shares
// too, is response::kept_place.)
//
// Spans (ops/bucket_grid.window_span_table): 0 the tile's own fine bucket,
// 1-2 the mid rows, 3-4 the coarse rows, 5 the global bucket, each one
// bucket of the (bucket, depth)-sorted slot array. Span i holds
//   n_eff_i = min(len_i, cap_i - start_i % 128)
// live candidates: the TPU kernel's capacity with its 128-alignment head,
// kept exactly because it decides which candidates are truncated. The
// heads of the non-empty spans sum to n_head, the number of dead lanes the
// TPU kernel's merged buffer holds before its first live lane; live
// candidate r of the merged list sits at lane n_head + r, so the blend
// steps (lanes cut at multiples of the chunk) end where the TPU kernel's
// chunks end.
//
// The merge orders the live candidates by (depth, span, position in span),
// the order the plain twin's stable sort gives (ops/raster_bucket.py); the
// depth is the response model's depth row (csrc/response.cuh), which holds
// the radial distance on the 3DGRT bucket path, or, in the key-row form
// (merge_row, KEYROW), the key row after the model's rows, which holds the
// host sorter's rank (ops/response.GS_KEY). Either row must hold the depth
// the slots were sorted by.
// Each span is ascending in depth, so a candidate's rank is its position
// in its own span plus, for every other span, the count of that span's
// keys before it: keys <= its own for a lower span index, keys < its own
// for a higher one (a binary search each). Ranks are distinct and fill
// [0, n_live); the list is deterministic.

#pragma once

#include <cuda_runtime.h>

namespace bucket {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per block, pixels per tile
constexpr int WARPS = PIX / 32;
constexpr int NUM_SPANS = 6;
constexpr int HEAD_ALIGN = 128;
constexpr int MAX_CHUNK = 1024;    // largest blend step staged at once

struct Spans {
  int start[NUM_SPANS];     // first column of each span
  int off[NUM_SPANS + 1];   // prefix of the live counts: span i's live
                            // candidates are unmerged lanes [off[i], off[i+1])
  int n_head;               // dead head lanes before the first live lane
};

__host__ __device__ inline int span_cap(int i, int cap0, int cap1, int cap2, int cap3) {
  return i == 0 ? cap0 : i <= 2 ? cap1 : i <= 4 ? cap2 : cap3;
}

// Shared memory one block needs: keys and merged lane indices for every
// lane the caps allow, plus `rows` staged f32 slots and `extra` int arrays
// of one chunk.
__host__ __device__ inline int smem_bytes(int c_total, int chunk, int rows, int extra) {
  return (int)(2 * sizeof(int) * (size_t)c_total + (rows + extra) * sizeof(int) * (size_t)chunk);
}

// Thread 0 fills `sp` for tile t; the caller synchronises.
__device__ inline void tile_spans(Spans& sp, const int* __restrict__ bucket_starts,
                                  const int* __restrict__ span_buckets, int t, int cap0,
                                  int cap1, int cap2, int cap3) {
  int off = 0, n_head = 0;
  for (int i = 0; i < NUM_SPANS; ++i) {
    const int s = bucket_starts[span_buckets[(t * NUM_SPANS + i) * 2]];
    const int e = bucket_starts[span_buckets[(t * NUM_SPANS + i) * 2 + 1]];
    const int head = s % HEAD_ALIGN;
    const int n_eff = min(max(e - s, 0), span_cap(i, cap0, cap1, cap2, cap3) - head);
    sp.start[i] = s;
    sp.off[i] = off;
    off += n_eff;
    if (n_eff > 0) n_head += head;
  }
  sp.off[NUM_SPANS] = off;
  sp.n_head = n_head;
}

// The row of the attrs the spans merge on: the model M's depth row, or,
// for the key-row form (KEYROW: the JAX kernel's key_is_row), the key row
// one after M's rows.
template <class M, bool KEYROW>
__host__ __device__ constexpr int merge_row() {
  return KEYROW ? M::ROWS : M::DEPTH_ROW;
}

__device__ inline int span_of(const Spans& sp, int g) {
  int i = 0;
  while (g >= sp.off[i + 1]) ++i;
  return i;
}

// order[r] = the unmerged lane (span i's candidate k is lane off[i] + k) of
// merged rank r, for r < n_live; -1 where no lane landed (only possible for
// NaN keys: the staging then reads a dead lane). All threads call it.
__device__ inline void merge_spans(const Spans& sp, const float* __restrict__ depth,
                                   float* keys, int* order) {
  const int n = sp.off[NUM_SPANS];
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
    const int i = span_of(sp, g);
    keys[g] = depth[sp.start[i] + (g - sp.off[i])];
    order[g] = -1;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n; g += blockDim.x) {
    const int i = span_of(sp, g);
    const float key = keys[g];
    int rank = g - sp.off[i];
    for (int j = 0; j < NUM_SPANS; ++j) {
      if (j == i) continue;
      const float* kj = keys + sp.off[j];
      int lo = 0, hi = sp.off[j + 1] - sp.off[j];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (j < i ? kj[mid] <= key : kj[mid] < key) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    if (rank < n) order[rank] = g;
  }
  __syncthreads();
}

}  // namespace bucket
