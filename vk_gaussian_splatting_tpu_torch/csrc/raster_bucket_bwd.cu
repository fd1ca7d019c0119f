// Bucket-grid tile rasterizer, backward, for the gs2d and gut3d response
// models: K4.
//
// Replaces the Pallas kernel raster_bucket._make_bwd_kernel
// (vk_gaussian_splatting_tpu/ops/raster_bucket.py:927) and the slot
// reduction of its custom VJP (_br_bwd, :1367): the gradient of the
// blended rgb and transmittance with respect to the rows of every slot
// column the tiles read (gs2d: x, y, conic a/b/c, opacity, r/g/b; gut3d:
// position, scale, r/g/b, quaternion, opacity). The model is a template
// parameter (csrc/response.cuh: its staged slots, alpha and hand-derived
// VJP, which the TPU kernel takes with in-kernel jax.vjp); one C entry
// point per model.
//
// Two kernels, one launch of the wrapper:
// 1. raster_bucket_bwd_tiles: one thread block per 16x16 tile, one thread
//    per pixel. The same span read and merge as the forward
//    (csrc/raster_bucket.cuh), then the pair backward's one sweep
//    (csrc/rasterize_bwd.cu): alpha and T recomputed front to back with
//    the forward's per-step freeze, the colour still to come as
//    S_total - s_run, the model's VJP, and each lane's gradients (9 rows
//    for gs2d, 14 for gut3d) summed over the tile's pixels by warp
//    shuffles and a fixed-order pass over the warps. Each merged lane knows its source column, so nothing has to
//    be un-merged (the TPU kernel replays its merge network backwards and
//    sorts by id). A lane of the tile's own fine bucket belongs to this
//    tile alone: its gradient is stored in d_attrs once. A lane of a shared
//    span (mid, coarse, global) is read by other tiles too: its gradient
//    goes to this tile's slot in a scratch buffer, (GRAD_ROWS, T * S) f32
//    with S the shared spans' caps summed, and lanes past the block's
//    early exit get zeros there.
// 2. raster_bucket_bwd_partial and raster_bucket_bwd_reduce sum each
//    shared column's scratch slots over the tiles that read it, in a fixed
//    order: the reader table (static per image size, from
//    ops/bucket_grid.window_span_table) lists a bucket's readers in
//    (tile, span) order, cut into segments of at most 64; one thread per
//    (row, segment, column) sums a segment in order, then one thread per
//    (row, column) sums the column's segments in order and stores the sum
//    once. (A mid bucket has 32 readers, a coarse one up to 512, the
//    global one all T tiles: one serial loop per column took 3.3 ms of
//    K4's 8.5 on an H100 at 1080p with 1 M splats, PERF.md.)
// No float atomics: the result repeats bit for bit. d_attrs arrives zeroed:
// columns no tile reads live (truncated tails, sentinel slots) stay zero,
// and so does the depth row.
//
// What bounds it on the H100: per (pixel, lane) the forward's alpha plus,
// per hit, the model's gradient and a per-lane reduction over the tile, as
// K2, on every candidate of the tile's window rather than its pairs; then
// the scratch (written once per (tile, shared lane), read once by the
// reduce).
// Built like the forward with exact expf, no fast math and -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_bucket.cuh"
#include "response.cuh"
#include "smem.cuh"

namespace {

using bucket::NUM_SPANS;
using bucket::PIX;
constexpr int WARPS = PIX / 32;
constexpr int CTX_ROWS = 5;        // g_r, g_g, g_b, S_total, g_T * T_final
constexpr int SUB = 32;            // lanes per shared-memory reduction batch
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Scratch lane of span i's candidate k (i >= 1) within a tile's S slots.
// Spans 1-2 (mid rows) come first, then 3-4 (coarse rows), then 5 (global).
__device__ __forceinline__ int shared_slot(int i, int k, int cap1, int cap2) {
  const int base = i <= 2 ? (i - 1) * cap1
                 : i <= 4 ? 2 * cap1 + (i - 3) * cap2 : 2 * cap1 + 2 * cap2;
  return base + k;
}

template <class M>
__global__ void __launch_bounds__(PIX)
raster_bucket_bwd_tiles(const float* __restrict__ attrs, long long stride,
                        const int* __restrict__ bucket_starts,
                        const int* __restrict__ span_buckets,
                        const float* __restrict__ ctx, const float* __restrict__ pix_ctx,
                        int tiles_x, int c_total, int cap0, int cap1, int cap2, int cap3,
                        int chunk, response::Params prm, float min_transmittance,
                        float* __restrict__ scratch, long long scratch_stride,
                        float* __restrict__ d_attrs) {
  constexpr int GRAD_ROWS = M::GRAD_ROWS;
  extern __shared__ float smem[];
  float* keys = smem;                                    // [c_total]
  int* order = (int*)(keys + c_total);                   // [c_total]
  float* s_attr = (float*)(order + c_total);             // [BWD_SLOTS][chunk]
  int* s_col = (int*)(s_attr + M::BWD_SLOTS * chunk);    // [chunk] fine column or -1
  int* s_slot = s_col + chunk;                           // [chunk] scratch slot or -1
  __shared__ float s_part[WARPS][GRAD_ROWS][SUB];
  __shared__ bucket::Spans sp;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  if (i == 0) bucket::tile_spans(sp, bucket_starts, span_buckets, t, cap0, cap1, cap2, cap3);
  __syncthreads();
  bucket::merge_spans(sp, attrs + M::DEPTH_ROW * stride, keys, order);

  const response::Pixel pix = response::load_pixel(t, tiles_x, i, pix_ctx);
  const int n_head = sp.n_head;
  const int n_live = sp.off[NUM_SPANS];
  const int end = n_head + n_live;
  const long long slot0 = (long long)t * (2 * cap1 + 2 * cap2 + cap3);

  const float* c = ctx + (size_t)t * CTX_ROWS * PIX;
  const float gr = c[0 * PIX + i];
  const float gg = c[1 * PIX + i];
  const float gb = c[2 * PIX + i];
  const float s_total = c[3 * PIX + i];
  const float gt_tn = c[4 * PIX + i];
  const float q_min = 1.0f - prm.alpha_clamp;

  float T = 1.0f, s_run = 0.0f;
  int s = n_head - n_head % chunk;
  while (s < end) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int lo = max(s, n_head);
    const int n = e - lo;
    for (int j = i; j < n; j += PIX) {
      const int g = order[lo - n_head + j];
      if (g < 0) {  // no lane: zero slots, an alpha of 0, no gradient stored
        #pragma unroll
        for (int r = 0; r < M::BWD_SLOTS; ++r) s_attr[r * chunk + j] = 0.0f;
        s_col[j] = s_slot[j] = -1;
        continue;
      }
      const int sp_i = bucket::span_of(sp, g);
      const int k = g - sp.off[sp_i];
      const long long col = sp.start[sp_i] + k;
      M::stage_bwd(attrs, stride, col, s_attr, chunk, j);
      s_col[j] = sp_i == 0 ? (int)col : -1;
      s_slot[j] = sp_i == 0 ? -1 : shared_slot(sp_i, k, cap1, cap2);
    }
    __syncthreads();
    const bool live = T > min_transmittance;  // per-step freeze, as the forward
    for (int j0 = 0; j0 < n; j0 += SUB) {
      const int m = min(SUB, n - j0);
      for (int jj = 0; jj < m; ++jj) {
        const int j = j0 + jj;
        float g[GRAD_ROWS];
        #pragma unroll
        for (int r = 0; r < GRAD_ROWS; ++r) g[r] = 0.0f;
        bool hit = false;
        float a_raw;
        typename M::Hit h;
        if (live && M::eval(s_attr, chunk, j, pix, prm, a_raw, h)) {
          hit = true;
          const float a = fminf(a_raw, prm.alpha_clamp);
          const float w = a * T;
          const float cgv = gr * s_attr[6 * chunk + j] + gg * s_attr[7 * chunk + j] +
                            gb * s_attr[8 * chunk + j];
          s_run += w * cgv;
          const float q = 1.0f - a;
          const float dalpha = T * cgv - ((s_total - s_run) + gt_tn) / fmaxf(q, q_min);
          const float da = a_raw <= prm.alpha_clamp ? dalpha : 0.0f;
          M::vjp(s_attr, chunk, j, pix, prm, h, a_raw, da, g);
          g[6] = gr * w;
          g[7] = gg * w;
          g[8] = gb * w;
          T *= q;
        }
        // a warp none of whose pixels the lane touches adds exact zeros
        if (__any_sync(0xffffffffu, hit)) {
          #pragma unroll
          for (int r = 0; r < GRAD_ROWS; ++r) {
            const float v = warp_sum(g[r]);
            if (lane == 0) s_part[warp][r][jj] = v;
          }
        } else if (lane == 0) {
          #pragma unroll
          for (int r = 0; r < GRAD_ROWS; ++r) s_part[warp][r][jj] = 0.0f;
        }
      }
      __syncthreads();
      // warps summed in a fixed order; one plain store per (row, lane)
      for (int k = i; k < GRAD_ROWS * m; k += PIX) {
        const int r = k / m, jj = k % m;
        float v = 0.0f;
        #pragma unroll
        for (int w8 = 0; w8 < WARPS; ++w8) v += s_part[w8][r][jj];
        const int j = j0 + jj;
        if (s_col[j] >= 0) {
          d_attrs[r * stride + s_col[j]] = v;
        } else if (s_slot[j] >= 0) {
          scratch[r * scratch_stride + slot0 + s_slot[j]] = v;
        }
      }
      __syncthreads();  // s_part is rewritten by the next batch
    }
    s = e;
    // all pixels frozen: every later lane's gradient is zero. Also the
    // barrier before the next step overwrites shared memory.
    if (!__syncthreads_or(T > min_transmittance)) break;
  }

  // the shared lanes past the early exit: zeros in their scratch slots, so
  // the reduce reads a value for every (tile, live lane)
  for (int r = max(s, n_head) - n_head + i; r < n_live; r += PIX) {
    const int g = order[r];
    if (g < 0) continue;
    const int sp_i = bucket::span_of(sp, g);
    if (sp_i == 0) continue;
    const long long at = slot0 + shared_slot(sp_i, g - sp.off[sp_i], cap1, cap2);
    #pragma unroll
    for (int row = 0; row < GRAD_ROWS; ++row) scratch[row * scratch_stride + at] = 0.0f;
  }
}

// Live candidates of shared bucket b, read through spans of class `span`
// (every reader of a bucket reads it through a span of the bucket's class:
// mid 1-2, coarse 3-4, global 5).
__device__ __forceinline__ int shared_neff(const int* __restrict__ bucket_starts, int b,
                                           int span, int cap1, int cap2, int cap3) {
  const int start = bucket_starts[b];
  return min(max(bucket_starts[b + 1] - start, 0),
             bucket::span_cap(span, 0, cap1, cap2, cap3) - start % bucket::HEAD_ALIGN);
}

// One block per (reader segment, row): thread p sums the segment's scratch
// slots of the bucket's candidate p, in reader order. (Row-generic: the
// grid's y extent is the model's GRAD_ROWS.)
__global__ void __launch_bounds__(REDUCE_THREADS)
raster_bucket_bwd_partial(const int* __restrict__ bucket_starts,
                          const int* __restrict__ reader_code,
                          const int* __restrict__ seg_bucket, const int* __restrict__ seg_first,
                          const int* __restrict__ seg_last, int num_segments, int cap1,
                          int cap2, int cap3, const float* __restrict__ scratch,
                          long long scratch_stride, float* __restrict__ partial,
                          int partial_lanes) {
  const int sg = blockIdx.x;
  const int row = blockIdx.y;
  const int r0 = seg_first[sg], r1 = seg_last[sg];
  const int n_eff = shared_neff(bucket_starts, seg_bucket[sg], reader_code[r0] & 7, cap1,
                                cap2, cap3);
  const long long s_lanes = 2 * cap1 + 2 * cap2 + cap3;
  const float* src = scratch + row * scratch_stride;
  float* dst = partial + ((long long)row * num_segments + sg) * partial_lanes;
  for (int p = threadIdx.x; p < n_eff; p += REDUCE_THREADS) {
    float v = 0.0f;
    for (int e = r0; e < r1; ++e) {
      const int code = reader_code[e];
      v += src[(code >> 3) * s_lanes + shared_slot(code & 7, p, cap1, cap2)];
    }
    dst[p] = v;
  }
}

// One block per (shared bucket, row): thread p sums the bucket's segment
// sums of its candidate p, in segment order, and stores column start + p.
__global__ void __launch_bounds__(REDUCE_THREADS)
raster_bucket_bwd_reduce(const int* __restrict__ bucket_starts,
                         const int* __restrict__ reader_code,
                         const int* __restrict__ seg_first, const int* __restrict__ bucket_seg,
                         int first_bucket, int num_segments, int cap1, int cap2, int cap3,
                         const float* __restrict__ partial, int partial_lanes,
                         long long stride, float* __restrict__ d_attrs) {
  const int b = first_bucket + blockIdx.x;
  const int row = blockIdx.y;
  const int s0 = bucket_seg[b], s1 = bucket_seg[b + 1];
  if (s0 == s1) return;  // no tile reads this bucket
  const int n_eff = shared_neff(bucket_starts, b, reader_code[seg_first[s0]] & 7, cap1, cap2,
                                cap3);
  const float* src = partial + (long long)row * num_segments * partial_lanes;
  const int start = bucket_starts[b];
  for (int p = threadIdx.x; p < n_eff; p += REDUCE_THREADS) {
    float v = 0.0f;
    for (int sg = s0; sg < s1; ++sg) v += src[(long long)sg * partial_lanes + p];
    d_attrs[row * stride + start + p] = v;
  }
}

template <class M>
int smem_of(int c_total, int chunk) {
  return bucket::smem_bytes(c_total, chunk, M::BWD_SLOTS, 2);
}

template <class M>
int smem_limit_of() {
  return dynamic_smem_limit((const void*)raster_bucket_bwd_tiles<M>);
}

template <class M>
int launch(const float* attrs, long long stride, const int* bucket_starts,
           const int* span_buckets, const int* reader_code, const int* seg_bucket,
           const int* seg_first, const int* seg_last, const int* bucket_seg, int num_segments,
           const float* ctx, const float* pix_ctx, int num_tiles, int tiles_x, int cap0,
           int cap1, int cap2, int cap3, int first_bucket, int global_bucket, int chunk,
           float alpha_min, float alpha_clamp, float qmax, float min_response, int degree,
           float min_transmittance, float* scratch, float* partial, float* d_attrs,
           void* stream) {
  if (chunk < 1 || chunk > bucket::MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const int c_total = cap0 + 2 * cap1 + 2 * cap2 + cap3;
  const int smem = smem_of<M>(c_total, chunk);
  if (smem > smem_limit_of<M>()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      raster_bucket_bwd_tiles<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const response::Params prm{alpha_min, alpha_clamp, qmax, min_response, degree};
  const long long scratch_stride = (long long)num_tiles * (2 * cap1 + 2 * cap2 + cap3);
  if (num_tiles > 0) {
    raster_bucket_bwd_tiles<M><<<num_tiles, PIX, smem, (cudaStream_t)stream>>>(
        attrs, stride, bucket_starts, span_buckets, ctx, pix_ctx, tiles_x, c_total, cap0, cap1,
        cap2, cap3, chunk, prm, min_transmittance, scratch, scratch_stride, d_attrs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int partial_lanes = max(cap1, max(cap2, cap3));
    if (num_segments > 0) {
      raster_bucket_bwd_partial<<<dim3(num_segments, M::GRAD_ROWS), REDUCE_THREADS, 0,
                                  (cudaStream_t)stream>>>(
          bucket_starts, reader_code, seg_bucket, seg_first, seg_last, num_segments, cap1,
          cap2, cap3, scratch, scratch_stride, partial, partial_lanes);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    raster_bucket_bwd_reduce<<<dim3(global_bucket - first_bucket + 1, M::GRAD_ROWS),
                               REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
        bucket_starts, reader_code, seg_first, bucket_seg, first_bucket, num_segments, cap1,
        cap2, cap3, partial, partial_lanes, stride, d_attrs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one tile block takes for `c_total` lanes (the six
// spans' caps summed) and blend steps of `chunk` lanes, per model.
extern "C" int raster_bucket_bwd_smem(int c_total, int chunk) {
  return smem_of<response::Gs2d>(c_total, chunk);
}
extern "C" int raster_bucket_bwd_gut3d_smem(int c_total, int chunk) {
  return smem_of<response::Gut3d>(c_total, chunk);
}

// The most dynamic shared memory a tile block may take on the current device.
extern "C" int raster_bucket_bwd_smem_limit() { return smem_limit_of<response::Gs2d>(); }
extern "C" int raster_bucket_bwd_gut3d_smem_limit() { return smem_limit_of<response::Gut3d>(); }

// Launch the tile kernel (one block per tile) and the two reduce passes on
// `stream`; return cudaGetLastError(). The reader table: reader_code
// (tile * 8 + span) in (bucket, tile, span) order, cut into num_segments
// segments [seg_first, seg_last) of bucket seg_bucket; bucket b owns
// segments [bucket_seg[b], bucket_seg[b + 1]). d_attrs must hold zeros on
// entry; scratch is (GRAD_ROWS, num_tiles * (2 cap1 + 2 cap2 + cap3)) f32
// and partial (GRAD_ROWS, num_segments, max(cap1, cap2, cap3)) f32, no
// initial values; GRAD_ROWS is 9 for gs2d, 14 for gut3d. gs2d reads no
// pixel context (pix_ctx may be null); gut3d reads the (T, 8, 256) one.
#define RASTER_BUCKET_BWD_PARAMS                                                             \
  const float *attrs, long long stride, const int *bucket_starts, const int *span_buckets,  \
      const int *reader_code, const int *seg_bucket, const int *seg_first,                  \
      const int *seg_last, const int *bucket_seg, int num_segments, const float *ctx,       \
      const float *pix_ctx, int num_tiles, int tiles_x, int cap0, int cap1, int cap2,       \
      int cap3, int first_bucket, int global_bucket, int chunk, float alpha_min,            \
      float alpha_clamp, float qmax, float min_response, int degree,                        \
      float min_transmittance, float *scratch, float *partial, float *d_attrs, void *stream
#define RASTER_BUCKET_BWD_ARGS                                                               \
  attrs, stride, bucket_starts, span_buckets, reader_code, seg_bucket, seg_first, seg_last, \
      bucket_seg, num_segments, ctx, pix_ctx, num_tiles, tiles_x, cap0, cap1, cap2, cap3,   \
      first_bucket, global_bucket, chunk, alpha_min, alpha_clamp, qmax, min_response,       \
      degree, min_transmittance, scratch, partial, d_attrs, stream

extern "C" int raster_bucket_bwd(RASTER_BUCKET_BWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d>(RASTER_BUCKET_BWD_ARGS);
}

extern "C" int raster_bucket_bwd_gut3d(RASTER_BUCKET_BWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d>(RASTER_BUCKET_BWD_ARGS);
}
