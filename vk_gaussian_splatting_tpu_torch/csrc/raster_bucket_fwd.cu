// Bucket-grid tile rasterizer, forward, for the gs2d and gut3d response
// models and their packed forms gs2dp and gut3dp: K3.
//
// Replaces the Pallas kernel raster_bucket._make_kernel
// (vk_gaussian_splatting_tpu/ops/raster_bucket.py:469). It computes what
// that kernel computes for each model; it drops the TPU mechanics (tiles
// per grid step, the 4x4-tile cell grid, the DMA staging, the odd-even
// merge network, the gut3d pixel context DMA'd and transposed per tile)
// and keeps the two things the outputs depend on exactly: the capacity
// accounting with its 128-alignment head and the freeze positions
// (csrc/raster_bucket.cuh). The model is a template parameter
// (csrc/response.cuh); one C entry point per model. A packed model merges
// on its exact sort-depth row and stages fewer words per lane (gs2dp 6-7
// instead of 9-10, gut3dp 9-10 instead of 14-15) into the same slots.
//
// Design: one thread block per 16x16 tile, one thread per pixel.
// 1. Thread 0 reads the tile's six window spans from bucket_starts.
// 2. The block merges the spans' live candidates into one list ordered by
//    (depth, span, position), the depth being the model's depth row: keys
//    and lane indices only, in dynamic shared memory (8 bytes per lane the
//    caps allow: 24 KB at 3,072).
// 3. The block blends the list front to back in steps that end at the
//    merged lanes n_head + r that are multiples of `chunk` (the bucket
//    blend chunk, 384 by default). Each step first culls its lanes by the
//    model's exact per-tile predicate (csrc/response.cuh may_hit, as K4
//    culls: false only where the alpha fails the cutoffs at every pixel of
//    the tile): thread i stages lane r0 + i of each round of 256 in
//    registers as the model's backward slots, which may_hit reads, and asks
//    it; response::kept_place compacts the kept lanes in merged order, and
//    only they are written to shared memory as the model's forward slots
//    (the backward slots before the depth, then the depth row) with the
//    int32 id. Then every pixel (gut3d: its ray from the pixel context, in
//    registers) runs the pair blender's math (csrc/rasterize_fwd.cu) over
//    the kept lanes, with its per-step freeze and its first-crossing depth
//    and id pick. A culled lane changes no T, colour or pick, so the
//    outputs are bit for bit those of the sweep over every lane (the plain
//    twin's); the step boundaries stay where they were, and a step whose
//    lanes are all culled still counts as a step. The block stops once all
//    256 pixels froze, and adds its kept lanes to a counter (one integer
//    atomic). Every tile is written: empty ones as rgb 0, T 1, depth 0,
//    id -1.
//
// What bounds it on the H100: f32 operations per (pixel, kept lane), as K1
// (about 17 for gs2d, 68 for gut3d), plus the cull's f64 operations per
// tested lane; but a tile reads its whole window (its own fine bucket and
// the mid, coarse and global spans that neighbouring tiles also read), so
// each tile re-reads its shared spans' rows from device memory (mostly
// from L2) and the merge costs five binary searches per lane. The merge
// and the row gathers are what K1 does not pay. Built with exact expf,
// without fast math and with -fmad=false (ops/_build.py), so its alphas
// equal the plain twin's bit for bit. Caps whose lanes exceed the card's
// shared memory are refused (raster_bucket_fwd*_smem_limit), never
// truncated. Making it fast (sharing a cell's spans, TMA staging) is later
// work.
// The stochastic form (template flag STOCH; entries <name>_stoch) replaces
// each clamped alpha by the binary accept of the TPU kernel's stream
// (response::hash_uniform, stochastic_accept) keyed per merged chunk as it
// keys it (raster_bucket.py:744-745): key seed + t * n_chunks + m / chunk,
// lane m % chunk, where m is the lane's merged place (dead head lanes
// counted: lo + j before the cull compacts it, staged beside the id) and
// n_chunks the chunks of all six spans' caps. A rejected lane is skipped
// as a failed cutoff is. The deterministic form compiles as it did.
// The key-row form (template flag KEYROW; entries <name>_keyrow and
// <name>_stoch_keyrow, gs2d) replaces raster_bucket.py:653-660's
// key_is_row: the merge reads the key row after the model's rows (the
// host sorter's rank, one more row of the attrs, bucket::merge_row) in
// place of the depth row; the blend, the cull and the depth pick read the
// model's rows as before. The flag moves one address, so the forms
// without it compile as they did (probes/sass_diff.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_bucket.cuh"
#include "response.cuh"
#include "smem.cuh"

namespace {

using bucket::PIX;
constexpr int OUT_ROWS = 5;        // rgb, T, depth

template <class M, bool STOCH, bool KEYROW>
__global__ void __launch_bounds__(PIX)
raster_bucket_fwd_kernel(const float* __restrict__ attrs, long long stride,
                         const int* __restrict__ ids,
                         const int* __restrict__ bucket_starts,
                         const int* __restrict__ span_buckets,
                         const float* __restrict__ pix_ctx, int tiles_x, int c_total,
                         int cap0, int cap1, int cap2, int cap3, int chunk,
                         response::Params prm, float min_transmittance, float depth_iso,
                         float* __restrict__ out, int* __restrict__ out_id,
                         int* __restrict__ kept, unsigned seed) {
  // the forward slots are the backward slots before DEPTH_SLOT, then the depth
  static_assert(M::FWD_SLOTS == M::DEPTH_SLOT + 1 && M::DEPTH_SLOT <= M::BWD_SLOTS,
                "forward slots are not the backward ones plus the depth");
  extern __shared__ float smem[];
  float* keys = smem;                                    // [c_total]
  int* order = (int*)(keys + c_total);                   // [c_total]
  float* s_attr = (float*)(order + c_total);             // [FWD_SLOTS][chunk]
  int* s_id = (int*)(s_attr + M::FWD_SLOTS * chunk);     // [chunk]
  int* s_lane = s_id + chunk;                            // [chunk] STOCH: m % chunk
  __shared__ int s_count[2][bucket::WARPS];              // response::kept_place's buffers
  __shared__ bucket::Spans sp;
  __shared__ typename M::TileBound bound;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  if (i == 0) bucket::tile_spans(sp, bucket_starts, span_buckets, t, cap0, cap1, cap2, cap3);
  __syncthreads();
  bucket::merge_spans(sp, attrs + bucket::merge_row<M, KEYROW>() * stride, keys, order);

  const response::Pixel pix = response::load_pixel(t, tiles_x, i, pix_ctx);
  M::tile_bound(bound, t, tiles_x, pix);
  const int n_head = sp.n_head;
  const int end = n_head + sp.off[bucket::NUM_SPANS];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  int pick = -1;
  bool picked = false;
  int n_kept_tile = 0;

  // chunks wholly inside the dead head lanes change nothing: start at the
  // chunk that holds lane n_head
  for (int s = n_head - n_head % chunk; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int lo = max(s, n_head);
    const int n = e - lo;
    // Stage the step's kept lanes, compacted in their merged order. A lane
    // whose alpha fails at every pixel of the tile (and a merged lane
    // where no candidate landed) would change nothing: it is not staged.
    int n_kept = 0;
    for (int r0 = 0; r0 < n; r0 += PIX) {
      const int j = r0 + i;
      float lane_slots[M::BWD_SLOTS];
      long long col = -1;
      bool keep = false;
      const int g = j < n ? order[lo - n_head + j] : -1;
      if (g >= 0) {
        const int sp_i = bucket::span_of(sp, g);
        col = sp.start[sp_i] + (g - sp.off[sp_i]);
        M::stage_bwd(attrs, stride, col, lane_slots, 1, 0);
        keep = M::may_hit(lane_slots, 1, 0, bound, prm);
      }
      const int at = response::kept_place(keep, r0 / PIX, s_count, n_kept);
      if (keep) {
        #pragma unroll
        for (int r = 0; r < M::DEPTH_SLOT; ++r) s_attr[r * chunk + at] = lane_slots[r];
        s_attr[M::DEPTH_SLOT * chunk + at] = attrs[M::DEPTH_ROW * stride + col];
        s_id[at] = ids[col];
        if constexpr (STOCH) s_lane[at] = lo + j - s;  // s is a multiple of chunk
      }
    }
    n_kept_tile += n_kept;
    __syncthreads();
    // STOCH: the chunk's key, raster_bucket.py:744-745
    const unsigned key = seed + (unsigned)(t * ((c_total + chunk - 1) / chunk) + s / chunk);
    if (T > min_transmittance) {  // per-step freeze, rasterize_pallas.py:286
      for (int j = 0; j < n_kept; ++j) {
        float a;
        typename M::Hit h;
        if (!M::eval(s_attr, chunk, j, pix, prm, a, h)) continue;  // alpha = 0
        a = fminf(a, prm.alpha_clamp);
        if constexpr (STOCH) {
          a = response::stochastic_accept(a, response::hash_uniform(key, i, s_lane[j]));
          if (a == 0.0f) continue;  // rejected: alpha = 0
        }
        const float w = a * T;
        cr += w * s_attr[6 * chunk + j];
        cg += w * s_attr[7 * chunk + j];
        cb += w * s_attr[8 * chunk + j];
        T *= 1.0f - a;
        if (!picked && T < depth_iso) {
          picked = true;
          depth = s_attr[M::DEPTH_SLOT * chunk + j];
          pick = s_id[j];
        }
      }
    }
    s = e;
    // all pixels frozen: nothing later can change the tile. Also the
    // barrier before the next step overwrites shared memory.
    if (!__syncthreads_or(T > min_transmittance)) break;
  }

  float* o = out + (size_t)t * OUT_ROWS * PIX;
  o[0 * PIX + i] = cr;
  o[1 * PIX + i] = cg;
  o[2 * PIX + i] = cb;
  o[3 * PIX + i] = T;
  o[4 * PIX + i] = depth;
  out_id[(size_t)t * PIX + i] = pick;
  if (i == 0 && n_kept_tile > 0) atomicAdd(kept, n_kept_tile);  // integers: deterministic
}

template <class M, bool STOCH = false>
int smem_of(int c_total, int chunk) {
  return bucket::smem_bytes(c_total, chunk, M::FWD_SLOTS, STOCH ? 2 : 1);
}

template <class M, bool STOCH = false, bool KEYROW = false>
int smem_limit_of() {
  return dynamic_smem_limit((const void*)raster_bucket_fwd_kernel<M, STOCH, KEYROW>);
}

template <class M, bool STOCH = false, bool KEYROW = false>
int launch(const float* attrs, long long stride, const int* ids, const int* bucket_starts,
           const int* span_buckets, const float* pix_ctx, int num_tiles, int tiles_x, int cap0,
           int cap1, int cap2, int cap3, int chunk, float alpha_min, float alpha_clamp,
           float qmax, float min_response, int degree, float min_transmittance,
           float depth_iso, float* out, int* out_id, int* kept, int seed, void* stream) {
  if (chunk < 1 || chunk > bucket::MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const int c_total = cap0 + 2 * cap1 + 2 * cap2 + cap3;
  const int smem = smem_of<M, STOCH>(c_total, chunk);
  if (smem > smem_limit_of<M, STOCH, KEYROW>()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(raster_bucket_fwd_kernel<M, STOCH, KEYROW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const response::Params prm{alpha_min, alpha_clamp, qmax, min_response, degree};
  if (num_tiles > 0) {
    raster_bucket_fwd_kernel<M, STOCH, KEYROW><<<num_tiles, PIX, smem,
                                                 (cudaStream_t)stream>>>(
        attrs, stride, ids, bucket_starts, span_buckets, pix_ctx, tiles_x, c_total, cap0,
        cap1, cap2, cap3, chunk, prm, min_transmittance, depth_iso, out, out_id, kept,
        (unsigned)seed);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block takes for `c_total` lanes (the six
// spans' caps summed) and blend steps of `chunk` lanes, per model.
extern "C" int raster_bucket_fwd_smem(int c_total, int chunk) {
  return smem_of<response::Gs2d>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_gut3d_smem(int c_total, int chunk) {
  return smem_of<response::Gut3d>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_gs2dp_smem(int c_total, int chunk) {
  return smem_of<response::Gs2dp>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_gut3dp_smem(int c_total, int chunk) {
  return smem_of<response::Gut3dp>(c_total, chunk);
}

// The most dynamic shared memory a block may take on the current device.
extern "C" int raster_bucket_fwd_smem_limit() { return smem_limit_of<response::Gs2d>(); }
extern "C" int raster_bucket_fwd_gut3d_smem_limit() { return smem_limit_of<response::Gut3d>(); }
extern "C" int raster_bucket_fwd_gs2dp_smem_limit() { return smem_limit_of<response::Gs2dp>(); }
extern "C" int raster_bucket_fwd_gut3dp_smem_limit() { return smem_limit_of<response::Gut3dp>(); }

// Launch one block per tile on `stream`; return cudaGetLastError(). gs2d
// reads no pixel context (pix_ctx may be null); gut3d reads the (T, 8, 256)
// one. kept must hold 0 on entry: each tile block adds the number of lanes
// its cull kept, over the blend steps it entered (one integer atomic each).
// seed: the stochastic stream's (read by the _stoch entries alone).
#define RASTER_BUCKET_FWD_PARAMS                                                             \
  const float *attrs, long long stride, const int *ids, const int *bucket_starts,          \
      const int *span_buckets, const float *pix_ctx, int num_tiles, int tiles_x, int cap0, \
      int cap1, int cap2, int cap3, int chunk, float alpha_min, float alpha_clamp,          \
      float qmax, float min_response, int degree, float min_transmittance,                  \
      float depth_iso, float *out, int *out_id, int *kept, int seed, void *stream
#define RASTER_BUCKET_FWD_ARGS                                                               \
  attrs, stride, ids, bucket_starts, span_buckets, pix_ctx, num_tiles, tiles_x, cap0, cap1, \
      cap2, cap3, chunk, alpha_min, alpha_clamp, qmax, min_response, degree,                \
      min_transmittance, depth_iso, out, out_id, kept, seed, stream

extern "C" int raster_bucket_fwd(RASTER_BUCKET_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_gut3d(RASTER_BUCKET_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d>(RASTER_BUCKET_FWD_ARGS);
}

// The packed tier (forward only): gs2dp's 7 rows, gut3dp's 10.
extern "C" int raster_bucket_fwd_gs2dp(RASTER_BUCKET_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2dp>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_gut3dp(RASTER_BUCKET_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3dp>(RASTER_BUCKET_FWD_ARGS);
}

// The stochastic forms of the four, with their shared memory queries.
extern "C" int raster_bucket_fwd_stoch(RASTER_BUCKET_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d, true>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_gut3d_stoch(RASTER_BUCKET_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d, true>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_gs2dp_stoch(RASTER_BUCKET_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2dp, true>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_gut3dp_stoch(RASTER_BUCKET_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3dp, true>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_stoch_smem(int c_total, int chunk) {
  return smem_of<response::Gs2d, true>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_gut3d_stoch_smem(int c_total, int chunk) {
  return smem_of<response::Gut3d, true>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_gs2dp_stoch_smem(int c_total, int chunk) {
  return smem_of<response::Gs2dp, true>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_gut3dp_stoch_smem(int c_total, int chunk) {
  return smem_of<response::Gut3dp, true>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_stoch_smem_limit() {
  return smem_limit_of<response::Gs2d, true>();
}
extern "C" int raster_bucket_fwd_gut3d_stoch_smem_limit() {
  return smem_limit_of<response::Gut3d, true>();
}
extern "C" int raster_bucket_fwd_gs2dp_stoch_smem_limit() {
  return smem_limit_of<response::Gs2dp, true>();
}
extern "C" int raster_bucket_fwd_gut3dp_stoch_smem_limit() {
  return smem_limit_of<response::Gut3dp, true>();
}

// The key-row forms of gs2d (deterministic and stochastic): the attrs carry
// one row more, the key row 10, on which the spans merge.
extern "C" int raster_bucket_fwd_keyrow(RASTER_BUCKET_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d, false, true>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_stoch_keyrow(RASTER_BUCKET_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d, true, true>(RASTER_BUCKET_FWD_ARGS);
}

extern "C" int raster_bucket_fwd_keyrow_smem(int c_total, int chunk) {
  return smem_of<response::Gs2d>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_stoch_keyrow_smem(int c_total, int chunk) {
  return smem_of<response::Gs2d, true>(c_total, chunk);
}
extern "C" int raster_bucket_fwd_keyrow_smem_limit() {
  return smem_limit_of<response::Gs2d, false, true>();
}
extern "C" int raster_bucket_fwd_stoch_keyrow_smem_limit() {
  return smem_limit_of<response::Gs2d, true, true>();
}
