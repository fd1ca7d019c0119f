// Bucket-grid tile rasterizer, forward, for the gs2d and gut3d response
// models: K3.
//
// Replaces the Pallas kernel raster_bucket._make_kernel
// (vk_gaussian_splatting_tpu/ops/raster_bucket.py:469). It computes what
// that kernel computes for each model; it drops the TPU mechanics (tiles
// per grid step, the 4x4-tile cell grid, the DMA staging, the odd-even
// merge network, the gut3d pixel context DMA'd and transposed per tile)
// and keeps the two things the outputs depend on exactly: the capacity
// accounting with its 128-alignment head and the freeze positions
// (csrc/raster_bucket.cuh). The model is a template parameter
// (csrc/response.cuh); one C entry point per model.
//
// Design: one thread block per 16x16 tile, one thread per pixel.
// 1. Thread 0 reads the tile's six window spans from bucket_starts.
// 2. The block merges the spans' live candidates into one list ordered by
//    (depth, span, position), the depth being the model's depth row: keys
//    and lane indices only, in dynamic shared memory (8 bytes per lane the
//    caps allow: 24 KB at 3,072).
// 3. The block blends the list front to back in steps that end at the
//    merged lanes n_head + r that are multiples of `chunk` (the bucket
//    blend chunk, 384 by default): each step's lanes are gathered into
//    shared memory as the model's slots, with the int32 id, and every
//    pixel (gut3d: its ray from the pixel context, in registers) runs the
//    pair blender's math (csrc/rasterize_fwd.cu), with its per-step freeze
//    and its first-crossing depth and id pick. The block stops once all
//    256 pixels froze. Every tile is written: empty ones as rgb 0, T 1,
//    depth 0, id -1.
//
// What bounds it on the H100: f32 operations per (pixel, lane), as K1 (about
// 17 for gs2d, 68 for gut3d); but a tile blends its whole window (its own
// fine bucket and the mid, coarse and global spans that neighbouring tiles
// also read), so each tile re-reads its shared spans' rows from device
// memory (mostly from L2) and the merge costs five binary searches per
// lane. The merge and the row gathers are what K1 does not pay. Built with
// exact expf, without fast math and with -fmad=false (ops/_build.py), so
// its alphas equal the plain twin's bit for bit. Caps whose lanes exceed the
// card's shared memory are refused (raster_bucket_fwd*_smem_limit), never
// truncated. Making it fast (sharing a cell's spans, TMA staging) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_bucket.cuh"
#include "response.cuh"
#include "smem.cuh"

namespace {

using bucket::PIX;
constexpr int OUT_ROWS = 5;        // rgb, T, depth

template <class M>
__global__ void __launch_bounds__(PIX)
raster_bucket_fwd_kernel(const float* __restrict__ attrs, long long stride,
                         const int* __restrict__ ids,
                         const int* __restrict__ bucket_starts,
                         const int* __restrict__ span_buckets,
                         const float* __restrict__ pix_ctx, int tiles_x, int c_total,
                         int cap0, int cap1, int cap2, int cap3, int chunk,
                         response::Params prm, float min_transmittance, float depth_iso,
                         float* __restrict__ out, int* __restrict__ out_id) {
  extern __shared__ float smem[];
  float* keys = smem;                                    // [c_total]
  int* order = (int*)(keys + c_total);                   // [c_total]
  float* s_attr = (float*)(order + c_total);             // [FWD_SLOTS][chunk]
  int* s_id = (int*)(s_attr + M::FWD_SLOTS * chunk);     // [chunk]
  __shared__ bucket::Spans sp;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  if (i == 0) bucket::tile_spans(sp, bucket_starts, span_buckets, t, cap0, cap1, cap2, cap3);
  __syncthreads();
  bucket::merge_spans(sp, attrs + M::DEPTH_ROW * stride, keys, order);

  const response::Pixel pix = response::load_pixel(t, tiles_x, i, pix_ctx);
  const int n_head = sp.n_head;
  const int end = n_head + sp.off[bucket::NUM_SPANS];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  int pick = -1;
  bool picked = false;

  // chunks wholly inside the dead head lanes change nothing: start at the
  // chunk that holds lane n_head
  for (int s = n_head - n_head % chunk; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int lo = max(s, n_head);
    const int n = e - lo;
    for (int j = i; j < n; j += PIX) {
      const int g = order[lo - n_head + j];
      if (g < 0) {  // no lane: zero slots, an alpha of 0 in every model
        #pragma unroll
        for (int r = 0; r < M::FWD_SLOTS; ++r) s_attr[r * chunk + j] = 0.0f;
        s_id[j] = -1;
        continue;
      }
      const int sp_i = bucket::span_of(sp, g);
      const long long col = sp.start[sp_i] + (g - sp.off[sp_i]);
      M::stage_fwd(attrs, stride, col, s_attr, chunk, j);
      s_id[j] = ids[col];
    }
    __syncthreads();
    if (T > min_transmittance) {  // per-step freeze, rasterize_pallas.py:286
      for (int j = 0; j < n; ++j) {
        float a;
        typename M::Hit h;
        if (!M::eval(s_attr, chunk, j, pix, prm, a, h)) continue;  // alpha = 0
        a = fminf(a, prm.alpha_clamp);
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
}

template <class M>
int smem_of(int c_total, int chunk) {
  return bucket::smem_bytes(c_total, chunk, M::FWD_SLOTS, 1);
}

template <class M>
int smem_limit_of() {
  return dynamic_smem_limit((const void*)raster_bucket_fwd_kernel<M>);
}

template <class M>
int launch(const float* attrs, long long stride, const int* ids, const int* bucket_starts,
           const int* span_buckets, const float* pix_ctx, int num_tiles, int tiles_x, int cap0,
           int cap1, int cap2, int cap3, int chunk, float alpha_min, float alpha_clamp,
           float qmax, float min_response, int degree, float min_transmittance,
           float depth_iso, float* out, int* out_id, void* stream) {
  if (chunk < 1 || chunk > bucket::MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const int c_total = cap0 + 2 * cap1 + 2 * cap2 + cap3;
  const int smem = smem_of<M>(c_total, chunk);
  if (smem > smem_limit_of<M>()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      raster_bucket_fwd_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const response::Params prm{alpha_min, alpha_clamp, qmax, min_response, degree};
  if (num_tiles > 0) {
    raster_bucket_fwd_kernel<M><<<num_tiles, PIX, smem, (cudaStream_t)stream>>>(
        attrs, stride, ids, bucket_starts, span_buckets, pix_ctx, tiles_x, c_total, cap0,
        cap1, cap2, cap3, chunk, prm, min_transmittance, depth_iso, out, out_id);
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

// The most dynamic shared memory a block may take on the current device.
extern "C" int raster_bucket_fwd_smem_limit() { return smem_limit_of<response::Gs2d>(); }
extern "C" int raster_bucket_fwd_gut3d_smem_limit() { return smem_limit_of<response::Gut3d>(); }

// Launch one block per tile on `stream`; return cudaGetLastError(). gs2d
// reads no pixel context (pix_ctx may be null); gut3d reads the (T, 8, 256)
// one.
extern "C" int raster_bucket_fwd(const float* attrs, long long stride, const int* ids,
                                 const int* bucket_starts, const int* span_buckets,
                                 const float* pix_ctx, int num_tiles, int tiles_x, int cap0,
                                 int cap1, int cap2, int cap3, int chunk, float alpha_min,
                                 float alpha_clamp, float qmax, float min_response, int degree,
                                 float min_transmittance, float depth_iso, float* out,
                                 int* out_id, void* stream) {
  return launch<response::Gs2d>(attrs, stride, ids, bucket_starts, span_buckets, nullptr,
                                num_tiles, tiles_x, cap0, cap1, cap2, cap3, chunk, alpha_min,
                                alpha_clamp, qmax, min_response, degree, min_transmittance,
                                depth_iso, out, out_id, stream);
}

extern "C" int raster_bucket_fwd_gut3d(const float* attrs, long long stride, const int* ids,
                                       const int* bucket_starts, const int* span_buckets,
                                       const float* pix_ctx, int num_tiles, int tiles_x,
                                       int cap0, int cap1, int cap2, int cap3, int chunk,
                                       float alpha_min, float alpha_clamp, float qmax,
                                       float min_response, int degree, float min_transmittance,
                                       float depth_iso, float* out, int* out_id,
                                       void* stream) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d>(attrs, stride, ids, bucket_starts, span_buckets, pix_ctx,
                                 num_tiles, tiles_x, cap0, cap1, cap2, cap3, chunk, alpha_min,
                                 alpha_clamp, qmax, min_response, degree, min_transmittance,
                                 depth_iso, out, out_id, stream);
}
