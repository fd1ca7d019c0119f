// Pair-list tile blender, forward, for the gs2d and gut3d response models:
// K1.
//
// Replaces the Pallas kernel rasterize_pallas._make_fwd_kernel
// (vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:202) on the 3DGS,
// 3DGUT and 3DGRT raster frames. It computes what that kernel computes for
// each model; it does not copy its block structure (a sequential grid over
// a packed schedule, 128-lane DMA blocks, a log-shift transmittance scan,
// the gut3d pixel context DMA'd and transposed per tile), which exists for
// the TPU. The model is a template parameter (csrc/response.cuh); one C
// entry point per model.
//
// Design: one thread block per 16x16 tile, one thread per pixel. A thread
// holds its pixel's center and, for gut3d, its ray (six floats of the
// per-tile pixel context, read once per tile into registers). The block
// walks its tile's [start, end) range of depth-sorted pairs in steps that
// end at the blend-chunk boundaries of the global pair index
// (p % chunk == 0) and at the tile's end. Each step's lanes are staged in
// shared memory as the model's slots (gs2d: its ten rows; gut3d: position,
// 1/scale, rgb, the rotation's nine entries, opacity, depth), the splat id
// as int32 beside them; then every pixel blends them front to back:
//   a = the model's alpha (0 where its cutoffs drop the pair), clamped;
//   rgb += a*T*color;  T *= 1 - a;
//   depth and id are picked at the first pair with T < depth_iso and a > 0.
// A pixel freezes (contributes nothing more) when its T at the start of a
// step is <= min_transmittance, exactly the TPU kernel's per-step freeze,
// and the block stops once all 256 pixels are frozen (__syncthreads_or).
// Every tile is written, empty tiles as rgb 0, T 1, depth 0, id -1.
//
// What bounds it on the H100: f32 operations per (pixel, pair), about 17
// for gs2d and 68 for gut3d (the canonical ray, an rsqrtf and an expf),
// plus the blend per hit; the attribute reads are amortised over the
// tile's 256 pixels through shared memory (broadcast reads, no bank
// conflicts), and gut3d's per-lane rotation is built once per lane, not
// per pixel. Built with exact expf, without fast math and with -fmad=false
// (ops/_build.py): the cutoffs flip whole contributions, so each alpha is
// rounded op for op as the plain PyTorch twin rounds it. wgmma and TMA are
// not used yet: making this kernel fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "response.cuh"

namespace {

using response::PIX;
constexpr int MAX_CHUNK = 256;     // largest blend step staged at once
constexpr int OUT_ROWS = 5;        // rgb, T, depth

template <class M>
__global__ void __launch_bounds__(PIX)
rasterize_fwd_kernel(const float* __restrict__ attrs, long long pair_stride,
                     const int* __restrict__ ids,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ pix_ctx, int tiles_x, int chunk,
                     response::Params prm, float min_transmittance,
                     float depth_iso, float* __restrict__ out,
                     int* __restrict__ out_id) {
  __shared__ float s_attr[M::FWD_SLOTS * MAX_CHUNK];
  __shared__ int s_id[MAX_CHUNK];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const response::Pixel pix = response::load_pixel(t, tiles_x, i, pix_ctx);
  const int start = tile_start[t];
  const int end = start + tile_count[t];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  int pick = -1;
  bool picked = false;

  for (int s = start; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int n = e - s;
    for (int j = i; j < n; j += PIX) {
      M::stage_fwd(attrs, pair_stride, s + j, s_attr, MAX_CHUNK, j);
      s_id[j] = ids[s + j];
    }
    __syncthreads();
    if (T > min_transmittance) {  // per-step freeze, rasterize_pallas.py:286
      for (int j = 0; j < n; ++j) {
        float a;
        typename M::Hit h;
        if (!M::eval(s_attr, MAX_CHUNK, j, pix, prm, a, h)) continue;  // alpha = 0
        a = fminf(a, prm.alpha_clamp);
        const float w = a * T;
        cr += w * s_attr[6 * MAX_CHUNK + j];
        cg += w * s_attr[7 * MAX_CHUNK + j];
        cb += w * s_attr[8 * MAX_CHUNK + j];
        T *= 1.0f - a;
        if (!picked && T < depth_iso) {
          picked = true;
          depth = s_attr[M::DEPTH_SLOT * MAX_CHUNK + j];
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
int launch(const float* attrs, long long pair_stride, const int* ids, const int* tile_start,
           const int* tile_count, const float* pix_ctx, int num_tiles, int tiles_x, int chunk,
           float alpha_min, float alpha_clamp, float qmax, float min_response, int degree,
           float min_transmittance, float depth_iso, float* out, int* out_id, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const response::Params prm{alpha_min, alpha_clamp, qmax, min_response, degree};
  if (num_tiles > 0) {
    rasterize_fwd_kernel<M><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_stride, ids, tile_start, tile_count, pix_ctx, tiles_x, chunk, prm,
        min_transmittance, depth_iso, out, out_id);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one block per tile on `stream`; return cudaGetLastError(). gs2d
// reads no pixel context (pix_ctx may be null); gut3d reads the (T, 8, 256)
// one.
extern "C" int rasterize_fwd(const float* attrs, long long pair_stride, const int* ids,
                             const int* tile_start, const int* tile_count,
                             const float* pix_ctx, int num_tiles, int tiles_x, int chunk,
                             float alpha_min, float alpha_clamp, float qmax,
                             float min_response, int degree, float min_transmittance,
                             float depth_iso, float* out, int* out_id, void* stream) {
  return launch<response::Gs2d>(attrs, pair_stride, ids, tile_start, tile_count, nullptr,
                                num_tiles, tiles_x, chunk, alpha_min, alpha_clamp, qmax,
                                min_response, degree, min_transmittance, depth_iso, out,
                                out_id, stream);
}

extern "C" int rasterize_fwd_gut3d(const float* attrs, long long pair_stride, const int* ids,
                                   const int* tile_start, const int* tile_count,
                                   const float* pix_ctx, int num_tiles, int tiles_x, int chunk,
                                   float alpha_min, float alpha_clamp, float qmax,
                                   float min_response, int degree, float min_transmittance,
                                   float depth_iso, float* out, int* out_id, void* stream) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d>(attrs, pair_stride, ids, tile_start, tile_count, pix_ctx,
                                 num_tiles, tiles_x, chunk, alpha_min, alpha_clamp, qmax,
                                 min_response, degree, min_transmittance, depth_iso, out,
                                 out_id, stream);
}
