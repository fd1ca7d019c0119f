// Pair-list tile blender, backward, for the gs2d and gut3d response
// models: K2.
//
// Replaces the Pallas kernel rasterize_pallas._make_bwd_kernel
// (vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:367) and the custom
// VJP around it (_rt_bwd, :599). It computes what that kernel computes: the
// gradient of the blended rgb and transmittance with respect to each sorted
// pair's rows: gs2d's x, y, conic a/b/c, opacity and r/g/b; gut3d's
// position, scale, r/g/b, quaternion and opacity. The TPU kernel takes the
// model's VJP with in-kernel jax.vjp; here it is hand-derived, one
// definition per model in csrc/response.cuh (twin: ops/response.py).
//
// Design: like the forward (csrc/rasterize_fwd.cu), one thread block per
// 16x16 tile and one thread per pixel, the model a template parameter. The
// block walks its tile's [start, end) range of depth-sorted pairs in steps
// that end at the blend-chunk boundaries of the global pair index
// (p % chunk == 0), stages each step's lanes in shared memory and
// recomputes alpha and T front to back, with the forward's per-step freeze
// (a pixel is live for a step iff its T at the step's start is >
// min_transmittance). From the per-pixel context (g_rgb, S_total = out_rgb
// . g_rgb, g_T * T_final; built by ops/rasterize.bwd_context) each pixel
// keeps a running s_run = sum of w*cg over the pairs so far, so the colour
// still to come is S_total - s_run and one forward sweep suffices:
//   cg = g_rgb . c,  w = a*T,  s_run += w*cg,
//   dalpha = T*cg - (S_total - s_run + g_T*T_final) / max(1 - a, 1 - alpha_clamp)
//   dcolor = g_rgb * w,  and the model's VJP for the geometry rows
//   (zero where the cutoffs drop the pair or the clamp at alpha_clamp binds).
// Each pair's per-pixel gradients (9 rows for gs2d, 14 for gut3d) are
// summed over the tile's 256 pixels with warp shuffles, then over the 8
// warps through shared memory, always in the same order.
//
// Why no atomics: every pair lies in exactly one tile's range, so the block
// that owns the tile writes d_attrs[:, p] with a plain store. (The TPU
// kernel read-modify-writes its d_attrs blocks only because its 128-lane
// blocks straddle tiles.) The result repeats bit for bit. d_attrs arrives
// zeroed: pairs past a block's early exit and past num_pairs are never
// visited, and the depth row is never written.
//
// What bounds it on the H100: per (pixel, pair) the forward's alpha (gs2d
// about 17 f32 operations, gut3d about 68) plus, per hit, the gradient
// (gs2d about 35 operations, gut3d about 130) and a per-pair reduction over
// the tile: 5 warp shuffles per row per warp and a shared-memory pass. The
// reduction, not memory, is the cost for gs2d; the rows are read once per
// tile through shared memory. Built like the forward with exact expf, no
// fast math and -fmad=false, so its alphas equal K1's and the plain twin's
// bit for bit. Making it fast (batching the reductions, skipping frozen
// warps) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "response.cuh"

namespace {

using response::PIX;
constexpr int WARPS = PIX / 32;
constexpr int MAX_CHUNK = 256;     // largest blend step staged at once
constexpr int CTX_ROWS = 5;        // g_r, g_g, g_b, S_total, g_T * T_final
constexpr int SUB = 32;            // pairs per shared-memory reduction batch

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <class M>
__global__ void __launch_bounds__(PIX)
rasterize_bwd_kernel(const float* __restrict__ attrs, long long pair_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ ctx, const float* __restrict__ pix_ctx,
                     int tiles_x, int chunk, response::Params prm,
                     float min_transmittance, float* __restrict__ d_attrs) {
  constexpr int GRAD_ROWS = M::GRAD_ROWS;
  __shared__ float s_attr[M::BWD_SLOTS * MAX_CHUNK];
  __shared__ float s_part[WARPS][GRAD_ROWS][SUB];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const response::Pixel pix = response::load_pixel(t, tiles_x, i, pix_ctx);
  const int start = tile_start[t];
  const int end = start + tile_count[t];

  const float* c = ctx + (size_t)t * CTX_ROWS * PIX;
  const float gr = c[0 * PIX + i];
  const float gg = c[1 * PIX + i];
  const float gb = c[2 * PIX + i];
  const float s_total = c[3 * PIX + i];
  const float gt_tn = c[4 * PIX + i];
  const float q_min = 1.0f - prm.alpha_clamp;

  float T = 1.0f, s_run = 0.0f;
  for (int s = start; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int n = e - s;
    for (int j = i; j < n; j += PIX) M::stage_bwd(attrs, pair_stride, s + j, s_attr, MAX_CHUNK, j);
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
        if (live && M::eval(s_attr, MAX_CHUNK, j, pix, prm, a_raw, h)) {
          hit = true;
          const float a = fminf(a_raw, prm.alpha_clamp);
          const float w = a * T;
          const float cgv = gr * s_attr[6 * MAX_CHUNK + j] + gg * s_attr[7 * MAX_CHUNK + j] +
                            gb * s_attr[8 * MAX_CHUNK + j];
          s_run += w * cgv;
          const float q = 1.0f - a;
          const float dalpha = T * cgv - ((s_total - s_run) + gt_tn) / fmaxf(q, q_min);
          const float da = a_raw <= prm.alpha_clamp ? dalpha : 0.0f;
          M::vjp(s_attr, MAX_CHUNK, j, pix, prm, h, a_raw, da, g);
          g[6] = gr * w;
          g[7] = gg * w;
          g[8] = gb * w;
          T *= q;
        }
        // a warp none of whose pixels the pair touches adds exact zeros
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
      // warps summed in a fixed order; one plain store per (row, pair)
      for (int k = i; k < GRAD_ROWS * m; k += PIX) {
        const int r = k / m, jj = k % m;
        float v = 0.0f;
        #pragma unroll
        for (int w8 = 0; w8 < WARPS; ++w8) v += s_part[w8][r][jj];
        d_attrs[r * pair_stride + s + j0 + jj] = v;
      }
      __syncthreads();  // s_part is rewritten by the next batch
    }
    s = e;
    // all pixels frozen: every later pair's gradient is zero. Also the
    // barrier before the next step overwrites s_attr.
    if (!__syncthreads_or(T > min_transmittance)) break;
  }
}

template <class M>
int launch(const float* attrs, long long pair_stride, const int* tile_start,
           const int* tile_count, const float* ctx, const float* pix_ctx, int num_tiles,
           int tiles_x, int chunk, float alpha_min, float alpha_clamp, float qmax,
           float min_response, int degree, float min_transmittance, float* d_attrs,
           void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const response::Params prm{alpha_min, alpha_clamp, qmax, min_response, degree};
  if (num_tiles > 0) {
    rasterize_bwd_kernel<M><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_stride, tile_start, tile_count, ctx, pix_ctx, tiles_x, chunk, prm,
        min_transmittance, d_attrs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one block per tile on `stream`; return cudaGetLastError().
// d_attrs must hold zeros on entry. gs2d reads no pixel context (pix_ctx
// may be null); gut3d reads the (T, 8, 256) one.
extern "C" int rasterize_bwd(const float* attrs, long long pair_stride, const int* tile_start,
                             const int* tile_count, const float* ctx, const float* pix_ctx,
                             int num_tiles, int tiles_x, int chunk, float alpha_min,
                             float alpha_clamp, float qmax, float min_response, int degree,
                             float min_transmittance, float* d_attrs, void* stream) {
  return launch<response::Gs2d>(attrs, pair_stride, tile_start, tile_count, ctx, nullptr,
                                num_tiles, tiles_x, chunk, alpha_min, alpha_clamp, qmax,
                                min_response, degree, min_transmittance, d_attrs, stream);
}

extern "C" int rasterize_bwd_gut3d(const float* attrs, long long pair_stride,
                                   const int* tile_start, const int* tile_count,
                                   const float* ctx, const float* pix_ctx, int num_tiles,
                                   int tiles_x, int chunk, float alpha_min, float alpha_clamp,
                                   float qmax, float min_response, int degree,
                                   float min_transmittance, float* d_attrs, void* stream) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d>(attrs, pair_stride, tile_start, tile_count, ctx, pix_ctx,
                                 num_tiles, tiles_x, chunk, alpha_min, alpha_clamp, qmax,
                                 min_response, degree, min_transmittance, d_attrs, stream);
}
