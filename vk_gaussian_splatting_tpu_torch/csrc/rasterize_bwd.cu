// Pair-list tile blender, backward (gs2d response model).
//
// Replaces the Pallas kernel rasterize_pallas._make_bwd_kernel
// (vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:367) and the custom
// VJP around it (_rt_bwd, :599). It computes what that kernel computes for
// gs2d: the gradient of the blended rgb and transmittance with respect to
// each sorted pair's rows x, y, conic a/b/c, opacity and r/g/b.
//
// Design: like the forward (csrc/rasterize_fwd.cu), one thread block per
// 16x16 tile and one thread per pixel. The block walks its tile's
// [start, end) range of depth-sorted pairs in steps that end at the
// blend-chunk boundaries of the global pair index (p % chunk == 0), stages
// each step's rows in shared memory and recomputes alpha and T front to
// back, with the forward's per-step freeze (a pixel is live for a step iff
// its T at the step's start is > min_transmittance). From the per-pixel
// context (g_rgb, S_total = out_rgb . g_rgb, g_T * T_final; built by
// ops/rasterize.bwd_context) each pixel keeps a running s_run = sum of
// w*cg over the pairs so far, so the colour still to come is
// S_total - s_run and one forward sweep suffices:
//   cg = g_rgb . c,  w = a*T,  s_run += w*cg,
//   dalpha = T*cg - (S_total - s_run + g_T*T_final) / max(1 - a, 1 - alpha_clamp)
//   dcolor = g_rgb * w,  and the gs2d VJP for the geometry rows
//   (zero where the cutoffs drop the pair or the clamp at alpha_clamp binds).
// Each pair's nine per-pixel gradients are summed over the tile's 256
// pixels with warp shuffles, then over the 8 warps through shared memory,
// always in the same order.
//
// Why no atomics: every pair lies in exactly one tile's range, so the block
// that owns the tile writes d_attrs[:, p] with a plain store. (The TPU
// kernel read-modify-writes its d_attrs blocks only because its 128-lane
// blocks straddle tiles.) The result repeats bit for bit. d_attrs arrives
// zeroed: pairs past a block's early exit and past num_pairs are never
// visited, and the depth row is never written.
//
// What bounds it on the H100: per (pixel, pair) the forward's alpha (one
// expf, a dozen f32 ops) plus about 35 f32 ops of gradient, and a 9-value
// reduction per pair over the tile: 45 warp shuffles per warp and a
// shared-memory pass. The reduction, not memory, is the cost; the rows are
// read once per tile through shared memory. Built like the forward with
// exact expf, no fast math and -fmad=false, so its alphas equal K1's and
// the plain twin's bit for bit. Making it fast (batching the reductions,
// skipping frozen warps) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per block, pixels per tile
constexpr int WARPS = PIX / 32;
constexpr int MAX_CHUNK = 256;     // largest blend step staged at once
constexpr int GRAD_ROWS = 9;       // x, y, conic a/b/c, opacity, r, g, b
constexpr int CTX_ROWS = 5;        // g_r, g_g, g_b, S_total, g_T * T_final
constexpr int SUB = 32;            // pairs per shared-memory reduction batch

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(PIX)
rasterize_bwd_kernel(const float* __restrict__ attrs, long long pair_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ ctx, int tiles_x, int chunk,
                     float alpha_min, float alpha_clamp, float qmax,
                     float min_transmittance, float* __restrict__ d_attrs) {
  __shared__ float s_attr[GRAD_ROWS][MAX_CHUNK];
  __shared__ float s_part[WARPS][GRAD_ROWS][SUB];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const float px = (float)((t % tiles_x) * TILE + i % TILE) + 0.5f;
  const float py = (float)((t / tiles_x) * TILE + i / TILE) + 0.5f;
  const int start = tile_start[t];
  const int end = start + tile_count[t];

  const float* c = ctx + (size_t)t * CTX_ROWS * PIX;
  const float gr = c[0 * PIX + i];
  const float gg = c[1 * PIX + i];
  const float gb = c[2 * PIX + i];
  const float s_total = c[3 * PIX + i];
  const float gt_tn = c[4 * PIX + i];
  const float q_min = 1.0f - alpha_clamp;

  float T = 1.0f, s_run = 0.0f;
  for (int s = start; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int n = e - s;
    for (int j = i; j < n; j += PIX) {
      #pragma unroll
      for (int r = 0; r < GRAD_ROWS; ++r) s_attr[r][j] = attrs[r * pair_stride + s + j];
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
        if (live) {
          const float ca = s_attr[2][j], cb = s_attr[3][j], cc = s_attr[4][j];
          const float dx = px - s_attr[0][j];
          const float dy = py - s_attr[1][j];
          const float d = ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy;
          const float gauss = expf(-0.5f * d);
          const float a_raw = s_attr[5][j] * gauss;
          if (d <= qmax && a_raw >= alpha_min) {
            hit = true;
            const float a = fminf(a_raw, alpha_clamp);
            const float w = a * T;
            const float cgv = gr * s_attr[6][j] + gg * s_attr[7][j] + gb * s_attr[8][j];
            s_run += w * cgv;
            const float q = 1.0f - a;
            const float dalpha = T * cgv - ((s_total - s_run) + gt_tn) / fmaxf(q, q_min);
            const float da = a_raw <= alpha_clamp ? dalpha : 0.0f;
            const float dd = -0.5f * da * a_raw;
            g[0] = -(dd * (2.0f * ca * dx + 2.0f * cb * dy));
            g[1] = -(dd * (2.0f * cb * dx + 2.0f * cc * dy));
            g[2] = dd * dx * dx;
            g[3] = 2.0f * dd * dx * dy;
            g[4] = dd * dy * dy;
            g[5] = da * gauss;
            g[6] = gr * w;
            g[7] = gg * w;
            g[8] = gb * w;
            T *= q;
          }
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

}  // namespace

// Launches one block per tile on `stream`; returns cudaGetLastError().
// d_attrs must hold zeros on entry.
extern "C" int rasterize_bwd(const float* attrs, long long pair_stride,
                             const int* tile_start, const int* tile_count,
                             const float* ctx, int num_tiles, int tiles_x,
                             int chunk, float alpha_min, float alpha_clamp,
                             float qmax, float min_transmittance,
                             float* d_attrs, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    rasterize_bwd_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_stride, tile_start, tile_count, ctx, tiles_x, chunk,
        alpha_min, alpha_clamp, qmax, min_transmittance, d_attrs);
  }
  return (int)cudaGetLastError();
}
