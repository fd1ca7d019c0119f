// Pair-list tile blender, backward, for the gs2d and gut3d response
// models and the mesh-composited frame's gs2d_clip and tri2d: K2.
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
// (p % chunk == 0) and recomputes alpha and T front to back, with the
// forward's per-step freeze (a pixel is live for a step iff its T at the
// step's start is > min_transmittance). From the per-pixel context (g_rgb,
// S_total = out_rgb . g_rgb, g_T * T_final; built by
// ops/rasterize.bwd_context) each pixel keeps a running s_run = sum of
// w*cg over the pairs so far, so the colour still to come is
// S_total - s_run and one forward sweep suffices:
//   cg = g_rgb . c,  w = a*T,  s_run += w*cg,
//   dalpha = T*cg - (S_total - s_run + g_T*T_final) / max(1 - a, 1 - alpha_clamp)
//   dcolor = g_rgb * w,  and the model's VJP for the geometry rows
//   (zero where the cutoffs drop the pair or the clamp binds).
//
// What bounds it on the H100: per (pixel, pair) the forward's alpha (gs2d
// about 17 f32 operations, gut3d about 68), per hit the gradient (gs2d
// about 35, gut3d about 130) and per pair a reduction of its gradient rows
// (9 for gs2d, 14 for gut3d) over the tile's 256 pixels. Measured on an
// H100 before this design (PERF.md §6): alpha and staging about half the
// time, the per-row warp sums a third to two fifths, the VJP the rest. Two
// levers, per model as csrc/response.cuh sets them; neither moves a bit:
// 1. The cull (CULL_PAIRS: gs2d). Each step first stages its pairs in
//    registers, one per thread, and asks the model's per-tile predicate
//    (response.cuh may_hit, the one K3 and K4 use: false only where eval
//    fails at every pixel of the tile); response::kept_place compacts the
//    kept pairs in pair order into shared memory with their offsets in the
//    step, and the sweep runs over them alone. A culled pair changes no T,
//    s_run or sum, and gets no store: d_attrs arrives zeroed, so its column
//    stays 0. The steps' boundaries, the per-step freeze and the early exit
//    stay where they were; a step whose pairs are all culled still counts
//    as a step. A gs2d pair list is cut to the splat's square rect
//    (ops/binning.py), and the exact ellipse culls about a quarter of it.
//    gut3d's UT rect already bounds the opacity: the cull kept 96 % of its
//    pairs and its f64 tests cost more than they saved, so gut3d stages
//    every pair straight into shared memory.
// 2. The batched reduction. A warp reduces G = PAIR_GROUP consecutive kept
//    pairs at once (3 for gs2d; 1 for gut3d, whose 14 rows held through a
//    second pair's VJP cost more registers than two pairs saved): each lane
//    holds its pixel's G * GRAD_ROWS gradient values (zero where it did not
//    hit), padded to N = 32 (or 16), and a recursive-halving reduce-scatter
//    (xor 16, 8, 4, 2, 1; each round sends half the values still held and
//    adds the partner's half, once they fit) leaves in lane k the warp's
//    sum of value k % N: 31 shuffles in all, against 5 * GRAD_ROWS * G for
//    a warp_sum per row (135 for three gs2d pairs, 70 for a gut3d pair).
//    Each value is summed by the butterfly warp_sum uses (the pairs at xor
//    16 first, then 8, 4, 2, 1), so the sums are the same bits. Lane k
//    stores its sum to the warp's partial row itself; a group no pixel of
//    the warp hits stores zeros, one store per lane. Then the 8 warps'
//    partials are summed in a fixed order, one plain store per (row, pair).
// Built for 4 blocks per SM (64 registers a thread, a few spilled): more
// registers and fewer blocks ran slower for both models.
// Why no atomics: every pair lies in exactly one tile's range, so the block
// that owns the tile writes d_attrs[:, p] with a plain store. (The TPU
// kernel read-modify-writes its d_attrs blocks only because its 128-lane
// blocks straddle tiles.) The result repeats bit for bit. Pairs past a
// block's early exit and past num_pairs are never visited, and the depth
// row is never written. Built like the forward with exact expf, no fast
// math and -fmad=false, so its alphas equal K1's and the plain twin's bit
// for bit.
// The stochastic form (template flag STOCH; entries <name>_stoch) draws
// K1's accepts (key seed + p / chunk, lane p % chunk, p = s + the kept
// pair's offset in its step, which the staging keeps) and, as jax.vjp of
// the JAX accept gives none, takes no gradient through alpha: M::vjp is not
// called, the geometry rows sum exact zeros and the colour rows g_rgb * w.
// The reductions are unchanged, so it repeats bit for bit too.
// The mesh forms (csrc/response.cuh): gs2d_clip is gs2d's VJP where the
// pixel's depth limit keeps the pair (its backward slots carry the depth);
// tri2d blends an unclamped alpha of 1 (CLAMP: T after a covering face is
// exactly 0, so later faces get w = 0), its VJP writes zeros on the vertex
// rows and the colour rows get g_rgb * w; it does not cull its pair lists.

#include <cuda_runtime.h>
#include <stdint.h>

#include "response.cuh"

namespace {

using response::PIX;
using response::WARPS;
constexpr int MAX_CHUNK = 256;     // largest blend step staged at once: one pair per thread
constexpr int CTX_ROWS = 5;        // g_r, g_g, g_b, S_total, g_T * T_final
// blocks per SM the kernel is built for: at most 64 registers a thread (on
// an H100 more registers and fewer blocks ran slower, both models)
constexpr int MIN_BLOCKS = 4;

// Lane l holds N values (N = 16 or 32); leaves in v[0] of lane l the
// warp's sum of value l % N, summed as a warp_sum butterfly sums each value:
// the round at xor H adds the partner's copy, for H = 16, 8, 4, 2, 1. While
// H >= N every value is exchanged; then each round keeps half of the
// values still held (the upper half where lane bit H is set) and sends the
// other half, so lane l ends holding value l % N.
template <int N, int H = 16>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (H >= N) {
    #pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], H);
  } else {
    const bool upper = (lane & H) != 0;
    #pragma unroll
    for (int k = 0; k < H; ++k) {
      const float send = upper ? v[k] : v[k + H];
      const float keep = upper ? v[k + H] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
  }
  if constexpr (H > 1) reduce_scatter<N, H / 2>(v, lane);
}

template <class M, bool STOCH>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
rasterize_bwd_kernel(const float* __restrict__ attrs, long long pair_stride,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ ctx, const float* __restrict__ pix_ctx,
                     int tiles_x, int chunk, response::Params prm,
                     float min_transmittance, float* __restrict__ d_attrs,
                     int* __restrict__ kept, unsigned seed) {
  constexpr int GRAD_ROWS = M::GRAD_ROWS;
  constexpr int G = M::PAIR_GROUP;               // pairs per warp reduction
  static_assert(G >= 1 && G * GRAD_ROWS <= 32, "a reduction sums at most 32 values");
  constexpr int VALS = G * GRAD_ROWS;            // values a reduction sums
  constexpr int N = VALS > 16 ? 32 : 16;         // values a lane holds
  constexpr int SUB = (32 / G) * G;              // pairs per shared-memory batch
  __shared__ float s_attr[M::BWD_SLOTS * MAX_CHUNK];
  __shared__ float s_part[WARPS][GRAD_ROWS][SUB];
  __shared__ int s_col[MAX_CHUNK];               // a kept pair's offset in its step
  __shared__ int s_count[2][WARPS];              // response::kept_place's buffers
  __shared__ typename M::TileBound bound;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const response::Pixel pix = response::model_pixel<M>(t, tiles_x, i, pix_ctx);
  if constexpr (M::CULL_PAIRS) M::tile_bound(bound, t, tiles_x, pix);
  const int start = tile_start[t];
  const int end = start + tile_count[t];

  const float* c = ctx + (size_t)t * CTX_ROWS * PIX;
  const float gr = c[0 * PIX + i];
  const float gg = c[1 * PIX + i];
  const float gb = c[2 * PIX + i];
  const float s_total = c[3 * PIX + i];
  const float gt_tn = c[4 * PIX + i];
  const float q_min = 1.0f - prm.alpha_clamp;

  // what lane k stores: value k is row k % GRAD_ROWS of the group's pair k / GRAD_ROWS
  const int my_pair = lane / GRAD_ROWS, my_row = lane % GRAD_ROWS;
  float T = 1.0f, s_run = 0.0f;
  int n_kept_tile = 0;
  for (int s = start; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int n = e - s;
    // Stage the step's kept pairs, compacted in pair order: thread i takes
    // pair s + r0 + i of each round of PIX pairs (one round, as n <= PIX),
    // stages it in registers and asks may_hit. A model that does not cull
    // its pair lists stages every pair straight into shared memory.
    int n_kept = 0;
    if constexpr (M::CULL_PAIRS) {
      for (int r0 = 0; r0 < n; r0 += PIX) {
        const int j = r0 + i;
        float slots[M::BWD_SLOTS];
        bool keep = false;
        if (j < n) {
          M::stage_bwd(attrs, pair_stride, s + j, slots, 1, 0);
          keep = M::may_hit(slots, 1, 0, bound, prm);
        }
        const int before = response::kept_place(keep, r0 / PIX, s_count, n_kept);
        if (keep) {
          #pragma unroll
          for (int r = 0; r < M::BWD_SLOTS; ++r) s_attr[r * MAX_CHUNK + before] = slots[r];
          s_col[before] = j;
        }
      }
    } else {
      for (int j = i; j < n; j += PIX) {
        M::stage_bwd(attrs, pair_stride, s + j, s_attr, MAX_CHUNK, j);
        s_col[j] = j;
      }
      n_kept = n;
    }
    n_kept_tile += n_kept;
    __syncthreads();
    const bool live = T > min_transmittance;  // per-step freeze, as the forward
    for (int j0 = 0; j0 < n_kept; j0 += SUB) {
      const int m = min(SUB, n_kept - j0);
      #pragma unroll 1
      for (int jj = 0; jj < m; jj += G) {
        float v[N];
        #pragma unroll
        for (int k = 0; k < N; ++k) v[k] = 0.0f;
        bool hit = false;
        #pragma unroll
        for (int p = 0; p < G; ++p) {
          const int j = j0 + jj + p;
          float a_raw;
          typename M::Hit h;
          if (live && jj + p < m && M::eval(s_attr, MAX_CHUNK, j, pix, prm, a_raw, h)) {
            hit = true;
            float* g = v + p * GRAD_ROWS;
            float a = M::CLAMP ? fminf(a_raw, prm.alpha_clamp) : a_raw;
            if constexpr (STOCH) {
              const int pair = s + s_col[j];
              a = response::stochastic_accept(
                  a, response::hash_uniform(seed + (unsigned)(pair / chunk), i, pair % chunk));
            }
            const float w = a * T;
            const float cgv = gr * s_attr[6 * MAX_CHUNK + j] + gg * s_attr[7 * MAX_CHUNK + j] +
                              gb * s_attr[8 * MAX_CHUNK + j];
            s_run += w * cgv;
            const float q = 1.0f - a;
            if constexpr (!STOCH) {
              const float dalpha = T * cgv - ((s_total - s_run) + gt_tn) / fmaxf(q, q_min);
              const float da = a_raw <= prm.alpha_clamp ? dalpha : 0.0f;
              M::vjp(s_attr, MAX_CHUNK, j, pix, prm, h, a_raw, da, g);
            }
            g[6] = gr * w;
            g[7] = gg * w;
            g[8] = gb * w;
            T *= q;
          }
        }
        // a group none of whose pairs a pixel of the warp touches adds exact zeros
        if (__any_sync(0xffffffffu, hit)) reduce_scatter(v, lane);
        if (lane < VALS && jj + my_pair < m) s_part[warp][my_row][jj + my_pair] = v[0];
      }
      __syncthreads();
      // warps summed in a fixed order; one plain store per (row, kept pair)
      for (int k = i; k < GRAD_ROWS * SUB; k += PIX) {
        const int r = k / SUB, jj = k % SUB;
        if (jj < m) {
          float v = 0.0f;
          #pragma unroll
          for (int w8 = 0; w8 < WARPS; ++w8) v += s_part[w8][r][jj];
          d_attrs[r * pair_stride + s + s_col[j0 + jj]] = v;
        }
      }
      __syncthreads();  // s_part is rewritten by the next batch
    }
    s = e;
    // all pixels frozen: every later pair's gradient is zero. Also the
    // barrier before the next step overwrites s_attr and s_col.
    if (!__syncthreads_or(T > min_transmittance)) break;
  }
  if (i == 0 && n_kept_tile > 0) atomicAdd(kept, n_kept_tile);  // integers: deterministic
}

template <class M, bool STOCH = false>
int launch(const float* attrs, long long pair_stride, const int* tile_start,
           const int* tile_count, const float* ctx, const float* pix_ctx, int num_tiles,
           int tiles_x, int chunk, float alpha_min, float alpha_clamp, float qmax,
           float min_response, int degree, float min_transmittance, float* d_attrs, int* kept,
           int seed, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const response::Params prm{alpha_min, alpha_clamp, qmax, min_response, degree};
  if (num_tiles > 0) {
    rasterize_bwd_kernel<M, STOCH><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_stride, tile_start, tile_count, ctx, pix_ctx, tiles_x, chunk, prm,
        min_transmittance, d_attrs, kept, (unsigned)seed);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one block per tile on `stream`; return cudaGetLastError().
// d_attrs must hold zeros on entry. gs2d and tri2d read no pixel context
// (pix_ctx may be null); gut3d and gs2d_clip read the (T, 8, 256) one. kept must hold 0 on
// entry: each block adds the number of pairs its cull kept, over the blend
// steps it entered (one integer atomic each). seed: the stochastic
// stream's (read by the _stoch entries alone).
#define RASTERIZE_BWD_PARAMS                                                                  \
  const float *attrs, long long pair_stride, const int *tile_start, const int *tile_count,  \
      const float *ctx, const float *pix_ctx, int num_tiles, int tiles_x, int chunk,         \
      float alpha_min, float alpha_clamp, float qmax, float min_response, int degree,        \
      float min_transmittance, float *d_attrs, int *kept, int seed, void *stream
#define RASTERIZE_BWD_ARGS                                                                    \
  attrs, pair_stride, tile_start, tile_count, ctx, pix_ctx, num_tiles, tiles_x, chunk,       \
      alpha_min, alpha_clamp, qmax, min_response, degree, min_transmittance, d_attrs, kept,  \
      seed, stream

extern "C" int rasterize_bwd(RASTERIZE_BWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d>(RASTERIZE_BWD_ARGS);
}

extern "C" int rasterize_bwd_gut3d(RASTERIZE_BWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d>(RASTERIZE_BWD_ARGS);
}

// The stochastic forms.
extern "C" int rasterize_bwd_stoch(RASTERIZE_BWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d, true>(RASTERIZE_BWD_ARGS);
}

extern "C" int rasterize_bwd_gut3d_stoch(RASTERIZE_BWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d, true>(RASTERIZE_BWD_ARGS);
}

// The mesh-composited frame: the splat pass behind the mesh depth (and its
// stochastic form), and the flat triangles' face colours.
extern "C" int rasterize_bwd_gs2d_clip(RASTERIZE_BWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gs2dClip>(RASTERIZE_BWD_ARGS);
}

extern "C" int rasterize_bwd_gs2d_clip_stoch(RASTERIZE_BWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gs2dClip, true>(RASTERIZE_BWD_ARGS);
}

extern "C" int rasterize_bwd_tri2d(RASTERIZE_BWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Tri2d>(RASTERIZE_BWD_ARGS);
}
