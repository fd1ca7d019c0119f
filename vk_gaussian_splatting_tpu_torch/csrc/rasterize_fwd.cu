// Pair-list tile blender, forward, for the gs2d and gut3d response models,
// their packed forms gs2dp and gut3dp, and the mesh-composited frame's
// gs2d_clip, tri2d and tri2d_smooth: K1.
//
// Replaces the Pallas kernel rasterize_pallas._make_fwd_kernel
// (vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:202) on the 3DGS,
// 3DGUT and 3DGRT raster frames. It computes what that kernel computes for
// each model; it does not copy its block structure (a sequential grid over
// a packed schedule, 128-lane DMA blocks, a log-shift transmittance scan,
// the gut3d pixel context DMA'd and transposed per tile), which exists for
// the TPU. The model is a template parameter (csrc/response.cuh); one C
// entry point per model. A packed model changes only what a lane's staging
// reads (gs2dp 6-7 words instead of 9-10, gut3dp 9-10 instead of 14-15) and
// unpacks into the same slots; the kernels are the same code.
//
// Design: two launches, each one thread block per 16x16 tile with one
// thread per pixel and the block's eight warps each on an 8x4 block of the
// tile's pixels (response::warp_pixel). A thread holds its pixel's center
// and, for gut3d, its ray (six floats of the per-tile pixel context, read
// once per tile into registers).
// 1. The per-warp cull (warp_mask_kernel). Each warp computes the bound of
//    its 32 pixels (warp_bound: the rectangle of their centres, or the cone
//    of their rays). Threads 2k and 2k + 1 take pair k of each round of 128
//    of the tile's [start, end) range, stage it in registers as the model's
//    backward slots, compute the pair's part of the model's per-tile
//    predicate once (csrc/response.cuh reach: gs2d's inflated box, gut3d's
//    cut distance and scales) and test it against half of the warps' bounds
//    each (reach_hits, the test may_hit runs against a tile's bound): the
//    pair's 8-bit mask, bit w set where warp w may be hit, is one byte of
//    `masks`. No barrier holds these f64 tests back.
// 2. The blend (rasterize_fwd_kernel). The block walks its tile's range of
//    depth-sorted pairs in steps that end at the blend-chunk boundaries of
//    the global pair index (p % chunk == 0) and at the tile's end. Each
//    step reads its pairs' masks, and response::kept_place compacts the
//    pairs with a nonzero mask, in pair order, into shared memory: the
//    model's forward slots (stage_fwd), lane-major and padded to a multiple
//    of 4 floats, the int32 id and the mask. Then each warp walks the kept
//    pairs whose bit it holds, 32 at a time by a ballot of their masks (the
//    skip is warp-uniform), and each of its live pixels blends them front
//    to back, a pair's slots coming into registers by float4 broadcast
//    loads (5 for gut3d, where 16 loads of one float bound the loop before):
//      a = the model's alpha (0 where its cutoffs drop the pair), clamped;
//      rgb += a*T*color;  T *= 1 - a;
//      depth and id are picked at the first pair with T < depth_iso, a > 0.
// A culled (warp, pair) fails eval at every pixel of the warp (the
// predicate's margins cover eval's rounding), so it would change no T,
// colour or pick: the outputs are bit for bit those of the sweep over every
// pair. A pixel freezes (contributes nothing more) when its T at the start
// of a step is <= min_transmittance, exactly the TPU kernel's per-step
// freeze; a warp whose pixels all froze skips the step; a step whose pairs
// are all culled still counts as a step; and the block stops once all 256
// pixels are frozen (__syncthreads_or). Every tile is written, empty tiles
// as rgb 0, T 1, depth 0, id -1, row-major over the tile's pixels whatever
// thread holds them. Each block adds its kept (warp, pair) bits over the
// steps it entered to a counter (one integer atomic).
// The stochastic form (template flag STOCH; entries <name>_stoch) replaces
// each clamped alpha by the binary accept of the TPU kernel's stream
// (response::hash_uniform, stochastic_accept): key seed + p / chunk, lane
// p % chunk, with p the pair's global index (rasterize_pallas.py:237). The
// staging compacts the kept pairs, so it stages each kept pair's p beside
// its id; a rejected pair is skipped as a failed cutoff is. An accepted
// pair is opaque: T falls to exactly 0 and the pixel takes its colour,
// depth and id. The deterministic form compiles as it did (the flag is a
// constant, the seed its kernel's last parameter, unread).
// The mesh forms are compile-time hooks of the same kernels
// (csrc/response.cuh): gs2d_clip reads each pixel's depth limit
// (model_pixel) and fails eval behind it; tri2d and tri2d_smooth blend an
// unclamped alpha of exactly 1 (CLAMP), so the first covering face takes T
// to 0, and tri2d_smooth takes its colour and picked depth per pixel from
// the face's barycentrics (PIXEL_ATTRS; every model's blend reads both
// through response::blend_attrs). The triangles' reach is the edge
// functions' over the warp's rectangle. Every other form compiles as it
// did.
// The multi-iso form (template flag ISO, gs2d alone; entry
// rasterize_fwd_iso) is the deep shadow map's (rasterize_pallas.py:304-356):
// in place of the (depth, id) pick at depth_iso it keeps four picks in
// registers, each set at the first blended pair after which T falls below
// its own threshold (iso.x > iso.y > iso.z > iso.w; one pair may cross
// several), and writes them as rows 4-7 of an (8, 256) tile block, 0 where
// nothing was picked, ids -1. The blend, the freeze and the cull are gs2d's,
// so row 4 + k is the depth the gs2d form picks at depth_iso = iso[k], bit
// for bit. Every other form compiles as it did (the flag is a constant, the
// thresholds the kernel's last parameter, unread).
//
// What bounds it on the H100: f32 operations per (pixel, pair) evaluation,
// about 17 for gs2d and 68 for gut3d (the canonical ray, an rsqrtf and an
// expf), plus the blend per hit; only 7-8 % of the evaluations of a tile's
// list hit, and the per-warp cull keeps 22 % (3DGS) and 33 % (3DGUT) of
// them at the headline frames for f64 operations per pair and per (warp,
// pair). Measured on an H100 (PERF.md §6): the cull inside the
// blend's steps, behind their barriers, ran 0.02 ms slower in both models
// than this separate pass. The attribute reads are amortised over a warp's
// 32 pixels through shared memory (broadcast reads, no bank conflicts), and
// gut3d's per-lane rotation is built once per lane, not per pixel. Built
// with exact expf, without fast math and with -fmad=false (ops/_build.py):
// the cutoffs flip whole contributions, so each alpha is rounded op for op
// as the plain PyTorch twin rounds it (K2 recomputes these alphas bit for
// bit). wgmma and TMA are not used.

#include <cuda_runtime.h>
#include <stdint.h>

#include "response.cuh"

namespace {

using response::PIX;
using response::WARPS;
constexpr int MAX_CHUNK = 256;     // largest blend step staged at once: one pair per thread
constexpr int OUT_ROWS = 5;        // rgb, T, depth
constexpr int ISO_ROWS = 8;        // the multi-iso form: rgb, T, four iso depths
constexpr int ISO_PICKS = 4;
// Blocks per SM both kernels are built for: at most 40 registers a thread,
// a few spilled in gut3d's cull. On an H100 6 blocks ran faster than 4 or 5
// in both kernels and both models (PERF.md §6).
constexpr int MIN_BLOCKS = 6;

// A kept pair's forward slots are staged lane-major, padded to a multiple
// of four floats, and read into registers with float4 broadcast loads.
template <class M>
constexpr int LANE_STRIDE = (M::FWD_SLOTS + 3) / 4 * 4;

template <class M>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
warp_mask_kernel(const float* __restrict__ attrs, long long pair_stride,
                 const int* __restrict__ tile_start, const int* __restrict__ tile_count,
                 const float* __restrict__ pix_ctx, int tiles_x, response::Params prm,
                 unsigned char* __restrict__ masks) {
  static_assert(WARPS <= 8, "a mask byte holds one bit per warp");
  constexpr int HALF = WARPS / 2;            // bounds each thread of a pair tests
  __shared__ typename M::TileBound bound[WARPS];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const response::Pixel pix =
      response::model_pixel<M>(t, tiles_x, response::warp_pixel(i), pix_ctx);
  M::warp_bound(bound[i >> 5], t, tiles_x, pix);
  __syncthreads();
  const int start = tile_start[t];
  const int count = tile_count[t];
  const int part = i % 2;
  for (int r0 = 0; r0 < count; r0 += PIX / 2) {  // uniform trip count: the shuffle below
    const int j = r0 + i / 2;
    unsigned mask = 0;
    if (j < count) {
      float slots[M::BWD_SLOTS];
      M::stage_bwd(attrs, pair_stride, start + j, slots, 1, 0);
      const typename M::Reach r = M::reach(slots, 1, 0, prm);
      #pragma unroll
      for (int k = 0; k < HALF; ++k) {
        if (M::reach_hits(r, bound[part * HALF + k])) mask |= 1u << (part * HALF + k);
      }
    }
    mask |= __shfl_xor_sync(0xffffffffu, mask, 1);  // the pair's other half
    if (part == 0 && j < count) masks[start + j] = (unsigned char)mask;
  }
}

template <class M, bool STOCH, bool ISO = false>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
rasterize_fwd_kernel(const float* __restrict__ attrs, long long pair_stride,
                     const int* __restrict__ ids,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const unsigned char* __restrict__ masks,
                     const float* __restrict__ pix_ctx, int tiles_x, int chunk,
                     response::Params prm, float min_transmittance,
                     float depth_iso, float* __restrict__ out,
                     int* __restrict__ out_id, int* __restrict__ kept, unsigned seed,
                     float4 iso) {
  static_assert(!ISO || (!STOCH && !M::PIXEL_ATTRS && !M::DEPTH_LIMIT),
                "the multi-iso form is the deterministic gs2d blend's");
  constexpr int LS = LANE_STRIDE<M>;
  __shared__ __align__(16) float s_attr[MAX_CHUNK * LS];  // pair j's slots at j * LS
  __shared__ int s_id[MAX_CHUNK];
  __shared__ int s_p[STOCH ? MAX_CHUNK : 1];  // STOCH: kept pair j's global index
  __shared__ unsigned s_mask[MAX_CHUNK];     // bit w: warp w may be hit
  __shared__ int s_count[2][WARPS];          // response::kept_place's buffers
  __shared__ int s_kept;

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int px = response::warp_pixel(i);    // this thread's pixel in the tile
  const response::Pixel pix = response::model_pixel<M>(t, tiles_x, px, pix_ctx);
  if (i == 0) s_kept = 0;
  const int start = tile_start[t];
  const int end = start + tile_count[t];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  int pick = -1;
  bool picked = false;
  float iso_d[ISO_PICKS] = {0.0f, 0.0f, 0.0f, 0.0f};  // ISO: the depth at each level
  unsigned iso_picked = 0;                             // ISO: bit k, level k picked
  int n_bits = 0;  // kept (warp, pair) bits of the pairs this thread staged

  for (int s = start; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int n = e - s;
    // Stage the step's pairs that some warp may need, compacted in pair
    // order: thread i takes pair s + r0 + i of each round of PIX pairs (one
    // round, as n <= PIX).
    int n_kept = 0;
    for (int r0 = 0; r0 < n; r0 += PIX) {
      const int j = r0 + i;
      const unsigned mask = j < n ? masks[s + j] : 0u;
      const int at = response::kept_place(mask != 0, r0 / PIX, s_count, n_kept);
      if (mask != 0) {
        M::stage_fwd(attrs, pair_stride, s + j, s_attr, 1, at * LS);
        s_id[at] = ids[s + j];
        if constexpr (STOCH) s_p[at] = s + j;
        s_mask[at] = mask;
        n_bits += __popc(mask);
      }
    }
    __syncthreads();
    const bool live = T > min_transmittance;  // per-step freeze, rasterize_pallas.py:286
    const bool warp_live = __any_sync(0xffffffffu, live);
    for (int j0 = 0; warp_live && j0 < n_kept; j0 += 32) {
      const int jl = j0 + lane;
      unsigned bits = __ballot_sync(0xffffffffu, jl < n_kept && ((s_mask[jl] >> warp) & 1u));
      for (; bits != 0; bits &= bits - 1) {
        const int j = j0 + __ffs(bits) - 1;
        if (!live) continue;
        float v[LS];
        #pragma unroll
        for (int k = 0; k < LS / 4; ++k) {
          const float4 q = reinterpret_cast<const float4*>(s_attr + j * LS)[k];
          v[4 * k] = q.x;
          v[4 * k + 1] = q.y;
          v[4 * k + 2] = q.z;
          v[4 * k + 3] = q.w;
        }
        float a;
        typename M::Hit h;
        if (!M::eval(v, 1, 0, pix, prm, a, h)) continue;  // alpha = 0
        if constexpr (M::CLAMP) a = fminf(a, prm.alpha_clamp);
        if constexpr (STOCH) {
          const int p = s_p[j];
          a = response::stochastic_accept(
              a, response::hash_uniform(seed + (unsigned)(p / chunk), px, p % chunk));
          if (a == 0.0f) continue;  // rejected: alpha = 0
        }
        const float w = a * T;
        float rgb[3], d;
        response::blend_attrs<M>(v, h, rgb, d);
        cr += w * rgb[0];
        cg += w * rgb[1];
        cb += w * rgb[2];
        T *= 1.0f - a;
        if constexpr (ISO) {
          const float lv[ISO_PICKS] = {iso.x, iso.y, iso.z, iso.w};
          #pragma unroll
          for (int k = 0; k < ISO_PICKS; ++k) {
            if (!((iso_picked >> k) & 1u) && T < lv[k]) {
              iso_picked |= 1u << k;
              iso_d[k] = d;
            }
          }
        } else if (!picked && T < depth_iso) {
          picked = true;
          depth = d;
          pick = s_id[j];
        }
      }
    }
    s = e;
    // all pixels frozen: nothing later can change the tile. Also the
    // barrier before the next step overwrites shared memory.
    if (!__syncthreads_or(T > min_transmittance)) break;
  }

  float* o = out + (size_t)t * (ISO ? ISO_ROWS : OUT_ROWS) * PIX;
  o[0 * PIX + px] = cr;
  o[1 * PIX + px] = cg;
  o[2 * PIX + px] = cb;
  o[3 * PIX + px] = T;
  if constexpr (ISO) {
    #pragma unroll
    for (int k = 0; k < ISO_PICKS; ++k) o[(4 + k) * PIX + px] = iso_d[k];
  } else {
    o[4 * PIX + px] = depth;
  }
  out_id[(size_t)t * PIX + px] = pick;
  // integers: the count is the same whatever the order of the adds
  n_bits = __reduce_add_sync(0xffffffffu, n_bits);
  __syncthreads();  // thread 0's reset of s_kept is seen, also in a block with no pairs
  if (lane == 0 && n_bits > 0) atomicAdd(&s_kept, n_bits);
  __syncthreads();
  if (i == 0 && s_kept > 0) atomicAdd(kept, s_kept);
}

template <class M, bool STOCH = false, bool ISO = false>
int launch(const float* attrs, long long pair_stride, const int* ids, const int* tile_start,
           const int* tile_count, const float* pix_ctx, int num_tiles, int tiles_x, int chunk,
           float alpha_min, float alpha_clamp, float qmax, float min_response, int degree,
           float min_transmittance, float depth_iso, float* out, int* out_id, int* kept,
           unsigned char* masks, int seed, void* stream,
           float4 iso = make_float4(0.0f, 0.0f, 0.0f, 0.0f)) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const response::Params prm{alpha_min, alpha_clamp, qmax, min_response, degree};
  if (num_tiles > 0) {
    warp_mask_kernel<M><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_stride, tile_start, tile_count, pix_ctx, tiles_x, prm, masks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rasterize_fwd_kernel<M, STOCH, ISO><<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_stride, ids, tile_start, tile_count, masks, pix_ctx, tiles_x, chunk, prm,
        min_transmittance, depth_iso, out, out_id, kept, (unsigned)seed, iso);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the per-warp cull and the blend, one block per tile each, on
// `stream`; return cudaGetLastError(). gs2d and the triangles read no pixel
// context (pix_ctx may be null); gut3d and gs2d_clip read the (T, 8, 256)
// one. masks: a byte per pair
// (pair_stride of them), scratch the cull writes for the pairs of the
// tiles' ranges and the blend reads. kept must hold 0 on entry: each block
// of the blend adds the (warp, pair) bits it kept, over the blend steps it
// entered (one integer atomic each). seed: the stochastic stream's (read by
// the _stoch entries alone).
#define RASTERIZE_FWD_PARAMS                                                                  \
  const float *attrs, long long pair_stride, const int *ids, const int *tile_start,          \
      const int *tile_count, const float *pix_ctx, int num_tiles, int tiles_x, int chunk,    \
      float alpha_min, float alpha_clamp, float qmax, float min_response, int degree,        \
      float min_transmittance, float depth_iso, float *out, int *out_id, int *kept,          \
      unsigned char *masks, int seed, void *stream
#define RASTERIZE_FWD_ARGS                                                                    \
  attrs, pair_stride, ids, tile_start, tile_count, pix_ctx, num_tiles, tiles_x, chunk,       \
      alpha_min, alpha_clamp, qmax, min_response, degree, min_transmittance, depth_iso, out,  \
      out_id, kept, masks, seed, stream

extern "C" int rasterize_fwd(RASTERIZE_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_gut3d(RASTERIZE_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d>(RASTERIZE_FWD_ARGS);
}

// The packed tier (forward only): gs2dp's 7 rows, gut3dp's 10.
extern "C" int rasterize_fwd_gs2dp(RASTERIZE_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2dp>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_gut3dp(RASTERIZE_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3dp>(RASTERIZE_FWD_ARGS);
}

// The stochastic forms of the four.
extern "C" int rasterize_fwd_stoch(RASTERIZE_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2d, true>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_gut3d_stoch(RASTERIZE_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3d, true>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_gs2dp_stoch(RASTERIZE_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Gs2dp, true>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_gut3dp_stoch(RASTERIZE_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gut3dp, true>(RASTERIZE_FWD_ARGS);
}

// The mesh-composited frame: the splat pass behind the mesh depth (and its
// stochastic form), the flat and the smooth triangles.
extern "C" int rasterize_fwd_gs2d_clip(RASTERIZE_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gs2dClip>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_gs2d_clip_stoch(RASTERIZE_FWD_PARAMS) {
  if (pix_ctx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<response::Gs2dClip, true>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_tri2d(RASTERIZE_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Tri2d>(RASTERIZE_FWD_ARGS);
}

extern "C" int rasterize_fwd_tri2d_smooth(RASTERIZE_FWD_PARAMS) {
  pix_ctx = nullptr;
  return launch<response::Tri2dSmooth>(RASTERIZE_FWD_ARGS);
}

// The deep shadow map's multi-iso form of gs2d: the four transmittance levels
// after the common parameters (depth_iso unread), out (T, 8, 256), ids -1.
extern "C" int rasterize_fwd_iso(RASTERIZE_FWD_PARAMS, float iso0, float iso1, float iso2,
                                 float iso3) {
  pix_ctx = nullptr;
  return launch<response::Gs2d, false, true>(RASTERIZE_FWD_ARGS,
                                             make_float4(iso0, iso1, iso2, iso3));
}
