// The response models the tile blenders evaluate, as compile-time
// parameters of the four kernels (csrc/rasterize_{fwd,bwd}.cu,
// csrc/raster_bucket_{fwd,bwd}.cu): one definition of each model's alpha
// and of its hand-derived VJP, so K1 and K3 share the forward math and K2
// and K4 the backward. The plain PyTorch reference of the same math, term
// for term, is ops/response.py; the JAX package's is
// vk_gaussian_splatting_tpu/ops/response.py (gs2d_alpha :131, gut3d_alpha
// :395), whose kernels take the VJP with in-kernel jax.vjp.
//
// A model stages each lane's rows in shared memory as "slots", slot-major
// (slot k of lane j at s[k * ss + j]); a model may stage values derived per
// lane instead of raw rows where the arithmetic stays the twin's, term for
// term. The colour slots are 6-8 in every model. Then, per (pixel, lane):
//   eval: a_raw and whether the pair passes the model's cutoffs (alpha =
//         min(a_raw, alpha_clamp) where it does, else 0), keeping what the
//         VJP reads in a Hit;
//   vjp:  from da = dL/dalpha (zero where the clamp binds), the gradients
//         of the geometry rows into g[row] (the colour rows are the
//         blend's, the depth row gets none).
//
// gs2d (threedgs_raster.frag.slang:236-255): rows 0 x, 1 y, 2-4 conic
// (a, b, c), 5 opacity, 6-8 rgb, 9 depth; staged as they are.
//   d = a dx^2 + 2 b dx dy + c dy^2, a_raw = opacity exp(-d/2), kept where
//   d <= qmax and a_raw >= alpha_min.
// gut3d (threedgrt.h.slang:57-127): rows 0-2 position p, 3-5 scale s, 6-8
// rgb, 9-12 the unit quaternion q (w, x, y, z), 13 opacity, 14 depth; each
// thread's pixel brings its ray (unit direction d, origin o) from the
// per-tile pixel context. Staged per lane: p, 1/max(s, 1e-12), rgb, R(q)
// (the world-from-canonical rotation, nine entries), opacity, and the depth
// (forward) or q and the scale chain factor -1/max(s,1e-12)^2 (0 below the
// floor; backward). Then
//   u = R^T (o - p), v = R^T d, oc = u / s, dc = v / s,
//   dh = dc rsqrt(|dc|^2 + 1e-30), D = |dh x oc|^2,
//   resp = K_degree(D), a_raw = opacity resp,
//   kept where a_raw > alpha_min and resp > kernel_min_response.
// gs2d_clip (the mesh-composited frame's splat pass): gs2d, and where the
// pixel's depth limit (pixel-context row 6; Pixel::limit, loaded for this
// model alone by model_pixel) is > 0 a lane whose depth is not below it
// fails eval. Its backward stages the depth to rebuild that keep.
// tri2d and tri2d_smooth (the mesh pass): opaque triangles, rows 0-5 the
// vertices' absolute pixel xy. eval computes the three edge functions on
// vertices recentred on the tile origin and passes where the pixel centre
// is inside in either winding, each edge pushed out by 0.05 of its L1
// length; a_raw is exactly 1 and is not clamped (CLAMP), so the first
// covering face takes T to exactly 0. tri2d: rows 6-8 the flat colour, 9
// the centroid depth; its VJP writes zeros (the coverage is a select of
// constants), only the blend's colour gradients remain. tri2d_smooth
// (forward only): rows 6-14 the vertices' colours, 15-17 their view z; the
// blend takes a per-pixel colour and depth (PIXEL_ATTRS, pixel_attrs) from
// the perspective-correct barycentrics of the edge functions eval keeps.
// gs2dp and gut3dp, the packed tier (forward only; ops/response.py): the
// same two models on fewer rows, most attributes as two bf16 halves of an
// f32 word and opacity as 16-bit fixed point beside bf16 blue. Each is its
// parent with its own ROWS, DEPTH_ROW (the exact f32 sort depth) and
// staging, which reads the packed words and unpacks them into the parent's
// slots by mask, shift and bitcast (gut3dp renormalising the quaternion as
// the twin does); eval, the bounds, reach and reach_hits are the parent's.
// Built without fast math and with -fmad=false (ops/_build.py): expf,
// sqrtf, rsqrtf and IEEE division, each operation rounded where the twin
// rounds it (constants are the twin's Python doubles cast to float), so a
// kernel and its twin on one card agree bit for bit on every alpha.
//
// The per-tile cull of the bucket kernels, forward and backward
// (csrc/raster_bucket_fwd.cu, K3; csrc/raster_bucket_bwd.cu, K4), and of
// the pair backward (csrc/rasterize_bwd.cu, K2): each model's TileBound is
// computed once per block (tile_bound, called by all PIX threads), and
// may_hit(s, ss, j, bound, prm) reads a lane's staged backward slots and
// answers false only where eval provably fails at every pixel of the tile;
// kept_place (below) compacts each blend step's kept lanes in list order.
// may_hit is reach (the lane's part, from its slots alone) followed by
// reach_hits (the test against one bound). The pair forward
// (csrc/rasterize_fwd.cu, K1) tests each lane's Reach against the bounds of
// the block's eight warps (warp_bound: the same bound over the warp's 32
// pixels, warp_pixel), so a warp skips the pairs that cannot touch its
// pixels; the margins below hold for any set of pixel centres or rays.
// K2 and K3 stage those slots in registers for the test (K3 stores the
// forward slots from them: the backward slots before DEPTH_SLOT, then the
// depth). may_hit's geometry runs in double from the f32 slots eval reads.
// A NaN, an inf or a degenerate shape answers true: every test is written
// so that a NaN falls to "keep". Margins: each radius grows by CULL_REL =
// 1e-3 of itself plus an absolute term (gs2d 1e-2 px; gut3d 1e-7 of the
// distance from the tile's rays), the cutoffs are loosened by 1e-3 (gs2d,
// in the quadratic form) and 1e-5 (gut3d, in -ln of the response), and on
// top each model adds a bound of eval's f32 rounding (below), so rounding
// can never turn a culled lane into a hit. The plain twin, term for term,
// is ops/response.may_hit (per lane of a bucket window:
// ops/raster_bucket.tile_may_hit; per pair: ops/rasterize.pair_may_hit).

#pragma once

#include <cuda_runtime.h>

namespace response {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per block, pixels per tile
constexpr int WARPS = PIX / 32;
constexpr int PIX_ROWS = 8;        // pixel-context rows per tile: 0-2 d, 3-5 o
constexpr int PIX_DEPTH_LIMIT = 6; // pixel-context row of gs2d_clip's depth limit
constexpr double CULL_REL = 1e-3;  // relative growth of every cull radius
constexpr int WARP_W = 8, WARP_H = 4;  // K1's warps: 8x4 pixel blocks

// The pixel, row-major in its tile, of thread i of a K1 block: warp w = i /
// 32 covers the 8x4 block at x = 8 (w % 2), y = 4 (w / 2), lane l the pixel
// (l % 8, l / 8) of it. A compact block keeps a warp's rays and centres
// close together, so its bound culls far more than a 16x2 strip's.
__device__ inline int warp_pixel(int i) {
  const int w = i >> 5, l = i & 31;
  constexpr int ACROSS = TILE / WARP_W;  // warp blocks per row of the tile
  return (WARP_H * (w / ACROSS) + l / WARP_W) * TILE + WARP_W * (w % ACROSS) + l % WARP_W;
}

__device__ inline bool finite_all(const double* v, int n) {
  bool ok = true;
  #pragma unroll
  for (int k = 0; k < n; ++k) ok = ok && isfinite(v[k]);
  return ok;
}

__device__ inline double warp_sum_d(double v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The cutoffs: qmax is gs2d's, min_response and degree are gut3d's.
struct Params {
  float alpha_min, alpha_clamp, qmax, min_response;
  int degree;
};

// What a thread knows of its pixel: its center, its ray (gut3d), and its
// depth limit (gs2d_clip).
struct Pixel {
  float px, py;
  float d[3], o[3];
  float limit;
};

// Pixel i of tile t; the ray from the pixel context when there is one.
__device__ inline Pixel load_pixel(int t, int tiles_x, int i, const float* __restrict__ pix_ctx) {
  Pixel p;
  p.px = (float)((t % tiles_x) * TILE + i % TILE) + 0.5f;
  p.py = (float)((t / tiles_x) * TILE + i / TILE) + 0.5f;
  const float* c = pix_ctx == nullptr ? nullptr : pix_ctx + (size_t)t * PIX_ROWS * PIX + i;
  #pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.d[k] = c == nullptr ? 0.0f : c[k * PIX];
    p.o[k] = c == nullptr ? 0.0f : c[(3 + k) * PIX];
  }
  return p;
}

// Pixel i of tile t as model M reads it: load_pixel, or for a model with a
// depth limit (DEPTH_LIMIT) the centre and row PIX_DEPTH_LIMIT of the
// context alone.
template <class M>
__device__ inline Pixel model_pixel(int t, int tiles_x, int i,
                                    const float* __restrict__ pix_ctx) {
  if constexpr (M::DEPTH_LIMIT) {
    Pixel p = load_pixel(t, tiles_x, i, nullptr);
    p.limit = pix_ctx[((size_t)t * PIX_ROWS + PIX_DEPTH_LIMIT) * PIX + i];
    return p;
  } else {
    return load_pixel(t, tiles_x, i, pix_ctx);
  }
}

// The colour and the picked depth a pair gives a pixel in the blend, from
// its staged slots v: slots 6-8 and DEPTH_SLOT, or the model's own per
// pixel (PIXEL_ATTRS: tri2d_smooth's barycentric colour and depth).
template <class M>
__device__ inline void blend_attrs(const float* v, const typename M::Hit& h, float* rgb,
                                   float& depth) {
  if constexpr (M::PIXEL_ATTRS) {
    M::pixel_attrs(v, 1, 0, h, rgb, depth);
  } else {
    rgb[0] = v[6];
    rgb[1] = v[7];
    rgb[2] = v[8];
    depth = v[M::DEPTH_SLOT];
  }
}

// The packed tier's words (ops/response.py unpack2bf16, unpack_bf16_u16):
// the high bf16 half by a mask, the low one by a shift, the 16-bit fixed
// point as u16 * f32(1/65535). Nothing touches a word before this but
// moves: a word whose high half is +-0 is an f32 subnormal.
__device__ inline float bf16_hi(float w) {
  return __uint_as_float(__float_as_uint(w) & 0xFFFF0000u);
}
__device__ inline float bf16_lo(float w) { return __uint_as_float(__float_as_uint(w) << 16); }
__device__ inline float u16_lo(float w) {
  return (float)(__float_as_uint(w) & 0xFFFFu) * static_cast<float>(1.0 / 65535.0);
}

struct Gs2d {
  // K2 (csrc/rasterize_bwd.cu) culls the pair lists (may_hit, below) and
  // reduces 3 pairs' 9 gradient rows at once
  static constexpr bool CULL_PAIRS = true;
  static constexpr int PAIR_GROUP = 3;
  // compile-time hooks of the blends: alpha clamped at alpha_clamp; a
  // per-pixel colour and depth (pixel_attrs) in place of the rows; the
  // pixel's depth limit loaded (model_pixel)
  static constexpr bool CLAMP = true, PIXEL_ATTRS = false, DEPTH_LIMIT = false;
  static constexpr int ROWS = 10;       // f32 attribute rows
  static constexpr int DEPTH_ROW = 9;   // aux pick and bucket merge key
  static constexpr int GRAD_ROWS = 9;   // rows 0-8 get gradients
  static constexpr int FWD_SLOTS = 10;  // the rows as they are
  static constexpr int BWD_SLOTS = 9;   // without the depth
  static constexpr int DEPTH_SLOT = 9;

  struct Hit {
    float dx, dy, gauss;
  };

  __device__ static void stage_fwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    #pragma unroll
    for (int r = 0; r < FWD_SLOTS; ++r) s[r * ss + j] = attrs[r * stride + col];
  }

  __device__ static void stage_bwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    #pragma unroll
    for (int r = 0; r < BWD_SLOTS; ++r) s[r * ss + j] = attrs[r * stride + col];
  }

  __device__ static bool eval(const float* s, int ss, int j, const Pixel& p, const Params& prm,
                              float& a_raw, Hit& h) {
    h.dx = p.px - s[0 * ss + j];
    h.dy = p.py - s[1 * ss + j];
    const float d = s[2 * ss + j] * h.dx * h.dx + 2.0f * s[3 * ss + j] * h.dx * h.dy +
                    s[4 * ss + j] * h.dy * h.dy;
    h.gauss = expf(-0.5f * d);
    a_raw = s[5 * ss + j] * h.gauss;
    return d <= prm.qmax && a_raw >= prm.alpha_min;
  }

  // With a = opacity * gauss: da/dopacity = gauss, da/dd = -a/2.
  __device__ static void vjp(const float* s, int ss, int j, const Pixel&, const Params&,
                             const Hit& h, float a_raw, float da, float* g) {
    const float ca = s[2 * ss + j], cb = s[3 * ss + j], cc = s[4 * ss + j];
    const float dd = -0.5f * da * a_raw;
    g[0] = -(dd * (2.0f * ca * h.dx + 2.0f * cb * h.dy));
    g[1] = -(dd * (2.0f * cb * h.dx + 2.0f * cc * h.dy));
    g[2] = dd * h.dx * h.dx;
    g[3] = 2.0f * dd * h.dx * h.dy;
    g[4] = dd * h.dy * h.dy;
    g[5] = da * h.gauss;
  }

  // The rectangle of the tile's pixel centres.
  struct TileBound {
    double x0, x1, y0, y1;
  };

  __device__ static void tile_bound(TileBound& b, int t, int tiles_x, const Pixel&) {
    if (threadIdx.x == 0) {
      b.x0 = (double)((t % tiles_x) * TILE) + 0.5;
      b.y0 = (double)((t / tiles_x) * TILE) + 0.5;
      b.x1 = b.x0 + (TILE - 1);
      b.y1 = b.y0 + (TILE - 1);
    }
    __syncthreads();
  }

  // The rectangle of the centres of the calling warp's pixels (warp_pixel),
  // written by its lane 0; no barrier.
  __device__ static void warp_bound(TileBound& b, int t, int tiles_x, const Pixel&) {
    const int w = threadIdx.x >> 5;
    constexpr int ACROSS = TILE / WARP_W;
    if ((threadIdx.x & 31) == 0) {
      b.x0 = (double)((t % tiles_x) * TILE + WARP_W * (w % ACROSS)) + 0.5;
      b.y0 = (double)((t / tiles_x) * TILE + WARP_H * (w / ACROSS)) + 0.5;
      b.x1 = b.x0 + (WARP_W - 1);
      b.y1 = b.y0 + (WARP_H - 1);
    }
  }

  // A hit needs d <= qmax and opacity exp(-d/2) >= alpha_min, so d <= tau =
  // min(qmax, 2 ln(opacity / alpha_min)). For a positive-definite conic (a >
  // 0, det = ac - b^2 > 0) d >= 0, so opacity < alpha_min never hits; else
  // the ellipse d <= tau has the bounding half-widths sqrt(tau c / det),
  // sqrt(tau a / det), and a box that misses the tile's pixel centres culls.
  // eval's f32 d is within 4e-7 (a dx^2 + 2|b dx dy| + c dy^2) of the exact
  // form (six roundings and those of dx, dy), which is at most err = 1e-6 K
  // of the form with K = (a + |b| + c)^2 / det; so tau grows by 1e-3 (the
  // rounding of exp and of the product, ~1e-6 in d, and more) and the
  // radii by CULL_REL + err, with conics of err > 0.25 kept. Nothing here
  // depends on which pixel centres the box holds.
  // The lane's part: a fixed answer, or the centre and inflated half-widths.
  struct Reach {
    double x, y, rx, ry;
    bool fixed, answer;
  };

  __device__ static Reach reach(const float* s, int ss, int j, const Params& prm) {
    const double v[6] = {s[0 * ss + j], s[1 * ss + j], s[2 * ss + j],
                         s[3 * ss + j], s[4 * ss + j], s[5 * ss + j]};
    const double x = v[0], y = v[1], ca = v[2], cb = v[3], cc = v[4], op = v[5];
    const double amin = prm.alpha_min;
    Reach r{x, y, 0.0, 0.0, true, true};
    if (!(finite_all(v, 6) && amin > 0.0)) return r;
    const double det = ca * cc - cb * cb;
    if (!(ca > 0.0 && det > 0.0)) return r;
    const double sum = ca + fabs(cb) + cc;
    const double err = 1e-6 * (sum * sum / det);
    if (!(err <= 0.25)) return r;
    r.answer = false;
    if (op < amin) return r;  // d >= 0: a_raw <= opacity
    const double tau = fmin((double)prm.qmax, 2.0 * log(op / amin)) + 1e-3;
    const double grow = 1.0 + CULL_REL + err;
    r.rx = sqrt(tau * cc / det) * grow + 1e-2;
    r.ry = sqrt(tau * ca / det) * grow + 1e-2;
    r.fixed = false;
    return r;
  }

  __device__ static bool reach_hits(const Reach& r, const TileBound& b) {
    if (r.fixed) return r.answer;
    return !(r.x + r.rx < b.x0 || r.x - r.rx > b.x1 || r.y + r.ry < b.y0 || r.y - r.ry > b.y1);
  }

  __device__ static bool may_hit(const float* s, int ss, int j, const TileBound& b,
                                 const Params& prm) {
    return reach_hits(reach(s, ss, j, prm), b);
  }
};

// gs2d on the packed rows 0 x, 1 y, 2 (a, b), 3 (c, depth), 4 (r, g), 5
// (b, opacity u16), 6 the sort depth: 6 words staged for gs2d's 9 backward
// slots, 7 for its 10 forward ones.
struct Gs2dp : Gs2d {
  static constexpr int ROWS = 7;
  static constexpr int DEPTH_ROW = 6;

  // gs2d's slots 0-8 from the packed words
  __device__ static void unpack(const float* __restrict__ attrs, long long stride, long long col,
                                float* v) {
    const float ab = attrs[2 * stride + col], cd = attrs[3 * stride + col];
    const float rg = attrs[4 * stride + col], bo = attrs[5 * stride + col];
    v[0] = attrs[col];
    v[1] = attrs[stride + col];
    v[2] = bf16_hi(ab);
    v[3] = bf16_lo(ab);
    v[4] = bf16_hi(cd);
    v[5] = u16_lo(bo);
    v[6] = bf16_hi(rg);
    v[7] = bf16_lo(rg);
    v[8] = bf16_hi(bo);
  }

  __device__ static void stage_fwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    stage_bwd(attrs, stride, col, s, ss, j);
    s[DEPTH_SLOT * ss + j] = attrs[DEPTH_ROW * stride + col];
  }

  __device__ static void stage_bwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    float v[BWD_SLOTS];
    unpack(attrs, stride, col, v);
    #pragma unroll
    for (int r = 0; r < BWD_SLOTS; ++r) s[r * ss + j] = v[r];
  }
};

// gs2d behind the pixel's depth limit: gs2d's eval, and the lane kept where
// limit <= 0 or depth < limit (ops/response.depth_keep, the JAX
// _depth_clip); everything else is gs2d's, the backward slots with the
// depth.
struct Gs2dClip : Gs2d {
  static constexpr bool DEPTH_LIMIT = true;
  static constexpr int BWD_SLOTS = 10;  // gs2d's 9 and the depth, which the keep reads

  __device__ static void stage_bwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    #pragma unroll
    for (int r = 0; r < BWD_SLOTS; ++r) s[r * ss + j] = attrs[r * stride + col];
  }

  __device__ static bool eval(const float* s, int ss, int j, const Pixel& p, const Params& prm,
                              float& a_raw, Hit& h) {
    const bool hit = Gs2d::eval(s, ss, j, p, prm, a_raw, h);
    return hit && (p.limit <= 0.0f || s[DEPTH_SLOT * ss + j] < p.limit);
  }
};

// Flat opaque triangles (ops/response.tri2d_alpha): rows 0-5 the vertices'
// absolute pixel xy, 6-8 the colour, 9 the centroid depth, staged as they
// are. The bounds are gs2d's rectangles of pixel centres; K2 does not cull
// the pair lists (a triangle's rect is its box, and its cull costs f64
// tests per pair).
struct Tri2d : Gs2d {
  static constexpr bool CULL_PAIRS = false;
  static constexpr bool CLAMP = false;
  static constexpr int ROWS = 10;
  static constexpr int DEPTH_ROW = 9;
  static constexpr int GRAD_ROWS = 9;   // rows 0-8: the vertices' zeros and the colours
  static constexpr int FWD_SLOTS = 10;
  static constexpr int BWD_SLOTS = 9;
  static constexpr int DEPTH_SLOT = 9;

  struct Hit {
    float e[3];  // the edge functions
  };

  // The edge functions and their tolerances at the pixel centre, the
  // twin's operations in its order: the tile origin is exact (px - 16
  // floor(px / 16)), each vertex coordinate less it rounds once.
  __device__ static void edges(const float* s, int ss, int j, const Pixel& p, float* e,
                               float* tol) {
    const float lx = p.px - 16.0f * floorf(p.px / 16.0f);
    const float ly = p.py - 16.0f * floorf(p.py / 16.0f);
    const float ox = p.px - lx, oy = p.py - ly;
    float x[3], y[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = s[(2 * k) * ss + j] - ox;
      y[k] = s[(2 * k + 1) * ss + j] - oy;
    }
    #pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int b = a == 2 ? 0 : a + 1;
      e[a] = (x[b] - x[a]) * (ly - y[a]) - (y[b] - y[a]) * (lx - x[a]);
      tol[a] = 0.05f * (fabsf(x[b] - x[a]) + fabsf(y[b] - y[a]));
    }
  }

  __device__ static bool eval(const float* s, int ss, int j, const Pixel& p, const Params&,
                              float& a_raw, Hit& h) {
    float t[3];
    edges(s, ss, j, p, h.e, t);
    a_raw = 1.0f;
    return (h.e[0] >= -t[0] && h.e[1] >= -t[1] && h.e[2] >= -t[2]) ||
           (h.e[0] <= t[0] && h.e[1] <= t[1] && h.e[2] <= t[2]);
  }

  __device__ static void vjp(const float*, int, int, const Pixel&, const Params&, const Hit&,
                             float, float, float* g) {
    #pragma unroll
    for (int r = 0; r < 6; ++r) g[r] = 0.0f;
  }

  // The triangle's reach. eval passes at a pixel only where all three f32
  // edge functions are >= -t_f32 or all <= t_f32. Each f32 e_k lies within
  // 26 eps S^2 (eps = 2^-24) of the exact edge function E_k(p) = a_k (py -
  // y_k) - b_k (px - x_k) in absolute pixels, with S the largest |vertex -
  // tile origin| per axis (>= 16): the recentring rounds each coordinate by
  // eps S, the differences, products and the subtraction add 24 eps S^2 in
  // all, and t_f32 lies within eps S of the exact 0.05 (|a_k| + |b_k|). So a
  // culled pair needs, over the bound's rectangle of pixel centres (whose
  // tile origin lies within 16 of it: S <= the largest vertex distance from
  // the rectangle's corners + 16), some E_i's maximum below -(t_i + err) and
  // some E_j's minimum above t_j + err, err = TRI_ERR S^2 = 1e-5 S^2 (six
  // times the bound); E is affine, so its extremes over the rectangle are
  // corner sums. A degenerate triangle (collinear or coincident vertices)
  // keeps the pixels near its line, where its E_k are 0; rows that are not
  // finite are kept.
  struct Reach {
    double a[3], b[3], c[3], t[3], x0, x1, y0, y1;  // E_k = a_k py - b_k px + c_k
    bool fixed, answer;
  };

  __device__ static Reach reach(const float* s, int ss, int j, const Params&) {
    double v[6];
    #pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = s[k * ss + j];
    Reach r;
    r.fixed = true;
    r.answer = true;
    if (!finite_all(v, 6)) return r;
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int n = k == 2 ? 0 : k + 1;
      r.a[k] = v[2 * n] - v[2 * k];
      r.b[k] = v[2 * n + 1] - v[2 * k + 1];
      r.c[k] = r.b[k] * v[2 * k] - r.a[k] * v[2 * k + 1];
      r.t[k] = 0.05 * (fabs(r.a[k]) + fabs(r.b[k]));
    }
    r.x0 = fmin(fmin(v[0], v[2]), v[4]);
    r.x1 = fmax(fmax(v[0], v[2]), v[4]);
    r.y0 = fmin(fmin(v[1], v[3]), v[5]);
    r.y1 = fmax(fmax(v[1], v[3]), v[5]);
    r.fixed = false;
    return r;
  }

  __device__ static bool reach_hits(const Reach& r, const TileBound& b) {
    if (r.fixed) return r.answer;
    const double s = fmax(fmax(fmax(r.x1 - b.x0, b.x1 - r.x0), r.y1 - b.y0), b.y1 - r.y0) + 16.0;
    const double err = 1e-5 * s * s;
    bool below = false, above = false;
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double hi = r.c[k] + fmax(r.a[k] * b.y0, r.a[k] * b.y1) +
                        fmax(-r.b[k] * b.x0, -r.b[k] * b.x1);
      const double lo = r.c[k] + fmin(r.a[k] * b.y0, r.a[k] * b.y1) +
                        fmin(-r.b[k] * b.x0, -r.b[k] * b.x1);
      const double slack = r.t[k] * (1.0 + 1e-6) + err;
      below = below || hi < -slack;
      above = above || lo > slack;
    }
    return !(below && above);
  }

  __device__ static bool may_hit(const float* s, int ss, int j, const TileBound& b,
                                 const Params& prm) {
    return reach_hits(reach(s, ss, j, prm), b);
  }
};

// Smooth opaque triangles (forward only): tri2d's coverage, rows 6-14 the
// vertices' colours (vertex k's channel c at 6 + 3 k + c), 15-17 their view
// z; the blend reads pixel_attrs. K1's cull stages rows 0-5 alone.
struct Tri2dSmooth : Tri2d {
  static constexpr bool PIXEL_ATTRS = true;
  static constexpr int ROWS = 18;
  static constexpr int DEPTH_ROW = 15;
  static constexpr int FWD_SLOTS = 18;
  static constexpr int BWD_SLOTS = 6;
  static constexpr int DEPTH_SLOT = 15;

  __device__ static void stage_fwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    #pragma unroll
    for (int r = 0; r < FWD_SLOTS; ++r) s[r * ss + j] = attrs[r * stride + col];
  }

  __device__ static void stage_bwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    #pragma unroll
    for (int r = 0; r < BWD_SLOTS; ++r) s[r * ss + j] = attrs[r * stride + col];
  }

  // ops/response.tri2d_smooth_pixel, term for term: barycentrics w =
  // (e1, e2, e0) / (e0 + e1 + e2), a_k = w_k / max(z_k, 1e-6), the depth
  // 1 / max(a_0 + a_1 + a_2, 1e-12) and the colour sum a_k c_k times it.
  __device__ static void pixel_attrs(const float* s, int ss, int j, const Hit& h, float* rgb,
                                     float& depth) {
    const float area = h.e[0] + h.e[1] + h.e[2];
    const float inv = 1.0f / (fabsf(area) < 1e-12f ? 1.0f : area);
    const float w[3] = {h.e[1] * inv, h.e[2] * inv, h.e[0] * inv};
    float a[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) a[k] = w[k] / fmaxf(s[(DEPTH_SLOT + k) * ss + j], 1e-6f);
    depth = 1.0f / fmaxf(a[0] + a[1] + a[2], 1e-12f);
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      rgb[c] = (a[0] * s[(6 + c) * ss + j] + a[1] * s[(9 + c) * ss + j] +
                a[2] * s[(12 + c) * ss + j]) * depth;
    }
  }
};

// The generalized Gaussian of degree n (threedgrt.h.slang:83-127) and its
// slope dK/dD (where the degree-0 kernel is above its floor, as the cutoff
// resp > min_response >= 0 ensures).
__device__ inline float kernel_response(float d, int degree) {
  switch (degree) {
    case 8: return expf(static_cast<float>(-0.000685871056241) * (d * d) * (d * d));
    case 5: return expf(static_cast<float>(-0.0185185185185) * d * d * sqrtf(d));
    case 4: return expf(static_cast<float>(-0.0555555555556) * d * d);
    case 3: return expf(static_cast<float>(-0.166666666667) * d * sqrtf(d));
    case 1: return expf(-1.5f * sqrtf(d));
    case 0: return fmaxf(1.0f - static_cast<float>(0.329630334487) * sqrtf(d), 0.0f);
    default: return expf(-0.5f * d);
  }
}

__device__ inline float kernel_response_slope(float d, float resp, int degree) {
  switch (degree) {
    case 8: return resp * (static_cast<float>(-0.000685871056241 * 4.0) * (d * d) * d);
    case 5: return resp * (static_cast<float>(-0.0185185185185 * 2.5) * d * sqrtf(d));
    case 4: return resp * (static_cast<float>(-0.0555555555556 * 2.0) * d);
    case 3: return resp * (static_cast<float>(-0.166666666667 * 1.5) * sqrtf(d));
    case 1: return resp * (-0.75f / sqrtf(d));
    case 0: return static_cast<float>(-0.1648151672435) / sqrtf(d);
    default: return -0.5f * resp;
  }
}

struct Gut3d {
  // K2 neither culls gut3d's pair lists nor reduces more than one pair at
  // once: the UT rect that cuts the lists already bounds the opacity (the
  // cull keeps 96 % of the pairs at 1080p), and on an H100 both made K2g
  // slower, the cull by its f64 tests, two pairs by the registers the
  // first pair's 14 rows hold through the second's VJP (PERF.md §6).
  static constexpr bool CULL_PAIRS = false;
  static constexpr int PAIR_GROUP = 1;
  static constexpr bool CLAMP = true, PIXEL_ATTRS = false, DEPTH_LIMIT = false;
  static constexpr int ROWS = 15;
  static constexpr int DEPTH_ROW = 14;
  static constexpr int GRAD_ROWS = 14;  // rows 0-13; rows 6-8 from the blend
  // slots: 0-2 p, 3-5 1/max(s, 1e-12), 6-8 rgb, 9-17 R row-major, 18
  // opacity; forward 19 depth; backward 19-22 q, 23-25 the scale factor
  static constexpr int S_POS = 0, S_INV = 3, S_R = 9, S_OP = 18, S_Q = 19, S_DS = 23;
  static constexpr int FWD_SLOTS = 20;
  static constexpr int BWD_SLOTS = 26;
  static constexpr int DEPTH_SLOT = 19;
  // the row indices of ops/response.py
  static constexpr int R_SCALE = 3, R_QUAT = 9, R_OPACITY = 13;

  struct Hit {
    float e[3], u[3], v[3], oc[3], dc[3], dn, dh[3], cr[3], dist, resp;
  };

  // R(q)[i][c], row i, column c, in the twin's order of operations
  __device__ static void rotation(float qw, float qx, float qy, float qz, float* r) {
    r[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
    r[1] = 2.0f * (qx * qy - qw * qz);
    r[2] = 2.0f * (qx * qz + qw * qy);
    r[3] = 2.0f * (qx * qy + qw * qz);
    r[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
    r[5] = 2.0f * (qy * qz - qw * qx);
    r[6] = 2.0f * (qx * qz - qw * qy);
    r[7] = 2.0f * (qy * qz + qw * qx);
    r[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  }

  // A lane's values as the twin's f32 rows hold them.
  struct Lane {
    float p[3], sc[3], rgb[3], q[4], op;
  };

  __device__ static Lane lane_of(const float* __restrict__ attrs, long long stride,
                                 long long col) {
    Lane l;
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      l.p[k] = attrs[k * stride + col];
      l.sc[k] = attrs[(R_SCALE + k) * stride + col];
      l.rgb[k] = attrs[(6 + k) * stride + col];
    }
    #pragma unroll
    for (int k = 0; k < 4; ++k) l.q[k] = attrs[(R_QUAT + k) * stride + col];
    l.op = attrs[R_OPACITY * stride + col];
    return l;
  }

  // slots 0-18, common to both directions
  __device__ static void put_common(const Lane& l, float* s, int ss, int j) {
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      s[(S_POS + k) * ss + j] = l.p[k];
      s[(S_INV + k) * ss + j] = 1.0f / fmaxf(l.sc[k], static_cast<float>(1e-12));
      s[(6 + k) * ss + j] = l.rgb[k];
    }
    float r[9];
    rotation(l.q[0], l.q[1], l.q[2], l.q[3], r);
    #pragma unroll
    for (int k = 0; k < 9; ++k) s[(S_R + k) * ss + j] = r[k];
    s[S_OP * ss + j] = l.op;
  }

  // the backward's slots 19-25: q and the scale chain factor
  __device__ static void put_bwd(const Lane& l, float* s, int ss, int j) {
    #pragma unroll
    for (int k = 0; k < 4; ++k) s[(S_Q + k) * ss + j] = l.q[k];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float inv = s[(S_INV + k) * ss + j];
      s[(S_DS + k) * ss + j] = l.sc[k] > static_cast<float>(1e-12) ? -(inv * inv) : 0.0f;
    }
  }

  __device__ static void stage_fwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    put_common(lane_of(attrs, stride, col), s, ss, j);
    s[DEPTH_SLOT * ss + j] = attrs[DEPTH_ROW * stride + col];
  }

  __device__ static void stage_bwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    const Lane l = lane_of(attrs, stride, col);
    put_common(l, s, ss, j);
    put_bwd(l, s, ss, j);
  }

  __device__ static float rot(const float* s, int ss, int j, int i, int c) {
    return s[(S_R + 3 * i + c) * ss + j];
  }

  __device__ static bool eval(const float* s, int ss, int j, const Pixel& p, const Params& prm,
                              float& a_raw, Hit& h) {
    #pragma unroll
    for (int k = 0; k < 3; ++k) h.e[k] = p.o[k] - s[(S_POS + k) * ss + j];
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float r0 = rot(s, ss, j, 0, c), r1 = rot(s, ss, j, 1, c), r2 = rot(s, ss, j, 2, c);
      h.u[c] = r0 * h.e[0] + r1 * h.e[1] + r2 * h.e[2];
      h.v[c] = r0 * p.d[0] + r1 * p.d[1] + r2 * p.d[2];
      const float inv = s[(S_INV + c) * ss + j];
      h.oc[c] = h.u[c] * inv;
      h.dc[c] = h.v[c] * inv;
    }
    h.dn = rsqrtf(h.dc[0] * h.dc[0] + h.dc[1] * h.dc[1] + h.dc[2] * h.dc[2] +
                  static_cast<float>(1e-30));
    #pragma unroll
    for (int k = 0; k < 3; ++k) h.dh[k] = h.dc[k] * h.dn;
    h.cr[0] = h.dh[1] * h.oc[2] - h.dh[2] * h.oc[1];
    h.cr[1] = h.dh[2] * h.oc[0] - h.dh[0] * h.oc[2];
    h.cr[2] = h.dh[0] * h.oc[1] - h.dh[1] * h.oc[0];
    h.dist = h.cr[0] * h.cr[0] + h.cr[1] * h.cr[1] + h.cr[2] * h.cr[2];
    h.resp = kernel_response(h.dist, prm.degree);
    a_raw = s[S_OP * ss + j] * h.resp;
    return a_raw > prm.alpha_min && h.resp > prm.min_response;
  }

  // ops/response.gut3d_alpha_vjp, per pixel, in its order of operations
  __device__ static void vjp(const float* s, int ss, int j, const Pixel& p, const Params& prm,
                             const Hit& h, float, float da, float* g) {
    const float d_op = da * h.resp;
    const float d_dist =
        da * s[S_OP * ss + j] * kernel_response_slope(h.dist, h.resp, prm.degree);
    float gc[3];
    #pragma unroll
    for (int k = 0; k < 3; ++k) gc[k] = 2.0f * h.cr[k] * d_dist;
    // cr = dh x oc: d dh = oc x gc, d oc = gc x dh
    const float d_dh[3] = {h.oc[1] * gc[2] - h.oc[2] * gc[1], h.oc[2] * gc[0] - h.oc[0] * gc[2],
                           h.oc[0] * gc[1] - h.oc[1] * gc[0]};
    const float d_oc[3] = {gc[1] * h.dh[2] - gc[2] * h.dh[1], gc[2] * h.dh[0] - gc[0] * h.dh[2],
                           gc[0] * h.dh[1] - gc[1] * h.dh[0]};
    // dh = dc rsqrt(|dc|^2 + eps)
    const float proj = d_dh[0] * h.dc[0] + d_dh[1] * h.dc[1] + d_dh[2] * h.dc[2];
    const float dn3 = h.dn * h.dn * h.dn;
    float d_u[3], d_v[3];
    #pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d_dc = h.dn * d_dh[c] - dn3 * proj * h.dc[c];
      const float inv = s[(S_INV + c) * ss + j];
      const float d_inv = d_oc[c] * h.u[c] + d_dc * h.v[c];
      d_u[c] = d_oc[c] * inv;
      d_v[c] = d_dc * inv;
      g[R_SCALE + c] = d_inv * s[(S_DS + c) * ss + j];
    }
    // d R[i][c] = d_u[c] (o_i - p_i) + d_v[c] d_i;  d p_i = -sum_c d_u[c] R[i][c]
    float gr[3][3];
    #pragma unroll
    for (int i = 0; i < 3; ++i) {
      #pragma unroll
      for (int c = 0; c < 3; ++c) gr[i][c] = d_u[c] * h.e[i] + d_v[c] * p.d[i];
      g[i] = -(d_u[0] * rot(s, ss, j, i, 0) + d_u[1] * rot(s, ss, j, i, 1) +
               d_u[2] * rot(s, ss, j, i, 2));
    }
    const float qw = s[S_Q * ss + j], qx = s[(S_Q + 1) * ss + j];
    const float qy = s[(S_Q + 2) * ss + j], qz = s[(S_Q + 3) * ss + j];
    g[R_QUAT] = 2.0f * (-qz * gr[0][1] + qy * gr[0][2] + qz * gr[1][0] - qx * gr[1][2] -
                        qy * gr[2][0] + qx * gr[2][1]);
    g[R_QUAT + 1] = 2.0f * (qy * gr[0][1] + qz * gr[0][2] + qy * gr[1][0] -
                            2.0f * qx * gr[1][1] - qw * gr[1][2] + qz * gr[2][0] +
                            qw * gr[2][1] - 2.0f * qx * gr[2][2]);
    g[R_QUAT + 2] = 2.0f * (-2.0f * qy * gr[0][0] + qx * gr[0][1] + qw * gr[0][2] +
                            qx * gr[1][0] + qz * gr[1][2] - qw * gr[2][0] + qz * gr[2][1] -
                            2.0f * qy * gr[2][2]);
    g[R_QUAT + 3] = 2.0f * (-2.0f * qz * gr[0][0] - qw * gr[0][1] + qx * gr[0][2] +
                            qw * gr[1][0] - 2.0f * qz * gr[1][1] + qy * gr[1][2] +
                            qx * gr[2][0] + qy * gr[2][1]);
    g[R_OPACITY] = d_op;
  }

  // The tile's rays in one bound: the mean origin c and the origin radius
  // rho = max |o_i - c|; a unit axis a, the normalised sum of the d_i, and
  // the widest angle theta from it, cos_t = min d_i . a / |d_i|. valid: every
  // ray finite with |d_i| > 0.
  struct TileBound {
    double c[3], a[3], rho, cos_t, sin_t;
    bool valid;
  };

  // A ray's six values (origin, direction) in v, |d|^2 in dd; whether it is
  // usable (finite, |d| > 0).
  __device__ static bool ray_of(const Pixel& p, double* v, double& dd) {
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = p.o[k];
      v[3 + k] = p.d[k];
    }
    dd = v[3] * v[3] + v[4] * v[4] + v[5] * v[5];
    return finite_all(v, 6) && dd > 0.0;
  }

  // The centre and axis from the six sums over n_rays rays.
  __device__ static void centre_axis(TileBound& b, const double* sum, double n_rays) {
    const double n = sqrt(sum[3] * sum[3] + sum[4] * sum[4] + sum[5] * sum[5]);
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      b.c[k] = sum[k] / n_rays;
      b.a[k] = sum[3 + k] / n;
    }
  }

  // The warp's largest squared origin distance from c and least cosine to
  // a, in every lane.
  __device__ static void warp_spread(const TileBound& b, const Pixel& p, double dd, double& r2,
                                     double& cs) {
    const double e[3] = {p.o[0] - b.c[0], p.o[1] - b.c[1], p.o[2] - b.c[2]};
    r2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
    cs = (p.d[0] * b.a[0] + p.d[1] * b.a[1] + p.d[2] * b.a[2]) / sqrt(dd);
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r2 = fmax(r2, __shfl_xor_sync(0xffffffffu, r2, o));
      cs = fmin(cs, __shfl_xor_sync(0xffffffffu, cs, o));
    }
  }

  __device__ static void spread_to(TileBound& b, double r2, double cs) {
    b.rho = sqrt(r2);
    b.cos_t = cs;
    b.sin_t = sqrt(fmax(0.0, 1.0 - cs * cs));
  }

  // A block reduction over the PIX pixel rays, in double, in a fixed order
  // (warp shuffles, then the warps in order).
  __device__ static void tile_bound(TileBound& b, int, int, const Pixel& p) {
    __shared__ double part[PIX / 32][6];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double v[6], dd;
    const bool ok = ray_of(p, v, dd);
    #pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = warp_sum_d(v[k]);
    if (lane == 0) {
      #pragma unroll
      for (int k = 0; k < 6; ++k) part[warp][k] = v[k];
    }
    const bool valid = __syncthreads_and(ok);
    if (threadIdx.x == 0) {
      double sum[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int w = 0; w < PIX / 32; ++w) {
        #pragma unroll
        for (int k = 0; k < 6; ++k) sum[k] += part[w][k];
      }
      centre_axis(b, sum, PIX);
      b.valid = valid;
    }
    __syncthreads();
    double r2, cs;
    warp_spread(b, p, dd, r2, cs);
    if (lane == 0) {  // thread 0 read part before the barrier above
      part[warp][0] = r2;
      part[warp][1] = cs;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < PIX / 32; ++w) {
        r2 = fmax(r2, part[w][0]);
        cs = fmin(cs, part[w][1]);
      }
      spread_to(b, r2, cs);
    }
    __syncthreads();
  }

  // The same bound over the calling warp's 32 rays alone (the mean over 32),
  // written by its lane 0; no barrier. Every lane holds the same sums (each
  // butterfly round adds a pair of values in either order), so the same c
  // and a.
  __device__ static void warp_bound(TileBound& b, int, int, const Pixel& p) {
    double v[6], dd;
    const bool valid = __all_sync(0xffffffffu, ray_of(p, v, dd));
    #pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = warp_sum_d(v[k]);
    TileBound w;
    centre_axis(w, v, 32);
    double r2, cs;
    warp_spread(w, p, dd, r2, cs);
    if ((threadIdx.x & 31) == 0) {
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        b.c[k] = w.c[k];
        b.a[k] = w.a[k];
      }
      b.valid = valid;
      spread_to(b, r2, cs);
    }
  }

  // The canonical distance sqrt(D) below which K_degree(D) > thr (0 < thr <
  // 1), kernel_response inverted, with -ln thr (or, degree 0, 1 - thr)
  // raised by 1e-5 of itself plus 1e-5: more than the f32 rounding of the
  // response, its exponent and the cutoffs' products.
  __device__ static double cut_distance(double thr, int degree) {
    const double g = -log(thr) * (1.0 + 1e-5) + 1e-5;
    switch (degree) {
      case 8: return pow(g / 0.000685871056241, 0.125);
      case 5: return pow(g / 0.0185185185185, 0.2);
      case 4: return pow(g / 0.0555555555556, 0.25);
      case 3: return pow(g / 0.166666666667, 1.0 / 3.0);
      case 1: return g / 1.5;
      case 0: return (1.0 - thr + 1e-5) / 0.329630334487;
      default: return sqrt(2.0 * g);
    }
  }

  // A hit needs resp > thr = max(min_response, alpha_min / opacity), and
  // resp <= 1: opacity <= alpha_min or thr >= 1 never hits. Else it needs
  // sqrt(D) < cut_distance(thr). The canonical map S^-1 R^T shrinks no
  // length by more than min(1/s) sigma_min(R), and sigma_min(R(q)) >= 1 -
  // 2 | |q|^2 - 1 | (R(q) = |q|^2 rot + (1 - |q|^2) I), less 1e-5 for R's f32
  // entries; so a hit needs the world distance from p to the pixel's ray
  // line below r = sqrt(D) / (min(1/s) sigma_min). eval's f32 sqrt(D) lies
  // within err = 4e-6 (kappa + 1) |o - p| max(1/s) of the exact one (kappa =
  // max(1/s) / min(1/s): the f32 direction dc errs by ~7e-7 kappa, oc by
  // ~7e-7 |o - p| max(1/s)), and a tile's rays all pass at least
  // |v x a| cos_t - |v . a| sin_t - rho from p (v = p - c: the angle from v
  // to any ray line is at least the angle to a less theta, and the origins
  // lie within rho of c). Kept where min(1/s) sigma_min < 1e-10 (the rsqrt's
  // 1e-30 would then shorten dh) or sigma_min < 0.5. Nothing here depends on
  // which rays the bound holds.
  // The lane's part: a fixed answer, or what the test against a bound reads.
  struct Reach {
    double p[3], kappa, inv_max, cut, shrink;  // kappa: 4e-6 (max(1/s) / min(1/s) + 1)
    bool fixed, answer;
  };

  __device__ static Reach reach(const float* s, int ss, int j, const Params& prm) {
    double v[17];
    #pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = s[(S_POS + k) * ss + j];
      v[3 + k] = s[(S_INV + k) * ss + j];
    }
    #pragma unroll
    for (int k = 0; k < 9; ++k) v[6 + k] = s[(S_R + k) * ss + j];
    v[15] = s[S_OP * ss + j];
    const double qw = s[S_Q * ss + j], qx = s[(S_Q + 1) * ss + j];
    const double qy = s[(S_Q + 2) * ss + j], qz = s[(S_Q + 3) * ss + j];
    v[16] = qw * qw + qx * qx + qy * qy + qz * qz;
    Reach r{{v[0], v[1], v[2]}, 0.0, 0.0, 0.0, 0.0, true, true};
    const double op = v[15], amin = prm.alpha_min;
    if (!(finite_all(v, 17) && amin >= 0.0)) return r;
    r.answer = false;
    if (op <= amin) return r;  // resp <= 1: a_raw <= opacity
    double thr = amin / op;
    if ((double)prm.min_response > thr) thr = prm.min_response;
    if (thr >= 1.0) return r;  // resp <= 1
    const double inv_min = fmin(v[3], fmin(v[4], v[5]));
    r.inv_max = fmax(v[3], fmax(v[4], v[5]));
    const double sig = 1.0 - 2.0 * fabs(v[16] - 1.0) - 1e-5;
    r.shrink = inv_min * sig;
    r.answer = true;
    if (!(sig >= 0.5 && r.shrink >= 1e-10)) return r;
    r.kappa = 4e-6 * (r.inv_max / inv_min + 1.0);
    r.cut = cut_distance(thr, prm.degree) * (1.0 + 1e-5);
    r.fixed = false;
    return r;
  }

  __device__ static bool reach_hits(const Reach& r, const TileBound& b) {
    if (!b.valid) return true;
    if (r.fixed) return r.answer;
    const double w[3] = {r.p[0] - b.c[0], r.p[1] - b.c[1], r.p[2] - b.c[2]};
    const double along = fabs(w[0] * b.a[0] + w[1] * b.a[1] + w[2] * b.a[2]);
    const double x0 = w[1] * b.a[2] - w[2] * b.a[1], x1 = w[2] * b.a[0] - w[0] * b.a[2];
    const double x2 = w[0] * b.a[1] - w[1] * b.a[0];
    const double across = sqrt(x0 * x0 + x1 * x1 + x2 * x2);
    const double extent = sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]) + b.rho;
    const double err = r.kappa * extent * r.inv_max;
    const double radius = (r.cut + err) / r.shrink * (1.0 + CULL_REL) + 1e-7 * extent;
    const double nearest = fmax(0.0, across * b.cos_t - along * b.sin_t) - b.rho;
    return !(nearest > radius);
  }

  __device__ static bool may_hit(const float* s, int ss, int j, const TileBound& b,
                                 const Params& prm) {
    return reach_hits(reach(s, ss, j, prm), b);
  }
};

// gut3d on the packed rows 0-2 position, 3 (sx, sy), 4 (sz, qw), 5 (qx, qy),
// 6 (qz, depth), 7 (r, g), 8 (b, opacity u16), 9 the sort depth: 9 words
// staged for gut3d's 26 backward slots, 10 for its 20 forward ones. The
// unpacked quaternion is renormalised, q rsqrt(qw^2 + qx^2 + qy^2 + qz^2 +
// 1e-30), the twin's torch.rsqrt in its order of sums, before rotation.
struct Gut3dp : Gut3d {
  static constexpr int ROWS = 10;
  static constexpr int DEPTH_ROW = 9;

  __device__ static Lane lane_of(const float* __restrict__ attrs, long long stride,
                                 long long col) {
    Lane l;
    #pragma unroll
    for (int k = 0; k < 3; ++k) l.p[k] = attrs[k * stride + col];
    const float sxy = attrs[3 * stride + col], szw = attrs[4 * stride + col];
    const float qxy = attrs[5 * stride + col], qzd = attrs[6 * stride + col];
    const float rg = attrs[7 * stride + col], bo = attrs[8 * stride + col];
    l.sc[0] = bf16_hi(sxy);
    l.sc[1] = bf16_lo(sxy);
    l.sc[2] = bf16_hi(szw);
    const float qw = bf16_lo(szw), qx = bf16_hi(qxy), qy = bf16_lo(qxy), qz = bf16_hi(qzd);
    const float qn = rsqrtf(qw * qw + qx * qx + qy * qy + qz * qz + static_cast<float>(1e-30));
    l.q[0] = qw * qn;
    l.q[1] = qx * qn;
    l.q[2] = qy * qn;
    l.q[3] = qz * qn;
    l.rgb[0] = bf16_hi(rg);
    l.rgb[1] = bf16_lo(rg);
    l.rgb[2] = bf16_hi(bo);
    l.op = u16_lo(bo);
    return l;
  }

  __device__ static void stage_fwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    put_common(lane_of(attrs, stride, col), s, ss, j);
    s[DEPTH_SLOT * ss + j] = attrs[DEPTH_ROW * stride + col];
  }

  __device__ static void stage_bwd(const float* __restrict__ attrs, long long stride,
                                   long long col, float* s, int ss, int j) {
    const Lane l = lane_of(attrs, stride, col);
    put_common(l, s, ss, j);
    put_bwd(l, s, ss, j);
  }
};
// Stochastic transparency (the kernels' STOCH forms; ops/response.py
// hash_uniform and stochastic_accept, bit for bit): the JAX kernels'
// uniform from (key, pixel, lane), an xxhash32-flavoured uint32 mix whose
// top 24 bits times 2^-24 is exact in f32 (rasterize_pallas.py:161-177),
// and the binary accept of an alpha after its clamp: exactly 1 where
// u < a and a > 0, else 0 (:180-194). `pix` is the tile's row-major pixel,
// `lane` the pair's place in its blend chunk; each kernel keys as the TPU
// kernel it replaces keys its chunk.
__device__ inline float hash_uniform(unsigned key, unsigned pix, unsigned lane) {
  unsigned h = pix * 0x9E3779B1u ^ lane * 0x85EBCA77u ^ key * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  h *= 0x297A2D39u;
  h ^= h >> 15;
  return (float)(int)(h >> 8) * (1.0f / 16777216.0f);
}

__device__ inline float stochastic_accept(float a, float u) {
  return (u < a && a > 0.0f) ? 1.0f : 0.0f;
}

// One round of a blend step's cull: thread i holds lane r0 + i of the step
// (round r0 / PIX), in list order, and `keep` says whether the model's
// may_hit kept it. Returns the lane's place among the step's kept lanes, in
// list order (meaningful where keep), and adds the round's kept lanes to
// n_kept in every thread: a warp ballot, the warps' counts and the rounds
// before. Rounds alternate between the two buffers of `count`, so one
// barrier per round suffices. All threads call it, once per round.
__device__ inline int kept_place(bool keep, int round, int (*count)[WARPS], int& n_kept) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  int* c = count[round & 1];
  if (lane == 0) c[warp] = __popc(ballot);
  __syncthreads();
  int before = n_kept + __popc(ballot & ((1u << lane) - 1u));
  #pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? c[w] : 0;
    n_kept += c[w];
  }
  return before;
}

}  // namespace response
