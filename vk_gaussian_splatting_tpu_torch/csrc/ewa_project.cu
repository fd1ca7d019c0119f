// The EWA projection of a 3DGS splat set, forward and backward: the EWA part
// of ops/projection.project_splats (everything but the SH colour) as two
// kernels.
//
// Replaces no TPU kernel. The JAX package computes this pass in jnp
// (vk_gaussian_splatting_tpu/ops/projection.py), and the port first composed
// it of PyTorch column arithmetic: some 240 elementwise launches over strided
// (N,) columns and stacks, and as many again in autograd's backward (6.1 ms
// of a 6.13M-splat frame and ~30 ms of its training step on an H100). These
// kernels were added for speed; the plain composition stays in
// ops/projection.py as the CPU path and the yardstick on the card
// (project_splats_ref, and project_splats_bwd_ref for the backward).
//
// Per splat, the forward reads the mean, the packed covariance (xx, xy, xz,
// yy, yz, zz), the opacity (column 3 of the RGBA colour row) and, under size
// culling, the log-scales; the camera (viewmat (4,4), fx, fy, cx, cy, near,
// far) it reads through pointers, so no value crosses to the host. It writes
// the ProjectedSplats fields but the colour: xy (N,2), conic (N,3), depth
// (N,), radius (N,2), alpha (N,) and valid (N,) as bytes 0/1. Each step is
// the plain version's, operation for operation:
//   p = W m + t (each row an FMA chain, as the card's f32 GEMM sums it);
//   z = p.z, with |z| < 1e-6 replaced by 1e-6; u = fx p.x / z + cx, v alike;
//   the Jacobian's x/z and y/z clamped to 1.3 tan(fov) (tan from 0.5 w /
//   fx as reciprocal(fx) * 0.5 w, as PyTorch divides a scalar by a tensor);
//   cov2d = J (W S W^T) J^T in the plain version's expansion; the dilation;
//   the Mip-Splatting compensation sqrt(max(det_orig / det, 0)); the conic;
//   the eigenvalue radius sqrt(8) sqrt(lambda1), clamped, scaled, ceil'd
//   (0.2 eigenvalues in point-cloud mode); the NDC centre cull ((u - cx) *
//   (1 / 0.5 w), as the card divides a tensor by a scalar), near and far,
//   det > 0, lambda2 > 0, the alpha cull and the optional size cull.
// The backward recomputes those intermediates from the same inputs (nothing
// of the forward is saved) and writes, each only where a gradient is asked
// for, d_means (N,3), d_cov3d (N,6) and d_color (N,4), whose columns 0-2 are
// zero; absent cotangents count as zero. At the clamps and selections it
// takes autograd's conventions: torch.clamp passes the gradient where the
// input lies within its bounds, edges included; torch.where passes it to the
// branch taken; sqrt's derivative is g / (2 sqrt(x)), at 0 too; radius and
// valid carry none. The arithmetic is f32, built with -fmad=false.
//
// Bound: bytes. The forward reads 12 B of mean, 24 of covariance and the
// 16-B colour row (a sector holds two rows, so all of it moves) and writes
// 8 + 12 + 4 + 8 + 4 + 1 = 37 B: 89 B a splat, 0.546 GB at 6.13M splats, a
// bound of 0.163 ms at 3.35 TB/s (0.406 ms at 15.3M); size culling reads 12
// B more. The backward reads the mean, covariance and colour (52 B) and the
// cotangents of xy, conic, depth and alpha (28 B), and writes d_means,
// d_cov3d and d_color (52 B): 132 B a splat, 0.809 GB and 0.242 ms at
// 6.13M. About 150 f32 operations a splat forward, 300 backward: far below.
//
// Design: a persistent grid, a few blocks of TILE = 128 threads an SM, each
// block walking tiles of 128 consecutive splats with a stride of the grid.
// A thread's rows are 12, 24 and 16 B wide, so a warp reading one field of
// each of its 32 splats would touch sectors 12-24 B apart and use a few
// bytes of each; instead the block copies each of its tile's row arrays,
// contiguous in device memory, into shared memory with 16-byte cp.async
// copies on neighbouring addresses, and each thread reads its splat from
// there. The copies are double-buffered: the next tile's are in flight
// while the block computes this one. The (N,3) and (N,6) outputs go back
// through shared memory and leave as coalesced 16-byte stores; the (N,2),
// (N,) and (N,4) ones are already contiguous across a warp as one 8-, 4-,
// 1- or 16-byte store a thread. The last tile copies its ragged end a word
// at a time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int TILE = 128;

// the plain version's Python constants, rounded to f32 as PyTorch rounds a
// double scalar that meets an f32 tensor
constexpr float Z_EPS = static_cast<float>(1e-6);
constexpr float FOV_CLAMP = static_cast<float>(1.3);
constexpr float MIN_DISC = static_cast<float>(0.1);
constexpr float PCM_LAMBDA = static_cast<float>(0.2);
constexpr float SQRT8 = static_cast<float>(2.8284271247);
constexpr float MIN_ABS_DEPTH = static_cast<float>(1e-4);

// The scalars of RasterConfig and RenderConfig that the projection reads,
// each already rounded to f32 as the plain version's scalars are.
struct EwaParams {
  float half_w, half_h;  // 0.5 width, 0.5 height
  float inv_half_w, inv_half_h;  // 1 / (0.5 width), 1 / (0.5 height), in f32
  float dilation, extent_sigma, max_basis_px, clip, alpha_min, size_min_px;
  float opacity_gain, splat_scale;
  int ms_antialiasing, point_cloud_mode, size_culling;
};

// The camera: W (3x3, row-major), t, fx, fy, cx, cy, near, far.
struct Cam {
  float w[9], t[3], fx, fy, cx, cy, near, far;
};

// torch.clamp's forward on the card: NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ void load_cam(Cam& c, const float* viewmat, const float* fx, const float* fy,
                         const float* cx, const float* cy, const float* near, const float* far) {
  for (int r = 0; r < 3; ++r) {
    for (int k = 0; k < 3; ++k) c.w[3 * r + k] = viewmat[4 * r + k];
    c.t[r] = viewmat[4 * r + 3];
  }
  c.fx = *fx;
  c.fy = *fy;
  c.cx = *cx;
  c.cy = *cy;
  c.near = near ? *near : 0.0f;
  c.far = far ? *far : 0.0f;
}

// The intermediates of one splat that the forward's outputs and the
// backward's chain rule read.
struct Ewa {
  float px, py, pz;      // view-space mean
  float zs, iz;          // z with |z| < 1e-6 replaced; its reciprocal
  float rx, ry, lim_x, lim_y;  // x/z and y/z before the clamp; the clamp's bounds
  float rxc, ryc, tx, ty;      // clamped, and times z
  float q1x, q2x, q1y, q2y;    // -fx tx, -fx tx / z; the same in y
  float j00, j02, j11, j12;
  float m00, m01, m02, m11, m12, m22;
  float a, b, c, A, B, C, det_orig, det;
  float u, v, fxpx, fypy;
};

__device__ __forceinline__ void ewa(const Cam& cam, const EwaParams& p, const float* m,
                                    const float* s, Ewa& e) {
  const float* w = cam.w;
  // the view transform: each row summed as an f32 GEMM sums it, then + t
  e.px = fmaf(w[2], m[2], fmaf(w[1], m[1], w[0] * m[0])) + cam.t[0];
  e.py = fmaf(w[5], m[2], fmaf(w[4], m[1], w[3] * m[0])) + cam.t[1];
  e.pz = fmaf(w[8], m[2], fmaf(w[7], m[1], w[6] * m[0])) + cam.t[2];
  e.zs = fabsf(e.pz) < Z_EPS ? Z_EPS : e.pz;
  e.fxpx = cam.fx * e.px;
  e.fypy = cam.fy * e.py;
  e.u = e.fxpx / e.zs + cam.cx;
  e.v = e.fypy / e.zs + cam.cy;

  e.iz = 1.0f / e.zs;
  e.lim_x = FOV_CLAMP * ((1.0f / cam.fx) * p.half_w);
  e.lim_y = FOV_CLAMP * ((1.0f / cam.fy) * p.half_h);
  e.rx = e.px * e.iz;
  e.ry = e.py * e.iz;
  e.rxc = clamp(e.rx, -e.lim_x, e.lim_x);
  e.ryc = clamp(e.ry, -e.lim_y, e.lim_y);
  e.tx = e.rxc * e.zs;
  e.ty = e.ryc * e.zs;
  e.j00 = cam.fx * e.iz;
  e.q1x = -cam.fx * e.tx;
  e.q2x = e.q1x * e.iz;
  e.j02 = e.q2x * e.iz;
  e.j11 = cam.fy * e.iz;
  e.q1y = -cam.fy * e.ty;
  e.q2y = e.q1y * e.iz;
  e.j12 = e.q2y * e.iz;

  // t_i = W_i S; m_ij = t_i . W_j (ewa_project_cov's expansion)
  float t[3][3];
  for (int i = 0; i < 3; ++i) {
    const float wi0 = w[3 * i], wi1 = w[3 * i + 1], wi2 = w[3 * i + 2];
    t[i][0] = wi0 * s[0] + wi1 * s[1] + wi2 * s[2];
    t[i][1] = wi0 * s[1] + wi1 * s[3] + wi2 * s[4];
    t[i][2] = wi0 * s[2] + wi1 * s[4] + wi2 * s[5];
  }
  auto mm = [&](int i, int j) {
    return t[i][0] * w[3 * j] + t[i][1] * w[3 * j + 1] + t[i][2] * w[3 * j + 2];
  };
  e.m00 = mm(0, 0);
  e.m01 = mm(0, 1);
  e.m02 = mm(0, 2);
  e.m11 = mm(1, 1);
  e.m12 = mm(1, 2);
  e.m22 = mm(2, 2);

  const float j00 = e.j00, j02 = e.j02, j11 = e.j11, j12 = e.j12;
  e.a = j00 * j00 * e.m00 + 2.0f * j00 * j02 * e.m02 + j02 * j02 * e.m22;
  e.b = j00 * j11 * e.m01 + j00 * j12 * e.m02 + j02 * j11 * e.m12 + j02 * j12 * e.m22;
  e.c = j11 * j11 * e.m11 + 2.0f * j11 * j12 * e.m12 + j12 * j12 * e.m22;
  e.det_orig = e.a * e.c - e.b * e.b;
  e.A = e.a + p.dilation;
  e.B = e.b;
  e.C = e.c + p.dilation;
  e.det = e.A * e.C - e.B * e.B;
}

__global__ void __launch_bounds__(TILE)
    ewa_project_fwd_kernel(const float* __restrict__ means, const float* __restrict__ cov3d,
                           const float* __restrict__ color, const float* __restrict__ scales_log,
                           const float* viewmat, const float* fx, const float* fy,
                           const float* cx, const float* cy, const float* near,
                           const float* far, EwaParams p, long long n,
                           float* __restrict__ xy, float* __restrict__ conic,
                           float* __restrict__ depth, float* __restrict__ radius,
                           float* __restrict__ alpha, uint8_t* __restrict__ valid) {
  __shared__ __align__(16) float s_mean[2][TILE * 3];
  __shared__ __align__(16) float s_cov[2][TILE * 6];
  __shared__ __align__(16) float s_col[2][TILE * 4];
  __shared__ __align__(16) float s_scl[2][TILE * 3];
  __shared__ __align__(16) float s_out[TILE * 3];  // the conic
  Cam cam;
  load_cam(cam, viewmat, fx, fy, cx, cy, near, far);
  const long long tiles = (n + TILE - 1) / TILE;
  const int i = threadIdx.x;

  auto prefetch = [&](long long tile, int buf) {
    const long long n0 = tile * TILE;
    const int rows = (int)min((long long)TILE, n - n0);
    stage_in<4>(s_mean[buf], means + n0 * 3, rows * 12);
    stage_in<4>(s_cov[buf], cov3d + n0 * 6, rows * 24);
    stage_in<4>(s_col[buf], color + n0 * 4, rows * 16);
    if (p.size_culling) stage_in<4>(s_scl[buf], scales_log + n0 * 3, rows * 12);
  };

  long long tile = blockIdx.x;
  if (tile < tiles) prefetch(tile, 0);
  commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) prefetch(next, buf ^ 1);
    commit();
    landed<1>();  // this tile's copies; the next tile's stay in flight
    const long long n0 = tile * TILE;
    const int rows = (int)min((long long)TILE, n - n0);
    if (i < rows) {
      Ewa e;
      ewa(cam, p, &s_mean[buf][3 * i], &s_cov[buf][6 * i], e);
      float al = s_col[buf][4 * i + 3] * p.opacity_gain;
      if (p.ms_antialiasing) {
        const float den = e.det == 0.0f ? 1.0f : e.det;
        al = al * sqrtf(clamp_min(e.det_orig / den, 0.0f));
      }
      const float ds = e.det <= 0.0f ? 1.0f : e.det;
      s_out[3 * i] = e.C / ds;
      s_out[3 * i + 1] = -e.B / ds;
      s_out[3 * i + 2] = e.A / ds;

      const float mid = 0.5f * (e.A + e.C);
      const float term = sqrtf(clamp_min(mid * mid - e.det, MIN_DISC));
      float l1 = mid + term, l2 = mid - term;
      if (p.point_cloud_mode) l1 = l2 = PCM_LAMBDA;
      float r = ceilf(clamp_max(p.extent_sigma * sqrtf(clamp_min(l1, 0.0f)), p.max_basis_px) *
                      p.splat_scale);

      const float ndc_x = (e.u - cam.cx) * p.inv_half_w;
      const float ndc_y = (e.v - cam.cy) * p.inv_half_h;
      bool ok = (e.pz > cam.near) & (e.pz < cam.far) & (fabsf(ndc_x) <= p.clip) &
                (fabsf(ndc_y) <= p.clip) & (e.det > 0.0f) & (l2 > 0.0f) & (al >= p.alpha_min);
      if (p.size_culling) {
        const float* sl = &s_scl[buf][3 * i];
        const float e0 = expf(sl[0]), e1 = expf(sl[1]), e2 = expf(sl[2]);
        // amax over the three, NaN propagating
        float smax = e0;
        if (isnan(e1) || e1 > smax) smax = isnan(smax) ? smax : e1;
        if (isnan(e2) || e2 > smax) smax = isnan(smax) ? smax : e2;
        smax = smax * p.splat_scale;
        const float fmax = (isnan(cam.fx) || isnan(cam.fy)) ? NAN : fmaxf(cam.fx, cam.fy);
        const float extent = smax * SQRT8 * 2.0f * fmax / clamp_min(fabsf(e.pz), MIN_ABS_DEPTH);
        ok = ok & (extent >= p.size_min_px);
      }
      if (!ok) r = 0.0f;
      const long long g = n0 + i;
      reinterpret_cast<float2*>(xy)[g] = make_float2(e.u, e.v);
      depth[g] = e.pz;
      reinterpret_cast<float2*>(radius)[g] = make_float2(r, r);
      alpha[g] = al;
      valid[g] = ok ? 1 : 0;
    }
    __syncthreads();
    stage_out<4>(conic + n0 * 3, s_out, rows * 12);
    // the next pass overwrites s_out, and this buffer's copies, only after
    // its own landed<1>() barrier, which every thread reaches after this store
  }
  wait_group<0>();
}

__global__ void __launch_bounds__(TILE)
    ewa_project_bwd_kernel(const float* __restrict__ means, const float* __restrict__ cov3d,
                           const float* __restrict__ color, const float* viewmat,
                           const float* fx, const float* fy, const float* cx, const float* cy,
                           EwaParams p, const float* __restrict__ d_xy,
                           const float* __restrict__ d_conic, const float* __restrict__ d_depth,
                           const float* __restrict__ d_alpha, long long n,
                           float* __restrict__ d_means, float* __restrict__ d_cov3d,
                           float* __restrict__ d_color) {
  __shared__ __align__(16) float s_mean[2][TILE * 3];  // means in, d_means out
  __shared__ __align__(16) float s_cov[2][TILE * 6];   // covariances in, d_cov3d out
  __shared__ __align__(16) float s_col[2][TILE * 4];
  __shared__ __align__(16) float s_dxy[2][TILE * 2];
  __shared__ __align__(16) float s_dcon[2][TILE * 3];
  __shared__ __align__(16) float s_dz[2][TILE];
  __shared__ __align__(16) float s_dal[2][TILE];
  Cam cam;
  load_cam(cam, viewmat, fx, fy, cx, cy, nullptr, nullptr);
  const long long tiles = (n + TILE - 1) / TILE;
  const int i = threadIdx.x;
  // only an alpha compensated by ms_antialiasing has a gradient that reads
  // the opacity
  const bool need_op = p.ms_antialiasing && d_alpha != nullptr;

  auto prefetch = [&](long long tile, int buf) {
    const long long n0 = tile * TILE;
    const int rows = (int)min((long long)TILE, n - n0);
    stage_in<4>(s_mean[buf], means + n0 * 3, rows * 12);
    stage_in<4>(s_cov[buf], cov3d + n0 * 6, rows * 24);
    if (need_op) stage_in<4>(s_col[buf], color + n0 * 4, rows * 16);
    if (d_xy) stage_in<4>(s_dxy[buf], d_xy + n0 * 2, rows * 8);
    if (d_conic) stage_in<4>(s_dcon[buf], d_conic + n0 * 3, rows * 12);
    if (d_depth) stage_in<4>(s_dz[buf], d_depth + n0, rows * 4);
    if (d_alpha) stage_in<4>(s_dal[buf], d_alpha + n0, rows * 4);
  };

  long long tile = blockIdx.x;
  if (tile < tiles) prefetch(tile, 0);
  commit();
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long next = tile + gridDim.x;
    if (next < tiles) prefetch(next, buf ^ 1);
    commit();
    landed<1>();
    const long long n0 = tile * TILE;
    const int rows = (int)min((long long)TILE, n - n0);
    if (i < rows) {
      float* mean = &s_mean[buf][3 * i];
      float* cov = &s_cov[buf][6 * i];
      Ewa e;
      ewa(cam, p, mean, cov, e);
      const float gu = d_xy ? s_dxy[buf][2 * i] : 0.0f;
      const float gv = d_xy ? s_dxy[buf][2 * i + 1] : 0.0f;
      const float gc0 = d_conic ? s_dcon[buf][3 * i] : 0.0f;
      const float gc1 = d_conic ? s_dcon[buf][3 * i + 1] : 0.0f;
      const float gc2 = d_conic ? s_dcon[buf][3 * i + 2] : 0.0f;
      const float gz = d_depth ? s_dz[buf][i] : 0.0f;
      const float ga = d_alpha ? s_dal[buf][i] : 0.0f;

      // alpha = (opacity gain) [* sqrt(max(det_orig / den, 0))]; with no
      // cotangent of alpha, nothing flows through it (not even the NaN of
      // 0 / (2 sqrt(0)))
      float d_op = ga, d_det = 0.0f, d_do = 0.0f;
      if (need_op) {
        const float op = s_col[buf][4 * i + 3] * p.opacity_gain;
        const float den = e.det == 0.0f ? 1.0f : e.det;
        const float ratio = e.det_orig / den;
        const float sq = sqrtf(clamp_min(ratio, 0.0f));
        d_op = ga * sq;
        const float d_ratio = ratio >= 0.0f ? (ga * op) / (2.0f * sq) : 0.0f;
        d_do = d_ratio / den;
        if (e.det != 0.0f) d_det = -d_ratio * (ratio / den);
      }
      if (d_color != nullptr)
        reinterpret_cast<float4*>(d_color)[n0 + i] =
            make_float4(0.0f, 0.0f, 0.0f, d_op * p.opacity_gain);

      if (d_means != nullptr || d_cov3d != nullptr) {
        // conic = (C, -B, A) / ds
        const float ds = e.det <= 0.0f ? 1.0f : e.det;
        const float c0 = e.C / ds, c1 = -e.B / ds, c2 = e.A / ds;
        float d_A = gc2 / ds, d_B = -(gc1 / ds), d_C = gc0 / ds;
        if (!(e.det <= 0.0f)) d_det = d_det - (gc0 * c0 + gc1 * c1 + gc2 * c2) / ds;
        // det = A C - B B; det_orig = a c - b b
        d_A = d_A + d_det * e.C;
        d_C = d_C + d_det * e.A;
        d_B = d_B - 2.0f * e.B * d_det;
        const float d_a = d_A + d_do * e.c;
        const float d_c = d_C + d_do * e.a;
        const float d_b = d_B - 2.0f * e.b * d_do;

        // cov2d = J M J^T
        const float j00 = e.j00, j02 = e.j02, j11 = e.j11, j12 = e.j12;
        const float d_j00 = d_a * (2.0f * j00 * e.m00 + 2.0f * j02 * e.m02) +
                            d_b * (j11 * e.m01 + j12 * e.m02);
        const float d_j02 = d_a * (2.0f * j00 * e.m02 + 2.0f * j02 * e.m22) +
                            d_b * (j11 * e.m12 + j12 * e.m22);
        const float d_j11 = d_c * (2.0f * j11 * e.m11 + 2.0f * j12 * e.m12) +
                            d_b * (j00 * e.m01 + j02 * e.m12);
        const float d_j12 = d_c * (2.0f * j11 * e.m12 + 2.0f * j12 * e.m22) +
                            d_b * (j00 * e.m02 + j02 * e.m22);

        if (d_cov3d != nullptr) {
          const float d_m00 = d_a * j00 * j00;
          const float d_m01 = d_b * j00 * j11;
          const float d_m02 = d_a * 2.0f * j00 * j02 + d_b * j00 * j12;
          const float d_m11 = d_c * j11 * j11;
          const float d_m12 = d_b * j02 * j11 + d_c * 2.0f * j11 * j12;
          const float d_m22 = d_a * j02 * j02 + d_b * j02 * j12 + d_c * j12 * j12;
          // m_ij = t_i . W_j, t_i = W_i S
          const float* w = cam.w;
          float dt[3][3];
          for (int k = 0; k < 3; ++k) {
            dt[0][k] = d_m00 * w[k] + d_m01 * w[3 + k] + d_m02 * w[6 + k];
            dt[1][k] = d_m11 * w[3 + k] + d_m12 * w[6 + k];
            dt[2][k] = d_m22 * w[6 + k];
          }
          float ds6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          for (int r = 0; r < 3; ++r) {
            const float wr0 = w[3 * r], wr1 = w[3 * r + 1], wr2 = w[3 * r + 2];
            ds6[0] = ds6[0] + dt[r][0] * wr0;
            ds6[1] = ds6[1] + (dt[r][0] * wr1 + dt[r][1] * wr0);
            ds6[2] = ds6[2] + (dt[r][0] * wr2 + dt[r][2] * wr0);
            ds6[3] = ds6[3] + dt[r][1] * wr1;
            ds6[4] = ds6[4] + (dt[r][1] * wr2 + dt[r][2] * wr1);
            ds6[5] = ds6[5] + dt[r][2] * wr2;
          }
          for (int k = 0; k < 6; ++k) cov[k] = ds6[k];  // in place: this row has been read
        }

        if (d_means != nullptr) {
          // j00 = fx / z; j02 = ((-fx tx) / z) / z; the same in y
          float d_iz = d_j00 * cam.fx + d_j11 * cam.fy;
          d_iz = d_iz + d_j02 * e.q2x + (d_j02 * e.iz) * e.q1x;
          d_iz = d_iz + d_j12 * e.q2y + (d_j12 * e.iz) * e.q1y;
          const float d_tx = ((d_j02 * e.iz) * e.iz) * -cam.fx;
          const float d_ty = ((d_j12 * e.iz) * e.iz) * -cam.fy;
          // tx = clamp(x / z) z, where the clamp passes the gradient inside
          // its bounds, edges included
          float d_zs = d_tx * e.rxc + d_ty * e.ryc;
          const float d_rx = (e.rx >= -e.lim_x && e.rx <= e.lim_x) ? d_tx * e.zs : 0.0f;
          const float d_ry = (e.ry >= -e.lim_y && e.ry <= e.lim_y) ? d_ty * e.zs : 0.0f;
          float d_px = d_rx * e.iz, d_py = d_ry * e.iz;
          d_iz = d_iz + d_rx * e.px + d_ry * e.py;
          // u = fx x / z + cx, v alike
          d_px = d_px + (gu / e.zs) * cam.fx;
          d_py = d_py + (gv / e.zs) * cam.fy;
          d_zs = d_zs - gu * (e.fxpx / e.zs / e.zs) - gv * (e.fypy / e.zs / e.zs);
          // iz = 1 / z
          d_zs = d_zs - d_iz * (e.iz * e.iz);
          // z: the selection passes the gradient where |z| >= 1e-6
          const float d_pz = (fabsf(e.pz) < Z_EPS ? 0.0f : d_zs) + gz;
          // p = W m + t
          const float* w = cam.w;
          mean[0] = w[0] * d_px + w[3] * d_py + w[6] * d_pz;
          mean[1] = w[1] * d_px + w[4] * d_py + w[7] * d_pz;
          mean[2] = w[2] * d_px + w[5] * d_py + w[8] * d_pz;
        }
      }
    }
    __syncthreads();
    if (d_means != nullptr) stage_out<4>(d_means + n0 * 3, s_mean[buf], rows * 12);
    if (d_cov3d != nullptr) stage_out<4>(d_cov3d + n0 * 6, s_cov[buf], rows * 24);
    __syncthreads();  // the next pass's copies land in this tile's buffers
  }
  wait_group<0>();
}

// A persistent grid: as many blocks as fit on the card at once, at most one
// a tile (per kernel, counted once).
template <typename K>
int grid_for(K kernel, long long tiles, int& cached) {
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TILE, 0) != cudaSuccess ||
        per_sm <= 0)
      return 0;
    cached = sms * per_sm;
  }
  return (int)min((long long)cached, tiles);
}

}  // namespace

// The EWA projection of n splats (ops/projection.project_splats without the
// colour): means (n,3), cov3d (n,6), color (n,4) and, when p.size_culling,
// scales_log (n,3) f32; the camera's viewmat (4,4) and 0-d fx, fy, cx, cy,
// near, far f32 on the device. Writes xy (n,2), conic (n,3), depth (n,),
// radius (n,2), alpha (n,) f32 and valid (n,) bytes. Every pointer 16-byte
// aligned, every array contiguous. The scalars are passed one by one (not
// as the struct) so that any caller can bind them.
extern "C" int ewa_project_fwd(const float* means, const float* cov3d, const float* color,
                               const float* scales_log, const float* viewmat, const float* fx,
                               const float* fy, const float* cx, const float* cy,
                               const float* near, const float* far, int width, int height,
                               float dilation, float extent_sigma, float max_basis_px,
                               float clip, float alpha_min, float size_min_px,
                               float opacity_gain, float splat_scale, int ms_antialiasing,
                               int point_cloud_mode, int size_culling, long long n, float* xy,
                               float* conic, float* depth, float* radius, float* alpha,
                               uint8_t* valid, void* stream) {
  if (n <= 0) return 0;
  if (size_culling && scales_log == nullptr) return (int)cudaErrorInvalidValue;
  const float hw = static_cast<float>(0.5 * width), hh = static_cast<float>(0.5 * height);
  const EwaParams p{hw, hh, 1.0f / hw, 1.0f / hh, dilation, extent_sigma, max_basis_px, clip,
                    alpha_min, size_min_px, opacity_gain, splat_scale, ms_antialiasing,
                    point_cloud_mode, size_culling};
  static int cached = 0;
  const int grid = grid_for(ewa_project_fwd_kernel, (n + TILE - 1) / TILE, cached);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  ewa_project_fwd_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      means, cov3d, color, scales_log, viewmat, fx, fy, cx, cy, near, far, p, n, xy, conic,
      depth, radius, alpha, valid);
  return (int)cudaGetLastError();
}

// The backward of ewa_project_fwd for the cotangents d_xy (n,2), d_conic
// (n,3), d_depth (n,) and d_alpha (n,) f32, each null where absent (zero):
// d_means (n,3), d_cov3d (n,6) and d_color (n,4) f32 (columns 0-2 zero),
// each written only where its pointer is not null. The camera's near and far
// and the size cull take no part.
extern "C" int ewa_project_bwd(const float* means, const float* cov3d, const float* color,
                               const float* viewmat, const float* fx, const float* fy,
                               const float* cx, const float* cy, int width, int height,
                               float dilation, float opacity_gain, int ms_antialiasing,
                               const float* d_xy, const float* d_conic, const float* d_depth,
                               const float* d_alpha, long long n, float* d_means,
                               float* d_cov3d, float* d_color, void* stream) {
  if (n <= 0) return 0;
  const float hw = static_cast<float>(0.5 * width), hh = static_cast<float>(0.5 * height);
  const EwaParams p{hw, hh, 1.0f / hw, 1.0f / hh, dilation, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                    opacity_gain, 1.0f, ms_antialiasing, 0, 0};
  static int cached = 0;
  const int grid = grid_for(ewa_project_bwd_kernel, (n + TILE - 1) / TILE, cached);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  ewa_project_bwd_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      means, cov3d, color, viewmat, fx, fy, cx, cy, p, d_xy, d_conic, d_depth, d_alpha, n,
      d_means, d_cov3d, d_color);
  return (int)cudaGetLastError();
}
