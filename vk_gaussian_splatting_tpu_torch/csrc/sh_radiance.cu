// The splats' SH radiance, forward and backward: the SH branch of
// ops/projection.splat_rgb (ops/sh.sh_radiance) as two kernels.
//
// Replaces no TPU kernel. The JAX package computes this pass in jnp
// (vk_gaussian_splatting_tpu/ops/sh.py), and the port first composed it of
// PyTorch calls: a 15-column stack of the basis, an (N, 15, 3) product and
// a band sum, about a dozen launches whose intermediates went through
// device memory several times (9.7 ms of a 6.13M-splat frame on an H100).
// These kernels were added for speed; the plain composition stays in
// ops/sh.py as the CPU path and the yardstick on the card
// (sh_radiance_ref, and sh_radiance_bwd_ref for the backward).
//
// Per splat, the forward reads the SH row (M stored coefficients x 3, in
// f32, f16 or u8), the mean and the RGBA colour row and the camera
// position, and writes rgb:
//   d = normalize(mean - position), the norm clamped at 1e-12;
//   rad = sum over m ascending of basis_m(d) * coeff[m] (the degree-1..3
//         basis of ops/sh.sh_basis, column formula for column formula);
//   rgb = max(colour.rgb + rad, 0), or max(0.5 + rad, 0) under
//         show_sh_only (SH_ONLY).
// The backward recomputes d, the basis, rad and the clamp's mask from the
// same inputs (nothing of the forward is saved) and writes, each only
// where a gradient is asked for: d_sh[m][c] = basis_m * g[c], with g the
// cotangent masked where colour + rad < 0 as torch.clamp's backward masks;
// d_colour = (g, 0); d_mean through the basis' derivatives and the
// normalisation. The arithmetic is f32, built with -fmad=false, every
// operation in sh_basis' order; the contraction sums over m in ascending
// order, which the plain version's reduction on the card may not do (its
// 15-term sums may differ in the last bits). Only the m < M(degree)
// coefficients are read when the requested degree is below the stored one;
// d_sh is written whole, zero beyond M.
//
// Bound: bytes. At SH 3 in f32 the forward moves 180 B of SH, 12 of mean,
// 16 of colour and 12 of rgb a splat: 220 B, 1.349 GB at 6.13M splats, a
// bound of 0.403 ms at 3.35 TB/s (0.066 ms at 1M). The backward reads
// the same inputs and d_rgb (220 B) and writes d_sh (180), d_mean (12) and
// d_colour (16): 428 B, 2.624 GB at 6.13M, 0.783 ms (0.128 ms at 1M).
// The arithmetic, about 200 f32 operations a splat, is far below either.
//
// Design: one block of TILE = 128 threads per 128 consecutive splats, one
// thread a splat. A thread's SH row is 180 contiguous bytes (f32, SH 3), so
// a warp reading one coefficient of each of its 32 rows would touch 32
// sectors 180 B apart and use 4 B of each 32-B sector. Instead the block
// copies its 128 rows, which are contiguous in device memory (23,040 B at
// SH 3 f32; 128 rows are a multiple of 16 B in every format), into shared
// memory with 16-byte cp.async copies on neighbouring addresses (the means,
// 1,536 B, the same way), so that every sector is fetched whole once; all
// of a thread's copies are in flight before it waits. Each thread then
// evaluates its splat from shared memory (row strides of 45 words at SH 3
// f32: no bank conflicts). The RGBA rows are 16 B, so a thread loads its
// own with one float4 load, and the warp's loads are already contiguous.
// Outputs go back through shared memory (rgb, d_mean, and d_sh in place of
// the coefficients) and leave as coalesced 16-byte stores. About 26 KB of
// shared memory a block leaves room for 8 blocks an SM, 190 KB of copies in
// flight. The last tile copies its ragged end a byte at a time.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "stage.cuh"

namespace {

constexpr int TILE = 128;
constexpr float NORM_EPS = 1e-12f;

// the constants of ops/sh.py, rounded to f32 as PyTorch rounds a Python
// float that multiplies an f32 tensor
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484f, C2_1 = -1.0925484f, C2_2 = 0.3153916f, C2_3 = -1.0925484f,
                C2_4 = 0.5462742f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

// The tile's first M coefficients of each of `rows` stored rows of
// `stored` coefficients, packed M to a row: the whole rows when M is all
// that is stored, else element by element (coalesced along each row).
template <typename T, int M>
__device__ __forceinline__ void stage_coeffs(T* dst, const T* src, int rows, int stored) {
  if (stored == M) {
    stage_in<1>(dst, src, rows * M * 3 * (int)sizeof(T));
    return;
  }
  for (int e = threadIdx.x; e < rows * M * 3; e += blockDim.x) {
    const int r = e / (M * 3), k = e - r * (M * 3);
    dst[e] = src[(size_t)r * stored * 3 + k];
  }
}

// dequantize_sh
__device__ __forceinline__ float coef(float v) { return v; }
__device__ __forceinline__ float coef(__half v) { return __half2float(v); }
__device__ __forceinline__ float coef(uint8_t v) { return (float)v / 255.0f * 2.0f - 1.0f; }

// d = (mean - position) / max(|mean - position|, 1e-12); n is the
// unclamped norm, nc the clamped one
__device__ __forceinline__ void view_dir(const float* mean, const float* pos, float& x, float& y,
                                         float& z, float& n, float& nc) {
  const float vx = mean[0] - pos[0], vy = mean[1] - pos[1], vz = mean[2] - pos[2];
  n = sqrtf(vx * vx + vy * vy + vz * vz);
  nc = n < NORM_EPS ? NORM_EPS : n;  // NaN stays NaN, as clamp_min keeps it
  x = vx / nc;
  y = vy / nc;
  z = vz / nc;
}

// ops/sh.sh_basis, column for column
template <int M>
__device__ __forceinline__ void basis(float x, float y, float z, float* b) {
  b[0] = -C1 * y;
  b[1] = C1 * z;
  b[2] = -C1 * x;
  if (M >= 8) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[3] = C2_0 * xy;
    b[4] = C2_1 * yz;
    b[5] = C2_2 * (2.0f * zz - xx - yy);
    b[6] = C2_3 * xz;
    b[7] = C2_4 * (xx - yy);
  }
  if (M >= 15) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[8] = C3_0 * (3.0f * xx - yy) * y;
    b[9] = C3_1 * x * y * z;
    b[10] = C3_2 * (4.0f * zz - xx - yy) * y;
    b[11] = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
    b[12] = C3_4 * x * (4.0f * zz - xx - yy);
    b[13] = C3_5 * (xx - yy) * z;
    b[14] = C3_6 * x * (xx - 3.0f * yy);
  }
}

// d_dir += sum over m ascending of d_b[m] * d basis_m / d(x, y, z), each
// partial as ops/sh.sh_basis_vjp writes it (zero partials skipped)
template <int M>
__device__ __forceinline__ void basis_vjp(float x, float y, float z, const float* db, float& dx,
                                          float& dy, float& dz) {
  dx = 0.0f;
  dy = 0.0f;
  dz = 0.0f;
  dy = dy + db[0] * -C1;
  dz = dz + db[1] * C1;
  dx = dx + db[2] * -C1;
  if (M >= 8) {
    dx = dx + db[3] * (C2_0 * y);
    dy = dy + db[3] * (C2_0 * x);
    dy = dy + db[4] * (C2_1 * z);
    dz = dz + db[4] * (C2_1 * y);
    dx = dx + db[5] * (C2_2 * (-2.0f * x));
    dy = dy + db[5] * (C2_2 * (-2.0f * y));
    dz = dz + db[5] * (C2_2 * (4.0f * z));
    dx = dx + db[6] * (C2_3 * z);
    dz = dz + db[6] * (C2_3 * x);
    dx = dx + db[7] * (C2_4 * (2.0f * x));
    dy = dy + db[7] * (C2_4 * (-2.0f * y));
  }
  if (M >= 15) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    dx = dx + db[8] * (C3_0 * (6.0f * xy));
    dy = dy + db[8] * (C3_0 * (3.0f * xx - 3.0f * yy));
    dx = dx + db[9] * (C3_1 * yz);
    dy = dy + db[9] * (C3_1 * xz);
    dz = dz + db[9] * (C3_1 * xy);
    dx = dx + db[10] * (C3_2 * (-2.0f * xy));
    dy = dy + db[10] * (C3_2 * (4.0f * zz - xx - 3.0f * yy));
    dz = dz + db[10] * (C3_2 * (8.0f * yz));
    dx = dx + db[11] * (C3_3 * (-6.0f * xz));
    dy = dy + db[11] * (C3_3 * (-6.0f * yz));
    dz = dz + db[11] * (C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy));
    dx = dx + db[12] * (C3_4 * (4.0f * zz - 3.0f * xx - yy));
    dy = dy + db[12] * (C3_4 * (-2.0f * xy));
    dz = dz + db[12] * (C3_4 * (8.0f * xz));
    dx = dx + db[13] * (C3_5 * (2.0f * xz));
    dy = dy + db[13] * (C3_5 * (-2.0f * yz));
    dz = dz + db[13] * (C3_5 * (xx - yy));
    dx = dx + db[14] * (C3_6 * (3.0f * xx - 3.0f * yy));
    dy = dy + db[14] * (C3_6 * (-6.0f * xy));
  }
}

// the pre-clamp colour of one splat: base + sum_m b[m] * c[m] (m ascending)
template <typename T, int M, bool SH_ONLY>
__device__ __forceinline__ void pre_clamp(const T* row, const float* b, const float* color,
                                          float* pre) {
  float rad[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 3; ++c) rad[c] = rad[c] + b[m] * coef(row[m * 3 + c]);
#pragma unroll
  for (int c = 0; c < 3; ++c) pre[c] = (SH_ONLY ? 0.5f : color[c]) + rad[c];
}

template <typename T, int M, bool SH_ONLY>
__global__ void __launch_bounds__(TILE)
    sh_radiance_fwd_kernel(const T* __restrict__ sh, int stored, const float* __restrict__ means,
                           const float* __restrict__ color, const float* __restrict__ pos,
                           long long n, float* __restrict__ rgb) {
  __shared__ __align__(16) unsigned char s_raw[TILE * M * 3 * sizeof(T)];
  __shared__ __align__(16) float s_vec[TILE * 3];  // means in, rgb out
  T* s_sh = reinterpret_cast<T*>(s_raw);
  const long long n0 = (long long)blockIdx.x * TILE;
  const int rows = (int)min((long long)TILE, n - n0);
  stage_coeffs<T, M>(s_sh, sh + n0 * stored * 3, rows, stored);
  stage_in<1>(s_vec, means + n0 * 3, rows * 3 * (int)sizeof(float));
  const int i = threadIdx.x;
  float4 col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!SH_ONLY && i < rows) col = reinterpret_cast<const float4*>(color)[n0 + i];
  commit();
  landed<0>();
  if (i < rows) {
    float x, y, z, nrm, nc, b[M], pre[3];
    view_dir(&s_vec[3 * i], pos, x, y, z, nrm, nc);
    basis<M>(x, y, z, b);
    const float base[3] = {col.x, col.y, col.z};
    pre_clamp<T, M, SH_ONLY>(&s_sh[i * M * 3], b, base, pre);
#pragma unroll
    for (int c = 0; c < 3; ++c) s_vec[3 * i + c] = pre[c] < 0.0f ? 0.0f : pre[c];
  }
  __syncthreads();
  stage_out<1>(rgb + n0 * 3, s_vec, rows * 3 * (int)sizeof(float));
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same<T, __half>::value)
    return __float2half_rn(v);
  else
    return (T)v;
}

template <typename T, int M, bool SH_ONLY>
__global__ void __launch_bounds__(TILE)
    sh_radiance_bwd_kernel(const T* __restrict__ sh, int stored, const float* __restrict__ means,
                           const float* __restrict__ color, const float* __restrict__ pos,
                           const float* __restrict__ d_rgb, long long n, T* __restrict__ d_sh,
                           float* __restrict__ d_means, float* __restrict__ d_color) {
  __shared__ __align__(16) unsigned char s_raw[TILE * M * 3 * sizeof(T)];  // coefficients in, d_sh out
  T* s_sh = reinterpret_cast<T*>(s_raw);
  __shared__ __align__(16) float s_vec[TILE * 3];  // means in, d_means out
  __shared__ __align__(16) float s_g[TILE * 3];    // the cotangent
  const long long n0 = (long long)blockIdx.x * TILE;
  const int rows = (int)min((long long)TILE, n - n0);
  stage_coeffs<T, M>(s_sh, sh + n0 * stored * 3, rows, stored);
  stage_in<1>(s_vec, means + n0 * 3, rows * 3 * (int)sizeof(float));
  stage_in<1>(s_g, d_rgb + n0 * 3, rows * 3 * (int)sizeof(float));
  const int i = threadIdx.x;
  float4 col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!SH_ONLY && i < rows) col = reinterpret_cast<const float4*>(color)[n0 + i];
  commit();
  landed<0>();
  if (i < rows) {
    float x, y, z, nrm, nc, b[M], pre[3], g[3], db[M];
    view_dir(&s_vec[3 * i], pos, x, y, z, nrm, nc);
    basis<M>(x, y, z, b);
    const float base[3] = {col.x, col.y, col.z};
    T* row = &s_sh[i * M * 3];
    pre_clamp<T, M, SH_ONLY>(row, b, base, pre);
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] = pre[c] >= 0.0f ? s_g[3 * i + c] : 0.0f;
    if (!SH_ONLY && d_color != nullptr)
      reinterpret_cast<float4*>(d_color)[n0 + i] = make_float4(g[0], g[1], g[2], 0.0f);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      db[m] = coef(row[m * 3]) * g[0] + coef(row[m * 3 + 1]) * g[1] + coef(row[m * 3 + 2]) * g[2];
      if constexpr (!std::is_same<T, uint8_t>::value) {
        if (d_sh != nullptr) {  // in place: this thread's row has been read
          for (int c = 0; c < 3; ++c) row[m * 3 + c] = from_float<T>(b[m] * g[c]);
        }
      }
    }
    if (d_means != nullptr) {
      float dx, dy, dz;
      basis_vjp<M>(x, y, z, db, dx, dy, dz);
      if (nrm >= NORM_EPS) {  // through the norm as well; below it the clamp holds it
        const float s = x * dx + y * dy + z * dz;
        dx = dx - x * s;
        dy = dy - y * s;
        dz = dz - z * s;
      }
      s_vec[3 * i] = dx / nc;
      s_vec[3 * i + 1] = dy / nc;
      s_vec[3 * i + 2] = dz / nc;
    }
  }
  __syncthreads();
  if (d_means != nullptr) stage_out<1>(d_means + n0 * 3, s_vec, rows * 3 * (int)sizeof(float));
  if constexpr (!std::is_same<T, uint8_t>::value) {
    if (d_sh != nullptr) {
      T* out = d_sh + n0 * stored * 3;
      if (stored == M) {
        stage_out<1>(out, s_sh, rows * M * 3 * (int)sizeof(T));
      } else {  // zero beyond the M coefficients read
        for (int e = threadIdx.x; e < rows * stored * 3; e += blockDim.x) {
          const int r = e / (stored * 3), k = e - r * (stored * 3);
          out[e] = k < M * 3 ? s_sh[r * M * 3 + k] : from_float<T>(0.0f);
        }
      }
    }
  }
}

template <typename T, int M, bool SH_ONLY>
int launch_fwd(const void* sh, int stored, const float* means, const float* color,
               const float* pos, long long n, float* rgb, cudaStream_t stream) {
  const long long blocks = (n + TILE - 1) / TILE;
  sh_radiance_fwd_kernel<T, M, SH_ONLY><<<(unsigned)blocks, TILE, 0, stream>>>(
      static_cast<const T*>(sh), stored, means, color, pos, n, rgb);
  return (int)cudaGetLastError();
}

template <typename T, int M, bool SH_ONLY>
int launch_bwd(const void* sh, int stored, const float* means, const float* color,
               const float* pos, const float* d_rgb, long long n, void* d_sh, float* d_means,
               float* d_color, cudaStream_t stream) {
  const long long blocks = (n + TILE - 1) / TILE;
  sh_radiance_bwd_kernel<T, M, SH_ONLY><<<(unsigned)blocks, TILE, 0, stream>>>(
      static_cast<const T*>(sh), stored, means, color, pos, d_rgb, n, static_cast<T*>(d_sh),
      d_means, d_color);
  return (int)cudaGetLastError();
}

// The instantiation for (format, M, show_sh_only): format 0 f32, 1 f16, 2 u8.
template <template <typename, int, bool> class Launch, typename... A>
int dispatch(int fmt, int m, int sh_only, A... args) {
  if (m != 3 && m != 8 && m != 15) return (int)cudaErrorInvalidValue;
#define SH_CASE(T, MM)                                                      \
  if (m == MM)                                                              \
    return sh_only ? Launch<T, MM, true>::run(args...) : Launch<T, MM, false>::run(args...);
  if (fmt == 0) {
    SH_CASE(float, 3) SH_CASE(float, 8) SH_CASE(float, 15)
  } else if (fmt == 1) {
    SH_CASE(__half, 3) SH_CASE(__half, 8) SH_CASE(__half, 15)
  } else if (fmt == 2) {
    SH_CASE(uint8_t, 3) SH_CASE(uint8_t, 8) SH_CASE(uint8_t, 15)
  }
#undef SH_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int M, bool SH_ONLY>
struct Fwd {
  template <typename... A>
  static int run(A... args) { return launch_fwd<T, M, SH_ONLY>(args...); }
};

template <typename T, int M, bool SH_ONLY>
struct Bwd {
  template <typename... A>
  static int run(A... args) { return launch_bwd<T, M, SH_ONLY>(args...); }
};

}  // namespace

// rgb (n, 3) f32 from sh (n, stored, 3) in format `fmt`, the first m
// coefficients of each row read; means (n, 3), color (n, 4), pos (3,) f32.
// Every pointer 16-byte aligned, every array contiguous.
extern "C" int sh_radiance_fwd(const void* sh, int fmt, int stored, int m, const float* means,
                               const float* color, const float* pos, long long n,
                               int show_sh_only, float* rgb, void* stream) {
  if (n <= 0) return 0;
  if (stored < m) return (int)cudaErrorInvalidValue;
  return dispatch<Fwd>(fmt, m, show_sh_only, sh, stored, means, color, pos, n, rgb,
                       static_cast<cudaStream_t>(stream));
}

// The backward of sh_radiance_fwd for the cotangent d_rgb (n, 3) f32:
// d_sh (n, stored, 3) in the format of sh (not for u8), d_means (n, 3),
// d_color (n, 4) f32, each written only where its pointer is not null
// (d_color is never written under show_sh_only).
extern "C" int sh_radiance_bwd(const void* sh, int fmt, int stored, int m, const float* means,
                               const float* color, const float* pos, const float* d_rgb,
                               long long n, int show_sh_only, void* d_sh, float* d_means,
                               float* d_color, void* stream) {
  if (n <= 0) return 0;
  if (stored < m || (fmt == 2 && d_sh != nullptr)) return (int)cudaErrorInvalidValue;
  return dispatch<Bwd>(fmt, m, show_sh_only, sh, stored, means, color, pos, d_rgb, n, d_sh,
                       d_means, d_color, static_cast<cudaStream_t>(stream));
}
