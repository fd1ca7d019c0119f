// Pair-list tile blender, forward (gs2d response model).
//
// Replaces the Pallas kernel rasterize_pallas._make_fwd_kernel
// (vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:202) on the 3DGS raster
// frame. It computes what that kernel computes for gs2d; it does not copy
// its block structure (a sequential grid over a packed schedule, 128-lane
// DMA blocks, a log-shift transmittance scan), which exists for the TPU.
//
// Design: one thread block per 16x16 tile, one thread per pixel. The block
// walks its tile's [start, end) range of depth-sorted pairs in steps that
// end at the blend-chunk boundaries of the global pair index (p % chunk == 0)
// and at the tile's end. Each step's pair attributes are staged in shared
// memory as SoA rows (x, y, conic a/b/c, opacity, r, g, b, depth as f32,
// the splat id as int32), then every pixel blends them front to back:
//   d = ca*dx*dx + 2*cb*dx*dy + cc*dy*dy,  a = opacity * expf(-0.5 d),
//   a kept only if d <= qmax and a >= alpha_min, then min(a, alpha_clamp);
//   rgb += a*T*color;  T *= 1 - a;
//   depth and id are picked at the first pair with T < depth_iso and a > 0.
// A pixel freezes (contributes nothing more) when its T at the start of a
// step is <= min_transmittance, exactly the TPU kernel's per-step freeze,
// and the block stops once all 256 pixels are frozen (__syncthreads_or).
// Every tile is written, empty tiles as rgb 0, T 1, depth 0, id -1.
//
// What bounds it on the H100: per (pixel, pair) one expf and about a dozen
// f32 multiply-adds; the attribute reads are amortised over the tile's 256
// pixels through shared memory (broadcast reads, no bank conflicts). Built
// with exact expf, without fast math and with -fmad=false (ops/_build.py):
// the cutoffs above flip whole contributions, so d and a are rounded op for
// op as the plain PyTorch twin rounds them, and the two agree bit for bit on
// every alpha. wgmma and TMA are not used yet: making this kernel fast is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;   // threads per block, pixels per tile
constexpr int MAX_CHUNK = 256;     // largest blend step staged at once
constexpr int ROWS = 10;           // gs2d rows, ops/response.py
constexpr int OUT_ROWS = 5;        // rgb, T, depth

__global__ void __launch_bounds__(PIX)
rasterize_fwd_kernel(const float* __restrict__ attrs, long long pair_stride,
                     const int* __restrict__ ids,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     int tiles_x, int chunk, float alpha_min,
                     float alpha_clamp, float qmax, float min_transmittance,
                     float depth_iso, float* __restrict__ out,
                     int* __restrict__ out_id) {
  __shared__ float s_attr[ROWS][MAX_CHUNK];
  __shared__ int s_id[MAX_CHUNK];

  const int t = blockIdx.x;
  const int i = threadIdx.x;
  const float px = (float)((t % tiles_x) * TILE + i % TILE) + 0.5f;
  const float py = (float)((t / tiles_x) * TILE + i / TILE) + 0.5f;
  const int start = tile_start[t];
  const int end = start + tile_count[t];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, depth = 0.0f;
  int pick = -1;
  bool picked = false;

  for (int s = start; s < end;) {
    const int e = min(end, (s / chunk + 1) * chunk);  // next chunk boundary
    const int n = e - s;
    for (int j = i; j < n; j += PIX) {
      #pragma unroll
      for (int r = 0; r < ROWS; ++r) s_attr[r][j] = attrs[r * pair_stride + s + j];
      s_id[j] = ids[s + j];
    }
    __syncthreads();
    if (T > min_transmittance) {  // per-step freeze, rasterize_pallas.py:286
      for (int j = 0; j < n; ++j) {
        const float dx = px - s_attr[0][j];
        const float dy = py - s_attr[1][j];
        const float d = s_attr[2][j] * dx * dx + 2.0f * s_attr[3][j] * dx * dy +
                        s_attr[4][j] * dy * dy;
        float a = s_attr[5][j] * expf(-0.5f * d);
        if (!(d <= qmax && a >= alpha_min)) continue;  // alpha = 0
        a = fminf(a, alpha_clamp);
        const float w = a * T;
        cr += w * s_attr[6][j];
        cg += w * s_attr[7][j];
        cb += w * s_attr[8][j];
        T *= 1.0f - a;
        if (!picked && T < depth_iso) {
          picked = true;
          depth = s_attr[9][j];
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

}  // namespace

// Launches one block per tile on `stream`; returns cudaGetLastError().
extern "C" int rasterize_fwd(const float* attrs, long long pair_stride,
                             const int* ids, const int* tile_start,
                             const int* tile_count, int num_tiles, int tiles_x,
                             int chunk, float alpha_min, float alpha_clamp,
                             float qmax, float min_transmittance,
                             float depth_iso, float* out, int* out_id,
                             void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  if (num_tiles > 0) {
    rasterize_fwd_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_stride, ids, tile_start, tile_count, tiles_x, chunk,
        alpha_min, alpha_clamp, qmax, min_transmittance, depth_iso, out,
        out_id);
  }
  return (int)cudaGetLastError();
}
