// Bitonic sort of (rows, c) tiles in shared memory, repeated: the probe P1.
//
// Replaces the Pallas kernel `kernel` of scripts/bench_roll.py:32 (called
// at :52), which loads one (R, C) f32 buffer into VMEM, sorts it by row 0
// with the full bitonic network of C (every column moves with its key;
// partners by pltpu.roll) once per grid step for REPS = 200 steps, and
// writes it back. Here one block takes one tile of a (T, rows, c) batch:
// it loads the tile into dynamic shared memory once, runs the full
// schedule of c `reps` times (csrc/bitonic.cuh, want_min by index math),
// and writes the tile back. T = 1 and reps = 200 computes what the Pallas
// kernel computes; T = 8160 and reps = 1 is the 1080p frame's tile count,
// which the JAX script only projects from one buffer.
//
// What bounds it on the H100: at T = 8160 the bytes (each tile read and
// written once, 2 x 128 KB at rows 16, c 2048) against the f32 operations
// of the network (about 10 mask and compare operations per column and
// stage, plus one select per row); at T = 1 a single SM, so neither: the
// latency of shared memory and of the block's barriers. One block holds a
// whole tile (128 KB at the defaults, so one block per SM), one thread a
// pair of columns; a stage is one pass over shared memory and one barrier.

#include <cuda_runtime.h>

#include "bitonic.cuh"
#include "smem.cuh"

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
bench_roll_kernel(const float* __restrict__ x, int rows, int c, int half_shift, int reps,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float tile[];
  const size_t n = (size_t)rows * c;
  bitonic::copy_block(tile, x + blockIdx.x * n, (int)n);
  __syncthreads();
  for (int rep = 0; rep < reps; ++rep)
    for (int k = 2; k <= c; k <<= 1)
      for (int j = k >> 1; j >= 1; j >>= 1) {
        bitonic::stage<bitonic::kIota>(tile, 1, rows, c, half_shift, 0, k, j, nullptr);
        __syncthreads();
      }
  bitonic::copy_block(out + blockIdx.x * n, tile, (int)n);
}

}  // namespace

// The most dynamic shared memory one block may take on the current device.
extern "C" int bench_roll_smem_limit() {
  return dynamic_smem_limit((const void*)bench_roll_kernel);
}

// Sort each of `tiles` (rows, c) tiles of x by row 0, `reps` times, into
// out, on `stream`; c a power of two >= 2. Returns cudaGetLastError().
extern "C" int bench_roll(const float* x, int tiles, int rows, int c, int reps, float* out,
                          void* stream) {
  if (c < 2 || (c & (c - 1)) != 0 || rows < 1 || tiles < 0 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = rows * c * (int)sizeof(float);
  if (smem > bench_roll_smem_limit()) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bench_roll_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int half_shift = 0;
  while ((2 << half_shift) < c) ++half_shift;
  const int threads = c / 2 < THREADS ? (c / 2 + 31) / 32 * 32 : THREADS;
  if (tiles > 0)
    bench_roll_kernel<<<tiles, threads, smem, (cudaStream_t)stream>>>(x, rows, c, half_shift,
                                                                      reps, out);
  return (int)cudaGetLastError();
}
