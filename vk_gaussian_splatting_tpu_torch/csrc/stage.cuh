// Shared-memory staging of the bandwidth kernels (sh_radiance.cu,
// ewa_project.cu): a block copies a tile's contiguous rows between device
// and shared memory in 16-byte pieces on neighbouring addresses, so that
// every sector is fetched or written whole once.
//
// TAIL is the width in bytes of the last bytes % 16: 1 where a row can end
// on any byte (the SH rows in f16 and u8), copied a byte at a time; 4 where
// every row is whole words, copied a word at a time (by cp.async 4 into
// shared memory).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// All threads of the block start copying `bytes` contiguous bytes (a
// multiple of TAIL) from device memory (16-byte aligned) into shared memory
// (16-byte aligned): 16-byte async copies, then the tail. The caller
// commits and waits (commit, landed).
template <int TAIL>
__device__ __forceinline__ void stage_in(void* dst, const void* src, int bytes) {
  static_assert(TAIL == 1 || TAIL == 4, "a tail of bytes or of words");
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const int chunks = bytes >> 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(d + 16 * c)),
                 "l"(s + 16 * c)
                 : "memory");
  for (int b = (chunks << 4) + TAIL * threadIdx.x; b < bytes; b += TAIL * blockDim.x) {
    if constexpr (TAIL == 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(d + b)), "l"(s + b)
                   : "memory");
    else
      d[b] = s[b];
  }
}

// shared -> device memory, 16-byte stores on neighbouring addresses, then
// the tail
template <int TAIL>
__device__ __forceinline__ void stage_out(void* dst, const void* src, int bytes) {
  static_assert(TAIL == 1 || TAIL == 4, "a tail of bytes or of words");
  using Word = typename std::conditional<TAIL == 4, uint32_t, unsigned char>::type;
  constexpr int SHIFT = TAIL == 4 ? 2 : 0;
  Word* d = static_cast<Word*>(dst);
  const Word* s = static_cast<const Word*>(src);
  const int chunks = bytes >> 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    reinterpret_cast<uint4*>(d)[c] = reinterpret_cast<const uint4*>(s)[c];
  for (int w = (chunks << (4 - SHIFT)) + threadIdx.x; w < (bytes >> SHIFT); w += blockDim.x)
    d[w] = s[w];
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// waits until all but the last N of this thread's committed groups have
// landed
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// waits until all but the last N of this thread's committed groups have
// landed, then for the whole block
template <int N>
__device__ __forceinline__ void landed() {
  wait_group<N>();
  __syncthreads();
}
