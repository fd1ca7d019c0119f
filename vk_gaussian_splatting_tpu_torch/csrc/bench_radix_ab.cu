// Pipelined bulk copies of runs of (16, 128) f32 blocks from device memory
// into shared memory: the probe P2.
//
// Replaces the Pallas kernel `_dma_kernel` of scripts/bench_radix_ab.py:89
// (built by `dma_bench_call`, :116), which measures the cost of one DMA of
// W blocks (W x 8 KB): each grid step starts n_copies copies from the
// (2048, 16, 128) source at block offsets (j * n_copies + i) % 1024 into an
// 8-deep VMEM ring (copy i into slot i % 8), keeps 8 in flight by waiting
// on copy i - 7's semaphore after starting copy i, drains, and writes the
// block in ring slot 0 to the output. On Hopper the counterpart of
// pltpu.make_async_copy and its DMA semaphores is the bulk asynchronous
// copy (cp.async.bulk, global -> shared) that one thread issues, its
// completion counted in bytes on an mbarrier in shared memory.
//
// An 8-deep ring of W x 8 KB is 256 KB at W = 4 and 4 MB at W = 64; a block
// has at most 227 KB. So each copy goes out as pieces of at most
// `piece_blocks` blocks (the caller's choice: 3, 24 KB, keeps the 8-slot
// ring at 192 KB), and the ring keeps 8 pieces in flight: before piece q
// starts in slot q % 8, piece q - 8 of that slot is waited for. The output keeps the JAX kernel's meaning, the first
// block of the last copy that went to ring slot 0 in the last step: it is
// stored out by a bulk copy (shared -> global) as soon as its piece lands.
// With `trace` given, every piece is stored out the same way to
// trace[step][copy][block], for a check of every copied block.
//
// One block runs `steps_per_block` consecutive grid steps: all n_steps in
// one block measure one copy engine as the JAX script does (its grid runs
// in order on one core); one step per block runs them across the card.
//
// What bounds it on the H100: the offsets cycle over the first 8 MB of the
// 16 MB source, which the 50 MB L2 holds after the first pass, so only
// those 8 MB must come from device memory; every copied byte must land in
// shared memory, at 128 B per clock on each SM. Across the card that fill
// is the bound; a single block is bound by the latency of its 8 pieces in
// flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"
#include "tma.cuh"

namespace {

constexpr int BLOCK_BYTES = 16 * 128 * 4;   // one (16, 128) f32 block
constexpr int RING = 8;
constexpr int OFFSET_CYCLE = 1024;          // copy offsets cycle over this many blocks

__global__ void __launch_bounds__(1)
dma_probe_kernel(const unsigned char* __restrict__ src, int n_steps, int steps_per_block,
                 int n_copies, int w, int piece_blocks, unsigned char* __restrict__ out,
                 unsigned char* __restrict__ trace) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[RING];
  for (int s = 0; s < RING; ++s) mbar_init(&bars[s]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

  const int n_pieces = (w + piece_blocks - 1) / piece_blocks;
  const int per_step = n_copies * n_pieces;
  const int copy_out = (n_copies - 1) / RING * RING;   // the last copy into ring slot 0
  const size_t slot_bytes = (size_t)piece_blocks * BLOCK_BYTES;
  uint32_t phases = 0;                                  // bit s: parity slot s waits for

  for (int js = 0; js < steps_per_block; ++js) {
    const int step = blockIdx.x * steps_per_block + js;
    if (step >= n_steps) break;
    // piece q of this step lands in slot q % RING; wait for it, then store
    // it out where the output or the trace asks for it
    auto land = [&](int q) {
      const int slot = q % RING;
      mbar_wait(&bars[slot], (phases >> slot) & 1u);
      phases ^= 1u << slot;
      const int i = q / n_pieces, p = q % n_pieces;
      const unsigned char* piece = ring + slot * slot_bytes;
      if (trace != nullptr) {
        const int nb = min(piece_blocks, w - p * piece_blocks);
        bulk_store(trace + (((size_t)step * n_copies + i) * w + (size_t)p * piece_blocks) *
                               BLOCK_BYTES,
                   piece, (uint32_t)nb * BLOCK_BYTES);
      }
      if (step == n_steps - 1 && i == copy_out && p == 0) bulk_store(out, piece, BLOCK_BYTES);
    };
    for (int q = 0; q < per_step; ++q) {
      const int slot = q % RING;
      if (q >= RING) land(q - RING);
      const int i = q / n_pieces, p = q % n_pieces;
      const long long off = ((long long)step * n_copies + i) % OFFSET_CYCLE;
      const int nb = min(piece_blocks, w - p * piece_blocks);
      const uint32_t bytes = (uint32_t)nb * BLOCK_BYTES;
      mbar_expect_tx(&bars[slot], bytes);
      bulk_load(ring + slot * slot_bytes,
                src + ((size_t)off + (size_t)p * piece_blocks) * BLOCK_BYTES, bytes, &bars[slot]);
    }
    for (int q = per_step > RING ? per_step - RING : 0; q < per_step; ++q) land(q);
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// n_steps steps of n_copies copies of w blocks from src (at least
// min(n_steps * n_copies, 1024) - 1 + w blocks of 8 KB), in pieces of
// piece_blocks blocks (1..w; the ring takes 8 of them in shared memory),
// `steps_per_block` steps to a block, on `stream`. out: one block; trace:
// null, or (n_steps, n_copies, w) blocks. A ring that does not fit the
// card's shared memory is refused. Returns cudaGetLastError().
extern "C" int bench_radix_ab(const void* src, int n_steps, int steps_per_block, int n_copies,
                              int w, int piece_blocks, void* out, void* trace, void* stream) {
  if (n_steps < 1 || steps_per_block < 1 || n_copies < 1 || w < 1 || piece_blocks < 1 ||
      piece_blocks > w)
    return (int)cudaErrorInvalidValue;
  const int smem = RING * piece_blocks * BLOCK_BYTES;
  if (smem > dynamic_smem_limit((const void*)dma_probe_kernel)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dma_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_steps + steps_per_block - 1) / steps_per_block;
  dma_probe_kernel<<<blocks, 1, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)src, n_steps, steps_per_block, n_copies, w, piece_blocks,
      (unsigned char*)out, (unsigned char*)trace);
  return (int)cudaGetLastError();
}
