// Pipelined bulk copies of runs of (16, 128) f32 blocks into shared memory:
// the probe P2.
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
// The ring: `depth` slots, each with a full and an empty mbarrier, and two
// warps. Producer lanes keep it full: a lane waits only on a slot's empty
// barrier, arms its full barrier with the piece's bytes and issues the
// bulk copy, across the block's steps without draining between them.
// Consumer lanes of the second warp wait on the full barriers, issue the
// stores (the output and, with `trace`, every piece to
// trace[step][copy][block]), wait until a store has read its slot, and
// arrive on empty. So the producer never waits on a store, nor on the
// oldest piece while a later slot is free. Across the card one lane of
// each warp does this, at BLOCKS_PER_SM blocks an SM; a launch of one
// block has the SM to itself and a deeper ring, and there up to
// ONE_BLOCK_LANES lanes of each warp issue and consume at once (one lane
// issues a copy only every 100-200 ns) and spin on the barriers instead
// of letting the hardware suspend them (PERF.md, §6, P2). The lanes divide
// the slots, so one producer lane and one consumer lane own each slot.
// A copy of W blocks goes out in the fewest pieces of at most
// `piece_blocks` blocks, their sizes differing by at most one block;
// probes/bench_radix_ab.py `ring_of` makes the same plan and passes the
// piece size. The output keeps the JAX kernel's meaning, the first block of
// the last copy that the script's ring put in its slot 0 in the last step.
//
// One block runs `steps_per_block` consecutive grid steps: all n_steps in
// one block measure one copy engine as the JAX script does (its grid runs
// in order on one core); one step per block runs them across the card,
// all 256 steps of the probe resident at once at two blocks an SM.
//
// What bounds it on the H100: the offsets cycle over the first 8 MB of the
// 16 MB source, which the 50 MB L2 holds after the first pass, so only
// those 8 MB must come from device memory; every copied byte must land in
// shared memory, at 128 B per clock on each SM. What L2 delivers into
// shared memory across the card is well below that (PERF.md, §6, the P2
// row's measured ceiling); a single block is bound by how fast
// its lanes issue and by what one SM takes in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"
#include "tma.cuh"

namespace {

constexpr int BLOCK_BYTES = 16 * 128 * 4;   // one (16, 128) f32 block
constexpr int SCRIPT_RING = 8;              // the script's ring: the output is its slot 0
constexpr int OFFSET_CYCLE = 1024;          // copy offsets cycle over this many blocks
constexpr int MAX_SLOTS = 28;               // most slots of a launch of one block
constexpr int CARD_DEPTH = 4;               // slots a block of a launch of more than one
constexpr int BLOCKS_PER_SM = 2;            // blocks an SM of a launch of more than one
constexpr int SM_SHARED = 233472;           // an SM's shared memory, 228 KB
constexpr int BLOCK_RESERVED = 1024;        // shared memory the system keeps per block
constexpr int BARRIER_BYTES = 2 * MAX_SLOTS * 8;
constexpr int ONE_BLOCK_LANES = 16;         // most lanes a warp of a launch of one block
constexpr int THREADS = 64;                 // warp 0 produces, warp 1 consumes

// the ring bytes a block may take when `per_sm` blocks share an SM
constexpr int ring_budget(int per_sm) {
  return SM_SHARED / per_sm - BLOCK_RESERVED - BARRIER_BYTES;
}

// copy i of global step `step` goes out as `pieces` pieces: piece p starts
// at block p * base + min(p, rem) and holds base + (p < rem) blocks
struct Pieces {
  int pieces, base, rem;
  __device__ int start(int p) const { return p * base + min(p, rem); }
  __device__ int blocks(int p) const { return base + (p < rem ? 1 : 0); }
};

// Waits for the phase of `parity`. A block alone on its SM spins on the
// barrier and reacts sooner; blocks that share an SM let the thread be
// suspended, so that spinning takes no issue slots from their neighbours.
__device__ __forceinline__ void await_phase(uint64_t* bar, uint32_t parity, bool spin) {
  if (spin) {
    while (!mbar_test(bar, parity)) {
    }
  } else {
    mbar_wait(bar, parity);
  }
}

// Calls f(js, i, p, slot, round) for the pieces lane, lane + lanes, ... of
// a block's `steps` steps of n_copies copies: piece k is piece k % pieces of
// copy k / pieces, and goes to slot k % depth in round k / depth (lanes <=
// depth). The producer lanes and the consumer lanes walk the same pieces.
template <class F>
__device__ __forceinline__ void walk(int lane, int lanes, int steps, int n_copies, int pieces,
                                     int depth, F f) {
  int js = 0, i = 0, p = lane, slot = lane;
  uint32_t round = 0;
  auto advance = [&]() {
    for (; p >= pieces; p -= pieces)
      if (++i == n_copies) {
        i = 0;
        ++js;
      }
  };
  for (advance(); js < steps; advance()) {
    f(js, i, p, slot, round);
    p += lanes;
    if ((slot += lanes) >= depth) {
      slot -= depth;
      ++round;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
dma_probe_kernel(const unsigned char* __restrict__ src, int n_steps, int steps_per_block,
                 int n_copies, int w, int piece_blocks, int depth, int lanes,
                 unsigned char* __restrict__ out, unsigned char* __restrict__ trace) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS];
  __shared__ __align__(8) uint64_t empty[MAX_SLOTS];
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(&full[s]);
      mbar_init(&empty[s]);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n = (w + piece_blocks - 1) / piece_blocks;
  const Pieces pc{n, w / n, w % n};
  const size_t slot_bytes = (size_t)piece_blocks * BLOCK_BYTES;
  const int step0 = blockIdx.x * steps_per_block;
  const int steps = min(steps_per_block, n_steps - step0);
  const int lane = threadIdx.x % 32;
  if (lane >= lanes) return;
  const bool spin = gridDim.x == 1;

  if (threadIdx.x < 32) {
    // producer: wait until the slot is free, arm it, issue the copy
    walk(lane, lanes, steps, n_copies, pc.pieces, depth,
         [&](int js, int i, int p, int slot, uint32_t round) {
           if (round > 0) await_phase(&empty[slot], (round - 1) & 1u, spin);
           const size_t off = (size_t)(((long long)(step0 + js) * n_copies + i) % OFFSET_CYCLE);
           const uint32_t bytes = (uint32_t)pc.blocks(p) * BLOCK_BYTES;
           mbar_expect_tx(&full[slot], bytes);
           bulk_load(ring + slot * slot_bytes, src + (off + pc.start(p)) * BLOCK_BYTES, bytes,
                     &full[slot]);
         });
  } else {
    // consumer: wait until the piece has landed, store what the output and
    // the trace ask for, free the slot once the stores have read it
    const int copy_out = (n_copies - 1) / SCRIPT_RING * SCRIPT_RING;
    walk(lane, lanes, steps, n_copies, pc.pieces, depth,
         [&](int js, int i, int p, int slot, uint32_t round) {
           await_phase(&full[slot], round & 1u, spin);
           const int step = step0 + js;
           const unsigned char* piece = ring + slot * slot_bytes;
           if (trace != nullptr)
             bulk_store(trace + (((size_t)step * n_copies + i) * w + pc.start(p)) * BLOCK_BYTES,
                        piece, (uint32_t)pc.blocks(p) * BLOCK_BYTES);
           if (step == n_steps - 1 && i == copy_out && p == 0) bulk_store(out, piece, BLOCK_BYTES);
           mbar_arrive(&empty[slot]);
         });
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

}  // namespace

// n_steps steps of n_copies copies of w blocks from src (at least
// min(n_steps * n_copies, 1024) - 1 + w blocks of 8 KB), in pieces of at
// most piece_blocks blocks (1..w), `steps_per_block` steps to a block, on
// `stream`. out: one block; trace: null, or (n_steps, n_copies, w) blocks.
// The ring takes as many piece slots as fit ring_budget(1), at most
// MAX_SLOTS, for a launch of one block; otherwise as many as fit
// ring_budget(BLOCKS_PER_SM), at most CARD_DEPTH. A ring of no slot is
// refused. Returns cudaGetLastError().
extern "C" int bench_radix_ab(const void* src, int n_steps, int steps_per_block, int n_copies,
                              int w, int piece_blocks, void* out, void* trace, void* stream) {
  if (n_steps < 1 || steps_per_block < 1 || n_copies < 1 || w < 1 || piece_blocks < 1 ||
      piece_blocks > w)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_steps + steps_per_block - 1) / steps_per_block;
  const int slot_bytes = piece_blocks * BLOCK_BYTES;
  const int fit = ring_budget(blocks == 1 ? 1 : BLOCKS_PER_SM) / slot_bytes;
  const int most = blocks == 1 ? MAX_SLOTS : CARD_DEPTH;
  const int depth = fit < most ? fit : most;
  const int smem = depth * slot_bytes;
  if (depth < 1 || smem > dynamic_smem_limit((const void*)dma_probe_kernel))
    return (int)cudaErrorInvalidValue;
  // lanes divides depth: one producer lane and one consumer lane own each
  // slot, so each walks the slot's rounds in order
  int lanes = blocks > 1 ? 1 : depth < ONE_BLOCK_LANES ? depth : ONE_BLOCK_LANES;
  while (depth % lanes) --lanes;
  cudaError_t err = cudaFuncSetAttribute(dma_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dma_probe_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)src, n_steps, steps_per_block, n_copies, w, piece_blocks, depth,
      lanes, (unsigned char*)out, (unsigned char*)trace);
  return (int)cudaGetLastError();
}
