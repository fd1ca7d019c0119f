"""Data for the counting-sort decision on the card: the probe P2.

Counterpart of ``scripts/bench_radix_ab.py`` (its Pallas ``_dma_kernel``,
:89, built by ``dma_bench_call``, :116). Three parts, as in the script:

1. the copy probe, kernel csrc/bench_radix_ab.cu: per-copy cost of
   pipelined bulk copies of W x (16, 128) f32 blocks (W = 1, 4, 16, 64)
   into shared memory, 256 steps x 64 copies at block offsets (j * 64 + i)
   % 1024; one block runs the steps in order (one copy engine, as the JAX
   grid runs on one core), then 256 blocks run one step each (the whole
   card). The offsets reach the first 8 MB of the 16 MB source, which L2
   holds after the first pass: the copies are served from L2, not from
   device memory;
2. the port's own bucket sort stage, ops/bucket_grid.sort_slots as
   bucket_splats calls it: the int64 key (bucket << 32) |
   encode_minmax_f32(depth) of 4 slot-major slots per splat, a stable
   torch.sort, and the gather of 16 payload rows and the ids, at 1 M, 4 M
   and 16 M sorted rows (slots) on keys with the bench scene's occupancy
   shape;
3. the run statistics of the same keys: how many contiguous (chunk,
   coarse-digit) runs pass B of a counting sort would copy, and the
   projected pass-B cost from the measured per-copy time and the card's
   memory rate (the per-copy time is that of the L2-served copies).

Usage: python -m vk_gaussian_splatting_tpu_torch.probes.bench_radix_ab
       [rows_millions ...]   (default 1 4 16)
"""

from __future__ import annotations

import ctypes
import sys
from typing import NamedTuple

import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import NUM_SLOTS, sort_slots
from vk_gaussian_splatting_tpu_torch.timing import call_ms, device_label

R_PAYLOAD = 16                         # attr rows carried by the binning sort
BLOCK = (R_PAYLOAD, 128)               # one copied block: 8 KB of f32
BLOCK_BYTES = R_PAYLOAD * 128 * 4
SRC_BLOCKS = 2048                      # the probe's (2048, 16, 128) source, 16 MB
OFFSET_CYCLE = 1024                    # copy offsets cycle over this many blocks
N_BUCKETS = 13000                      # make_keys' buckets; the last is the sentinel
RING = 8                               # the script's ring slots; the output is its slot 0
WIDTHS = (1, 4, 16, 64)
N_STEPS, N_COPIES = 256, 64
CARD_BYTES_PER_S = 3.35e12             # H100 SXM HBM3 (NVIDIA data sheet)
# the kernel's ring (csrc/bench_radix_ab.cu keeps the same numbers)
MAX_SLOTS = 28                         # most slots of a launch of one block
BLOCKS_PER_SM = 2                      # blocks an SM of a launch of more than one block
SM_SHARED = 233472                     # an SM's shared memory, 228 KB
BLOCK_RESERVED = 1024                  # shared memory the system keeps per block
BARRIER_BYTES = 2 * MAX_SLOTS * 8      # a full and an empty mbarrier per slot
# Measured (PERF.md, §6, the P2 row's ceiling): across the card L2 sets the
# rate and more bytes in flight only queue behind it, so each block keeps
# CARD_DEPTH pieces of at most CARD_PIECE_BLOCKS blocks in flight; one lane
# issues a bulk copy only every 100-200 ns and one SM takes in at most
# about 105 B a clock, so one block alone issues from up to ONE_BLOCK_LANES
# lanes at once, in pieces of up to ONE_PIECE_BLOCKS blocks, at least
# MIN_DEPTH of them
CARD_PIECE_BLOCKS, CARD_DEPTH = 1, 4
ONE_PIECE_BLOCKS, MIN_DEPTH = 8, 3
ONE_BLOCK_LANES = 16


class RingPlan(NamedTuple):
    slot_blocks: int                   # blocks a slot holds: the largest piece
    pieces: int                        # pieces a copy
    depth: int                         # slots of the ring
    ring_bytes: int                    # shared memory of the ring
    lanes: int                         # lanes of each warp: producers, and consumers


def ring_budget(per_sm: int) -> int:
    """Ring bytes a block may take when ``per_sm`` blocks share an SM."""
    return SM_SHARED // per_sm - BLOCK_RESERVED - BARRIER_BYTES


def ring_of(w: int, per_sm: int = BLOCKS_PER_SM) -> RingPlan:
    """The kernel's ring for copies of w blocks at ``per_sm`` blocks an SM
    (1: a launch of one block, which has an SM to itself). A copy goes out
    in the fewest pieces of at most ONE_PIECE_BLOCKS blocks that leave room
    for MIN_DEPTH slots (one block) or of at most CARD_PIECE_BLOCKS (more),
    their sizes differing by at most one block (``pieces_of``); the ring
    holds as many slots of the largest piece as the block's share of the SM
    takes, at most MAX_SLOTS (one block) or CARD_DEPTH; one block issues
    and consumes with as many lanes at once as divide the depth, at most
    ONE_BLOCK_LANES, more blocks with one. The kernel takes ``slot_blocks``
    and sizes its ring the same way."""
    fit = ring_budget(per_sm) // BLOCK_BYTES
    if per_sm == 1:
        most, cap = min(ONE_PIECE_BLOCKS, fit // MIN_DEPTH), MAX_SLOTS
    else:
        most, cap = CARD_PIECE_BLOCKS, CARD_DEPTH
    pieces = -(-w // most)
    slot = -(-w // pieces)
    depth = min(cap, fit // slot)
    lanes = max(n for n in range(1, min(ONE_BLOCK_LANES, depth) + 1) if depth % n == 0) \
        if per_sm == 1 else 1
    return RingPlan(slot, pieces, depth, depth * slot * BLOCK_BYTES, lanes)


def pieces_of(w: int, slot_blocks: int) -> list[tuple[int, int]]:
    """(first block, blocks) of each piece of a copy of w blocks in slots
    of ``slot_blocks``, as the kernel cuts it."""
    n = -(-w // slot_blocks)
    base, rem = divmod(w, n)
    return [(p * base + min(p, rem), base + (p < rem)) for p in range(n)]


def per_sm_of(n_steps: int, steps_per_block: int) -> int:
    """Blocks an SM the kernel plans for: 1 for a launch of one block."""
    return 1 if steps_per_block >= n_steps else BLOCKS_PER_SM


def copy_offsets(n_steps: int, n_copies: int) -> list[int]:
    """The first source block of each copy, step-major."""
    return [(j * n_copies + i) % OFFSET_CYCLE for j in range(n_steps) for i in range(n_copies)]


def dma_copies_ref(src: torch.Tensor, n_steps: int, n_copies: int, w: int,
                   trace: bool = False):
    """The plain twin of the copy probe: every copy made in order into the
    script's 8-slot ring of w blocks (copy i of a step into slot i % 8). Returns the
    first block of ring slot 0 at the end, (1, 16, 128), and with ``trace``
    also every copy, (n_steps, n_copies, w, 16, 128)."""
    ring = src.new_empty((RING, w, *BLOCK))
    copies = []
    for q, off in enumerate(copy_offsets(n_steps, n_copies)):
        ring[q % n_copies % RING].copy_(src[off:off + w])
        if trace:
            copies.append(src[off:off + w])
    out = ring[0, :1].clone()
    if trace:
        return out, torch.stack(copies).reshape(n_steps, n_copies, w, *BLOCK)
    return out


def _check(src, n_steps, n_copies, w, steps_per_block):
    if n_steps < 1 or n_copies < 1 or w < 1 or steps_per_block < 1:
        raise ValueError(f"steps {n_steps}, copies {n_copies}, w {w} and steps per block "
                         f"{steps_per_block} must be positive")
    if src.dtype != torch.float32 or src.dim() != 3 or tuple(src.shape[1:]) != BLOCK \
            or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (N, {R_PAYLOAD}, 128) float32 tensor, got "
                         f"{tuple(src.shape)} {src.dtype}")
    need = min(n_steps * n_copies, OFFSET_CYCLE) - 1 + w
    if src.shape[0] < need:
        raise ValueError(f"copies of {w} blocks at offsets below {OFFSET_CYCLE} read {need} "
                         f"blocks; src has {src.shape[0]}")


def dma_copies(src: torch.Tensor, n_steps: int, n_copies: int, w: int,
               steps_per_block: int | None = None, trace: bool = False):
    """The copy probe: ``n_steps`` steps of ``n_copies`` copies of ``w``
    blocks of ``src`` (N, 16, 128) f32 at block offsets (j * n_copies + i)
    % 1024, as ``dma_copies_ref``; returns the same output (and trace).

    CUDA tensors launch csrc/bench_radix_ab.cu with ``steps_per_block``
    steps to a block (default: all, one block) and count one launch in
    ``dma_copies.launches``; CPU tensors run the twin. With ``trace`` the
    kernel also stores every copied block out, for a check."""
    steps_per_block = n_steps if steps_per_block is None else steps_per_block
    _check(src, n_steps, n_copies, w, steps_per_block)
    if src.device.type == "cpu":
        return dma_copies_ref(src, n_steps, n_copies, w, trace)
    if src.device.type != "cuda":
        raise ValueError(f"no copy kernel for device {src.device}")
    with torch.cuda.device(src.device):
        out = torch.empty((1, *BLOCK), dtype=torch.float32, device=src.device)
        copies = (torch.empty((n_steps, n_copies, w, *BLOCK), dtype=torch.float32,
                              device=src.device) if trace else None)
        err = _build.entry("bench_radix_ab", "bench_radix_ab",
                           [_P, _I, _I, _I, _I, _I, _P, _P, _P])(
            src.data_ptr(), n_steps, steps_per_block, n_copies, w,
            ring_of(w, per_sm_of(n_steps, steps_per_block)).slot_blocks, out.data_ptr(),
            0 if copies is None else copies.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bench_radix_ab launch failed: cudaError {err}")
    dma_copies.launches += 1
    return (out, copies) if trace else out


dma_copies.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def make_keys(n_rows: int, device, n_buckets: int = N_BUCKETS, seed: int = 0):
    """Binning keys with the bench scene's occupancy shape, from a seeded
    generator on ``device``: ~75 % of rows in the 8160 fine buckets, the
    rest in the mid, coarse and global ones, uniform within each class;
    depths uniform in [0, 1). Returns (bucket int64, as assign_buckets
    gives them, depth f32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    fine = torch.randint(0, 8160, (n_rows,), generator=g, device=device)
    rest = torch.randint(8160, n_buckets, (n_rows,), generator=g, device=device)
    pick = torch.rand(n_rows, generator=g, device=device) < 0.75
    bucket = torch.where(pick, fine, rest)
    return bucket, torch.rand(n_rows, generator=g, device=device)


def sort_stage(bucket: torch.Tensor, depth: torch.Tensor, rows: torch.Tensor,
               ids: torch.Tensor):
    """The port's bucket sort stage, ``ops/bucket_grid.sort_slots`` as
    ``bucket_splats`` calls it: bucket (S * N,) holds S slot-major slots of
    each of N splats (depth (N,), rows (16, N), ids (N,)), the last of
    make_keys' buckets is the sentinel. Returns (sorted buckets int32, the
    first sorted payload row)."""
    skey, attrs, _ = sort_slots(bucket.to(torch.int64), depth, rows, ids, N_BUCKETS - 1,
                                streams=bucket.numel() // max(rows.shape[1], 1))
    return (skey >> 32).to(torch.int32), attrs[0]


def run_stats(bucket: torch.Tensor, chunk: int, digit_shift: int) -> tuple[int, float]:
    """(n_runs, mean_len) of contiguous same-coarse-digit runs within each
    locally sorted chunk: pass A sorts each chunk in fast memory, pass B
    copies one run per copy, so this is pass B's copy count for a (chunk,
    digit) choice. ``bucket`` holds whole chunks."""
    b = torch.sort(bucket.reshape(-1, chunk) >> digit_shift, dim=1).values
    changes = int((b[:, 1:] != b[:, :-1]).sum()) + b.shape[0]
    return changes, bucket.shape[0] / max(changes, 1)


def dma_microbench(dev) -> dict:
    """Per-copy ns at each W: one block (one copy engine), then one block
    per step across the card. Returns {w: (ns one block, ns card-wide)}."""
    src = torch.zeros((SRC_BLOCKS, *BLOCK), dtype=torch.float32, device=dev)
    print(f"# copy microbench: pipelined bulk copies (L2 -> shared memory: the offsets' "
          f"{OFFSET_CYCLE * BLOCK_BYTES >> 20} MB stay in L2) of W x ({R_PAYLOAD},128) f32 "
          f"blocks, {N_STEPS} steps x {N_COPIES} copies", flush=True)
    res = {}
    n = N_STEPS * N_COPIES
    for w in WIDTHS:
        one_plan, card_plan = ring_of(w, 1), ring_of(w)
        one = min(call_ms(lambda: dma_copies(src, N_STEPS, N_COPIES, w), dev, 5, warmup=2))
        card = min(call_ms(lambda: dma_copies(src, N_STEPS, N_COPIES, w, steps_per_block=1),
                           dev, 5, warmup=2))
        gb = n * w * BLOCK_BYTES / 1e9
        res[w] = (one * 1e6 / n, card * 1e6 / n)
        print(f"W={w:3d} blocks ({w * BLOCK_BYTES // 1024:5d} KB), {card_plan.pieces} piece(s) "
              f"per copy: one block (ring {one_plan.depth} x "
              f"{one_plan.slot_blocks * BLOCK_BYTES // 1024} KB) {res[w][0]:7.1f} ns/copy "
              f"({gb / one * 1e3:6.1f} GB/s effective); {N_STEPS} blocks (ring "
              f"{card_plan.depth} x {card_plan.slot_blocks * BLOCK_BYTES // 1024} KB, "
              f"{BLOCKS_PER_SM} an SM) {res[w][1]:7.2f} ns/copy ({gb / card * 1e3:7.1f} GB/s)",
              flush=True)
    return res


def run(sizes_m=(1, 4, 16), device=None) -> dict:
    """The probe's three parts; prints the script's lines and the device's
    label, returns the numbers."""
    dev = resolve_device(device)
    print(f"device: {device_label(dev)}", flush=True)
    per_copy = dma_microbench(dev)
    print(f"\n# sort stage (ops/bucket_grid.sort_slots: {NUM_SLOTS} slots per splat, one int64 "
          f"key: bucket, depth; gathers {R_PAYLOAD} payload rows and the ids)", flush=True)
    sort_ms = {}
    for m in sizes_m:
        n = int(m * 1e6) // 4096 * 4096
        bucket, depth = make_keys(n, dev)
        splats = n // NUM_SLOTS
        depth = depth[:splats]
        rows = torch.zeros((R_PAYLOAD, splats), dtype=torch.float32, device=dev)
        ids = torch.arange(splats, dtype=torch.int32, device=dev)
        ms = min(call_ms(lambda: sort_stage(bucket, depth, rows, ids), dev,
                         3 if m >= 8 else 5, warmup=2))
        sort_ms[m] = ms
        print(f"\nN = {m:g}M rows ({splats} splats x {NUM_SLOTS} slots): torch sort stage = "
              f"{ms:.3f} ms", flush=True)
        for chunk, shift in ((4096, 7), (4096, 0), (16384, 7)):
            whole = n // chunk * chunk
            runs, mean_len = run_stats(bucket[:whole], chunk, shift)
            w_near = min(WIDTHS, key=lambda w: abs(w * 128 - mean_len))
            lat_one, lat_card = (runs * ns * 1e-6 for ns in per_copy[w_near])
            bw_ms = n * R_PAYLOAD * 4 * 2 / CARD_BYTES_PER_S * 1e3
            print(f"  passB(chunk={chunk}, digit>>{shift}, {whole} rows): {runs} runs, mean "
                  f"{mean_len:.1f} rows -> projected from L2-served copies >= {lat_one:.3f} ms "
                  f"latency (one block) "
                  f"or {lat_card:.3f} ms (card-wide) + {bw_ms:.3f} ms bytes "
                  f"(x2 passes for full order)", flush=True)
    return {"per_copy_ns": per_copy, "sort_ms": sort_ms}


def main() -> int:
    argv = sys.argv[1:]
    run([float(s) for s in argv] or [1, 4, 16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
