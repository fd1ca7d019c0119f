"""Bitonic-sort cost on (R, C) tiles in shared memory: the probe P1.

Counterpart of ``scripts/bench_roll.py`` (its Pallas ``kernel``, :32, called
at :52), with the kernel csrc/bench_roll.cu: the full bitonic network of C
(the stages of ``bench_sort_stage.full_schedule(C)``, want_min by index
math, key row 0) sorts an (R, C) f32 tile, every column moving with its
key, REPS = 200 times over. The kernel takes a batch (T, R, C): each block
sorts one tile's (key, column index) pairs ``reps`` times and then moves
its rows once, by the final index.

Usage: python -m vk_gaussian_splatting_tpu_torch.probes.bench_roll [R] [C]

Prints the script's three numbers: microseconds per sort (T = 1, reps =
200), nanoseconds per stage (over the true stage count of C, 66 at 2048),
and the time of 8160 tiles, the 1080p frame's tile count, measured by one
launch of T = 8160, reps = 1 (the JAX script projects it from one tile).
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.probes.bench_sort_stage import (
    full_schedule,
    sort_stages_by_index,
    sort_stages_ref,
)
from vk_gaussian_splatting_tpu_torch.timing import call_ms, device_label

REPS = 200
FRAME_TILES = 8160  # 16x16 tiles of a 1920x1080 frame


def bitonic_sort_ref(x: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """The plain PyTorch twin: the full schedule of C, ``reps`` times, over
    each (R, C) tile of x (..., R, C), keyed by row 0 (the lane-iota stage
    of ``bench_sort_stage``)."""
    return sort_stages_ref(x, None, "lane-iota", full_schedule(x.shape[-1]) * reps, 0)


def bitonic_sort_by_index(x: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """The form the kernel implements: the ``reps`` networks on (key,
    column index) pairs, the index carried across, then one gather of each
    tile's rows; bit-equal to ``bitonic_sort_ref``."""
    return sort_stages_by_index(x, None, "lane-iota", full_schedule(x.shape[-1]) * reps, 0)


def bitonic_sort(x: torch.Tensor, reps: int = 1) -> torch.Tensor:
    """Sort each (R, C) tile of x (T, R, C) f32 by row 0, ``reps`` times.

    CUDA tensors launch csrc/bench_roll.cu (one block per tile: the
    network on (key, column index) pairs, then one permutation of the
    rows) and count one launch in ``bitonic_sort.launches``; CPU tensors
    run the twin. C must be a power of two, and a block's pairs and one
    row slot must fit its shared memory (12 C bytes: C up to 16384), else
    ValueError."""
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (T, R, C) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    tiles, rows, c = x.shape
    if c < 2 or c & (c - 1) or rows < 1:
        raise ValueError(f"C must be a power of two >= 2 and R >= 1, got R={rows} C={c}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if x.device.type == "cpu":
        return bitonic_sort_ref(x, reps)
    if x.device.type != "cuda":
        raise ValueError(f"no bitonic kernel for device {x.device}")
    if tiles == 0:
        return x.clone()
    with torch.cuda.device(x.device):
        need = _fn("bench_roll_smem_need", [_I, _I])(rows, c)
        limit = _fn("bench_roll_smem_limit", [])()
        if need > limit:
            raise ValueError(f"a block on ({rows}, {c}) f32 tiles needs {need} B of shared "
                             f"memory; the card allows {limit} B")
        out = torch.empty_like(x)
        err = _fn("bench_roll", [_P, _I, _I, _I, _I, _P, _P])(
            x.data_ptr(), tiles, rows, c, reps, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bench_roll launch failed: cudaError {err}")
    bitonic_sort.launches += 1
    return out


bitonic_sort.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn(symbol: str, argtypes):
    return _build.entry("bench_roll", symbol, argtypes)


def tiles_of(t: int, r: int, c: int, device, seed: int = 0) -> torch.Tensor:
    """(t, r, c) uniform [0, 1) f32 tiles from a seeded generator, made on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((t, r, c), generator=g, device=device)


def run(r: int = 16, c: int = 2048, device=None) -> dict:
    """The probe: one tile sorted REPS times, and FRAME_TILES tiles sorted
    once, each the mean of 3 launches after a warm-up. Prints the script's
    line and the device's label; returns the numbers."""
    dev = resolve_device(device)
    stages = len(full_schedule(c))
    one = tiles_of(1, r, c, dev)
    per_sort = statistics.fmean(call_ms(lambda: bitonic_sort(one, REPS), dev, 3)) / REPS
    frame = tiles_of(FRAME_TILES, r, c, dev, seed=1)
    frame_ms = statistics.fmean(call_ms(lambda: bitonic_sort(frame, 1), dev, 3))
    print(f"device: {device_label(dev)}", flush=True)
    print(f"R={r} C={c}: {per_sort * 1e3:.2f} us per {stages}-stage sort; "
          f"{per_sort / stages * 1e6:.1f} ns/stage; "
          f"{FRAME_TILES} tiles -> {frame_ms:.3f} ms (one launch)", flush=True)
    return {"us_per_sort": per_sort * 1e3, "ns_per_stage": per_sort / stages * 1e6,
            "frame_ms": frame_ms}


def main() -> int:
    argv = sys.argv[1:]
    r = int(argv[0]) if len(argv) > 0 else 16
    c = int(argv[1]) if len(argv) > 1 else 2048
    run(r, c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
