"""Bitonic sort-stage cost across mask and layout styles on the card: the
probe P3.

Counterpart of ``scripts/bench_sort_stage.py`` (its Pallas kernel, built by
``make_call`` at :115), with the kernel csrc/bench_sort_stage.cu. Each of
N_STAGES compare-exchange stages keys a (ROWS, 1024) tile by row ROWS - 1
and moves every column with its key; the stages are the full bitonic
schedule of 1024 (55 stages), cut short or repeated. Variants:

  lane-iota    want_min from the column index
  lane-const   want_min from a (2S, 1024) f32 table the caller passes
  sub8         the table again; each thread holds four columns in
               registers and exchanges partners within a warp (j < 128) by
               shuffles, through shared memory only for j >= 128

Every variant runs the stages on (key, column index) pairs and moves the
rows once at the end, by the final index.

Usage: python -m vk_gaussian_splatting_tpu_torch.probes.bench_sort_stage
       [variant] [rows] [stages] [tpt]

The JAX grid re-sorts the same block on one core 4096 times; here 4096
blocks run at once, each on its own copy of the tiles, so "ns/stage/tile"
is the whole card's throughput.
"""

from __future__ import annotations

import ctypes
import functools
import statistics
import sys

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.timing import call_ms, device_label

C = 1024
STEPS = 4096
VARIANTS = ("lane-iota", "lane-const", "sub8")
SUB8_ROWS = (1, 2, 4, 8, 16, 32)  # the rows sub8 takes, keyed by the last


def full_schedule(c: int) -> list[tuple[int, int]]:
    """The (k, j) stages of a full bitonic sort of c columns."""
    sched = []
    k = 2
    while k <= c:
        j = k // 2
        while j >= 1:
            sched.append((k, j))
            j //= 2
        k *= 2
    return sched


def schedule(n_stages: int, c: int = C) -> list[tuple[int, int]]:
    """The probe's N_STAGES stages: the full schedule of c, cut short or
    repeated."""
    full = full_schedule(c)
    return (full * (n_stages // len(full) + 1))[:n_stages]


def np_masks(sched, c: int = C) -> np.ndarray:
    """(2S, c) f32: rows 2s = is_lo, 2s+1 = want_min of stage s."""
    rows = []
    lane = np.arange(c)
    for k, j in sched:
        is_lo = (lane & j) == 0
        asc = (lane & k) == 0
        rows.append(is_lo.astype(np.float32))
        rows.append((is_lo == asc).astype(np.float32))
    return np.stack(rows, axis=0)


def _stages(x, masks, variant, sched, key_row, on_take=None):
    """The JAX probe's ``stage_*`` math, stage by stage: partners by
    rolls, masks by index math (lane-iota) or from ``masks``. lane
    variants: x (..., rows, C), masks (2S, C); sub8: x (..., rows, 8, 128),
    masks (2S, 8, 128), element e = sublane * 128 + lane."""
    sub8 = variant == "sub8"
    lane = torch.arange(x.shape[-1], device=x.device)
    for s, (k, j) in enumerate(sched):
        if variant == "lane-iota":
            is_lo = (lane & j) == 0
            want_min = is_lo == ((lane & k) == 0)
        else:
            is_lo, want_min = masks[2 * s] > 0.5, masks[2 * s + 1] > 0.5
        if sub8 and j >= 128:  # partners one or more sublanes apart
            up, dn = torch.roll(x, -(j // 128), dims=-2), torch.roll(x, j // 128, dims=-2)
        else:
            up, dn = torch.roll(x, -j, dims=-1), torch.roll(x, j, dims=-1)
        partner = torch.where(is_lo, up, dn)
        key_self = x[..., key_row:key_row + 1, :, :] if sub8 else x[..., key_row:key_row + 1, :]
        key_part = (partner[..., key_row:key_row + 1, :, :] if sub8
                    else partner[..., key_row:key_row + 1, :])
        take = (want_min & (key_part < key_self)) | (~want_min & (key_part > key_self))
        if on_take is not None:
            on_take(take)
        x = torch.where(take, partner, x)
    return x


def sort_stages_ref(x: torch.Tensor, masks: torch.Tensor | None, variant: str, sched,
                    key_row: int) -> torch.Tensor:
    """The plain PyTorch twin of the kernel: the stages ``sched`` applied to
    ``x`` with torch.roll and torch.where, as the JAX stages apply them (no
    argsort: a cut or repeated schedule does not sort)."""
    return _stages(x, masks, variant, sched, key_row)


def network_by_index(keys: torch.Tensor, masks: torch.Tensor | None, variant: str,
                     sched) -> torch.Tensor:
    """The stages ``sched`` on (key, column index) pairs, as the kernels run
    them: each column takes its partner e ^ j's pair by its own test (the
    twin's, want_min by index math or from ``masks``' odd rows). keys (...,
    C); returns the (..., C) int64 column of the input each column holds."""
    e = torch.arange(keys.shape[-1], device=keys.device)
    idx = e.expand(keys.shape)
    for s, (k, j) in enumerate(sched):
        if variant == "lane-iota":
            want_min = ((e & j) == 0) == ((e & k) == 0)
        else:
            want_min = masks[2 * s + 1].reshape(-1) > 0.5
        key_part, idx_part = keys[..., e ^ j], idx[..., e ^ j]
        take = torch.where(want_min, key_part < keys, key_part > keys)
        keys, idx = torch.where(take, key_part, keys), torch.where(take, idx_part, idx)
    return idx


def sort_stages_by_index(x: torch.Tensor, masks: torch.Tensor | None, variant: str, sched,
                         key_row: int) -> torch.Tensor:
    """The form csrc/bench_sort_stage.cu and csrc/bench_roll.cu implement:
    the network on (key, column index) pairs, then one gather of every row
    by the final index. Equals ``sort_stages_ref`` bit for bit, whatever the
    schedule, the table or the ties."""
    flat = x.reshape(*x.shape[:2], -1)      # sub8's (rows, 8, 128) in flat order
    idx = network_by_index(flat[:, key_row], masks, variant, sched)
    return torch.take_along_dim(flat, idx[:, None, :], dim=-1).reshape(x.shape)


def taking_columns(x, masks, variant, sched, key_row) -> int:
    """How many (column, stage) pairs of ``x`` take their partner's column:
    the moves the kernel makes on this data."""
    counts = []
    _stages(x, masks, variant, sched, key_row, on_take=lambda t: counts.append(t.sum()))
    return int(torch.stack(counts).sum()) if counts else 0


@functools.lru_cache(maxsize=64)
def _sched_tensor(sched: tuple, device: str) -> torch.Tensor:
    """The (S, 2) int32 (k, j) table the kernel reads, kept per device."""
    return torch.tensor(sched, dtype=torch.int32, device=device).reshape(-1, 2)


def _check(x, masks, variant, sched, key_row) -> tuple[int, int]:
    """Validate the inputs; returns (tiles, rows)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} is not one of {VARIANTS}")
    tail = (8, 128) if variant == "sub8" else (C,)
    if x.dtype != torch.float32 or x.dim() != 2 + len(tail) or tuple(x.shape[2:]) != tail:
        raise ValueError(f"x must be (tiles, rows, {', '.join(map(str, tail))}) float32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    tiles, rows = x.shape[:2]
    if not 0 <= key_row < rows:
        raise ValueError(f"key row {key_row} outside the {rows} rows")
    for k, j in sched:
        if j < 1 or j & (j - 1) or j >= C or k < 1:
            raise ValueError(f"stage (k={k}, j={j}): j must be a power of two below {C}")
    if variant != "lane-iota":
        if masks is None or masks.dtype != torch.float32 or tuple(masks.shape) != (
                2 * len(sched), *tail) or masks.device != x.device or not masks.is_contiguous():
            raise ValueError(f"{variant} needs a contiguous (2S, {', '.join(map(str, tail))}) "
                             f"float32 mask table on {x.device}")
    if variant == "sub8" and (rows not in SUB8_ROWS or key_row != rows - 1):
        raise ValueError(f"sub8 keeps the key row's pairs in registers: rows must be one of "
                         f"{SUB8_ROWS} and the key row rows - 1, got rows {rows}, key row "
                         f"{key_row}")
    return tiles, rows


def sort_stages(x: torch.Tensor, masks: torch.Tensor | None, variant: str, sched,
                key_row: int, blocks: int = 1) -> torch.Tensor:
    """The stages ``sched`` ((k, j) pairs) over each (rows, 1024) tile of x
    (sub8: (rows, 8, 128)), keyed by row ``key_row``.

    CUDA tensors launch csrc/bench_sort_stage.cu's entry for ``variant`` with
    ``blocks`` blocks, each running the stages on its own copy of the
    tiles' (key, column index) pairs and permuting every row once (block 0
    writes the result), and count one launch in
    ``sort_stages.launches[variant]``; CPU tensors run the twin. Tiles
    whose pairs need more shared memory than the card has (8 KB a tile
    beside 32 KB of rows) raise ValueError."""
    tiles, rows = _check(x, masks, variant, sched, key_row)
    if blocks < 1:
        raise ValueError(f"blocks must be positive, got {blocks}")
    if x.device.type == "cpu":
        return sort_stages_ref(x, masks, variant, sched, key_row)
    if x.device.type != "cuda":
        raise ValueError(f"no sort-stage kernel for device {x.device}")
    if tiles == 0:
        return x.clone()
    with torch.cuda.device(x.device):
        need, limit = _fn("_smem_need")(tiles), _fn("_smem_limit")()
        if need > limit:
            raise ValueError(f"{tiles} tiles of ({rows}, {C}) f32 need {need} B of shared "
                             f"memory per block; the card allows {limit} B")
        out = torch.empty_like(x)
        table = _sched_tensor(tuple(sched), str(x.device))
        err = _fn(variant.replace("-", "_"))(
            x.data_ptr(), 0 if masks is None else masks.data_ptr(), table.data_ptr(),
            len(sched), tiles, rows, key_row, blocks, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bench_sort_stage ({variant}) launch failed: cudaError {err}")
    sort_stages.launches[variant] += 1
    return out


sort_stages.launches = dict.fromkeys(VARIANTS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn(suffix: str):
    """The C function bench_sort_stage_<suffix> of csrc/bench_sort_stage.cu."""
    argtypes = {"_smem_limit": [], "_smem_need": [_I]}.get(
        suffix, [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P])
    sep = "" if suffix.startswith("_") else "_"
    return _build.entry("bench_sort_stage", f"bench_sort_stage{sep}{suffix}", argtypes)


def inputs(variant: str, rows: int, n_stages: int, tpt: int, device, seed: int = 0):
    """(x, masks, sched): the probe's normal f32 tiles from a seeded
    generator, its mask table and its schedule, on ``device``."""
    sched = schedule(n_stages)
    shape = (tpt, rows, 8, 128) if variant == "sub8" else (tpt, rows, C)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(device)
    m = torch.from_numpy(np_masks(sched)).to(device)
    if variant == "sub8":
        m = m.reshape(2 * n_stages, 8, 128)
    return x, (None if variant == "lane-iota" else m), sched


def run(variant: str = "lane-iota", rows: int = 16, n_stages: int = 55, tpt: int = 2,
        device=None) -> dict:
    """The probe: STEPS blocks each run the stages over the tiles; the mean
    of 3 launches after one warm-up. Prints the script's line and the
    device's label; returns the numbers."""
    dev = resolve_device(device)
    x, m, sched = inputs(variant, rows, n_stages, tpt, dev)
    key_row = rows - 1
    ms = statistics.fmean(call_ms(
        lambda: sort_stages(x, m, variant, sched, key_row, blocks=STEPS), dev, 3))
    ns = ms * 1e6 / STEPS / max(n_stages, 1) / max(tpt, 1)
    print(f"device: {device_label(dev)}", flush=True)
    print(f"{variant} rows={rows} stages={n_stages} tpt={tpt}: {ms:.2f} ms total, "
          f"{ns:.1f} ns/stage/tile ({STEPS} blocks)", flush=True)
    return {"ms": ms, "ns_per_stage_tile": ns}


def main() -> int:
    argv = sys.argv[1:]
    variant = argv[0] if len(argv) > 0 else "lane-iota"
    rows = int(argv[1]) if len(argv) > 1 else 16
    n_stages = int(argv[2]) if len(argv) > 2 else 55
    tpt = int(argv[3]) if len(argv) > 3 else 2
    run(variant, rows, n_stages, tpt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
