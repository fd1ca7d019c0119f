"""Tile binning: splats -> (tile, depth)-sorted pair attributes + per-tile ranges.

Counterpart of ``vk_gaussian_splatting_tpu/ops/binning.py:121-433``. Tile
rasterization needs each splat duplicated into every 16x16 tile its extent
covers. Two expansions, both plain tensor code:

1. **slots** (the default): every splat gets a fixed run of tile slots
   around its own tile. Splats are ranked by tile coverage, largest first
   (the rank ladder): the top n/64 get a 4K-slot window, the next (to n/4) a
   K-slot window, the rest min(4, K). A splat whose rectangle exceeds its
   window is truncated and ``overflow`` is set — the JAX package does the
   same, and so does this port, on the same splats.
2. **exact**: the precise rectangle of every splat, up to a ``max_pairs``
   budget (rounded up to the blend chunk); ``overflow`` when the budget is
   short.

Then one stable sort of the int64 key ``tile << 32 | encode_minmax_f32(depth)``
orders the pairs, the attribute rows and ids are gathered by the
permutation, and a searchsorted gives each tile its ``[start, start+count)``
range. Invalid slots carry tile id ``num_tiles`` and sort last.

What the JAX package has and this port drops: the packed blend-schedule
words (they exist because dynamic-trip loops deadlock the TPU runtime; the
CUDA blender loops over each tile's range itself) and with them the
schedule cap, whose truncation can also set ``overflow`` in JAX. That cap
does not bind at the sizes this package renders (at 1080p with 1M splats,
7.75 M slot pairs against a cap of about 10.5 M), so it is not modelled.
The binning VJP waits for the training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu_torch.ops.sort import encode_minmax_f32


@dataclasses.dataclass
class TileBins:
    """Pair attributes in (tile, depth) order and per-tile ranges."""

    attrs: torch.Tensor       # (R, P) f32 pair attribute rows
    pair_id: torch.Tensor     # (P,) i32 splat id per sorted pair
    pair_valid: torch.Tensor  # (P,) bool live pair (the first num_pairs)
    tile_start: torch.Tensor  # (T,) i32 first pair of each tile
    tile_count: torch.Tensor  # (T,) i32 pairs of each tile
    num_pairs: torch.Tensor   # () i64 live pair count
    overflow: torch.Tensor    # () bool — slot or pair budget truncated coverage


def tile_rect(xy: torch.Tensor, radius: torch.Tensor, tile_size: int,
              tiles_x: int, tiles_y: int):
    """Per-splat covered tile rectangle [x0,x1) x [y0,y1), clamped to the grid.

    radius: (N, 2) per-axis extent (isotropic for 3DGS)."""
    rx, ry = radius[:, 0], radius[:, 1]

    def cell(v):
        return torch.floor(v / tile_size).to(torch.int64)

    x0 = cell(xy[:, 0] - rx).clamp(0, tiles_x)
    y0 = cell(xy[:, 1] - ry).clamp(0, tiles_y)
    x1 = (cell(xy[:, 0] + rx) + 1).clamp(0, tiles_x)
    y1 = (cell(xy[:, 1] + ry) + 1).clamp(0, tiles_y)
    return x0, y0, x1, y1


def _class_caps(n: int):
    """(cap_g, cap_m) rank-ladder boundaries: ranks [0, cap_g) get the giant
    window, [cap_g, cap_m) the mid window, [cap_m, n) the small one. Floors
    keep full coverage for small scenes."""
    cap_g = min(n, max(-(-n // 64), 256))
    cap_m = min(n, max(-(-n // 4), cap_g + 2048))
    return cap_g, max(cap_m, cap_g)


def _window(x0, y0, x1, y1, cx, cy, gate, k: int, tiles_x: int, num_tiles: int):
    """Clamped k-tile window around each splat's own tile: (m, k) tile ids,
    slot validity, and whether the window truncated the rectangle."""
    w = (x1 - x0).clamp(min=0)
    h = (y1 - y0).clamp(min=0)
    wc = torch.clamp(w, max=k)
    hc = torch.minimum(h, (k // wc.clamp(min=1)).clamp(min=1))
    # prefer squarer windows when clamping both dims
    wc = torch.minimum(wc, (k // hc.clamp(min=1)).clamp(min=1))
    x0c = torch.clamp(cx - wc // 2, x0, torch.maximum(x1 - wc, x0))
    y0c = torch.clamp(cy - hc // 2, y0, torch.maximum(y1 - hc, y0))
    trunc = gate & ((wc * hc) < (w * h))
    slot = torch.arange(k, device=x0.device)[None, :]
    wdiv = wc.clamp(min=1)[:, None]
    tx = x0c[:, None] + slot % wdiv
    ty = y0c[:, None] + slot // wdiv
    sv = (slot < (wc * hc)[:, None]) & gate[:, None]
    tile = torch.where(sv, ty * tiles_x + tx, num_tiles)
    return tile, sv, trunc


def _expand_slots(x0, y0, x1, y1, xy, valid0, *, tile_size, tiles_x,
                  num_tiles, slots_k):
    """Rank-ladder slot expansion -> (pair_tile, pair_src, num_pairs, overflow)."""
    n = x0.shape[0]
    dev = x0.device
    k_m = slots_k
    k_a = min(4, k_m)
    k_g = 4 * k_m
    cx = (xy[:, 0] / tile_size).to(torch.int64)
    cy = (xy[:, 1] / tile_size).to(torch.int64)
    cx = torch.clamp(cx, x0, torch.maximum(x1 - 1, x0))
    cy = torch.clamp(cy, y0, torch.maximum(y1 - 1, y0))

    def win(idx, k):
        return _window(x0[idx], y0[idx], x1[idx], y1[idx], cx[idx], cy[idx],
                       valid0[idx], k, tiles_x, num_tiles)

    if k_m <= k_a:
        # no ladder: every splat gets the same K-slot window
        tile, sv, trunc = win(slice(None), k_m)
        src = torch.arange(n, device=dev)[:, None].expand(n, k_m)
        return tile.reshape(-1), src.reshape(-1), sv.sum(), trunc.any()

    # ladder rank: largest tile coverage first, ties by (valid, cx, cy) — the
    # JAX package's packed key, widened to int64 so no image size limits it
    area = torch.where(valid0, (x1 - x0) * (y1 - y0), 0)
    a12 = torch.clamp(area, max=4095)
    ckey = (((4095 - a12) << 33) | (valid0.to(torch.int64) << 32)
            | (cx << 16) | cy)
    order = torch.sort(ckey, stable=True).indices
    cap_g, cap_m = _class_caps(n)
    tiles, srcs = [], []
    num_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for lo, hi, k in ((0, cap_g, k_g), (cap_g, cap_m, k_m), (cap_m, n, k_a)):
        idx = order[lo:hi]
        tile, sv, trunc = win(idx, k)
        tiles.append(tile.reshape(-1))
        srcs.append(idx[:, None].expand(hi - lo, k).reshape(-1))
        num_pairs = num_pairs + sv.sum()
        overflow = overflow | trunc.any()
    return torch.cat(tiles), torch.cat(srcs), num_pairs, overflow


def _expand_exact(x0, y0, x1, y1, valid0, *, tiles_x, num_tiles, chunk,
                  max_pairs):
    """Exact rectangle expansion into a max_pairs budget ->
    (pair_tile, pair_src, num_pairs, overflow)."""
    if max_pairs <= 0:
        raise ValueError("exact expansion needs a max_pairs budget")
    n = x0.shape[0]
    p_total = -(-max_pairs // chunk) * chunk
    w = (x1 - x0).clamp(min=0)
    h = (y1 - y0).clamp(min=0)
    counts = torch.where(valid0, w * h, 0)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    total = ends[-1]
    p = torch.arange(p_total, device=x0.device)
    s = torch.clamp(torch.searchsorted(starts, p, right=True) - 1, 0, n - 1)
    rank = p - starts[s]
    ws = w[s].clamp(min=1)
    tx = x0[s] + rank % ws
    ty = y0[s] + rank // ws
    tile = torch.where(p < total, ty * tiles_x + tx, num_tiles)
    return tile, s, torch.clamp(total, max=p_total), total > p_total


def bin_splats(proj: ProjectedSplats, rows: torch.Tensor, ids: torch.Tensor, *,
               tile_size: int, tiles_x: int, tiles_y: int, chunk: int = 128,
               slots_k: int = 16, max_pairs: int = 0,
               expansion: str = "slots") -> TileBins:
    """Expand, sort and range the (splat, tile) pairs.

    rows: (R, N) f32 per-splat attribute rows; ids: (N,) i32 splat ids.
    max_pairs: the pair budget of the exact expansion (unused by slots).
    """
    num_tiles = tiles_x * tiles_y
    dkey = torch.where(proj.valid, proj.depth, float("inf"))
    x0, y0, x1, y1 = tile_rect(proj.xy, proj.radius, tile_size, tiles_x, tiles_y)
    valid0 = (proj.valid & (proj.radius.amax(dim=1) > 0)
              & (x1 > x0) & (y1 > y0))
    if expansion == "slots":
        tile, src, num_pairs, overflow = _expand_slots(
            x0, y0, x1, y1, proj.xy, valid0, tile_size=tile_size,
            tiles_x=tiles_x, num_tiles=num_tiles, slots_k=slots_k)
    elif expansion == "exact":
        tile, src, num_pairs, overflow = _expand_exact(
            x0, y0, x1, y1, valid0, tiles_x=tiles_x, num_tiles=num_tiles,
            chunk=chunk, max_pairs=max_pairs)
    else:
        raise ValueError(f"unknown expansion {expansion!r}")

    key = (tile << 32) | encode_minmax_f32(dkey[src])
    skey, perm = torch.sort(key, stable=True)
    src = src[perm]
    tile_sorted = skey >> 32
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, device=tile_sorted.device))
    return TileBins(
        attrs=rows.index_select(1, src),
        pair_id=ids.index_select(0, src),
        pair_valid=tile_sorted < num_tiles,
        tile_start=bounds[:-1].to(torch.int32),
        tile_count=(bounds[1:] - bounds[:-1]).to(torch.int32),
        num_pairs=num_pairs,
        overflow=overflow,
    )
