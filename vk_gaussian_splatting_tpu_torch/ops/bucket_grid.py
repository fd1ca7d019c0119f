"""Bucket-grid binning: exact fine tiles + shifted class-pyramid windows.

Counterpart of ``vk_gaussian_splatting_tpu/ops/bucket_grid.py``, integer for
integer but for one repair (below). Instead of one (splat, tile) pair per covered tile, every splat is
sorted into at most four buckets of a class pyramid, and each 16x16 tile
reads six window spans of that sorted array (ops/raster_bucket.py):

- **fine class** (screen radius r < 8 px): the splat covers at most 2x2
  tiles and is duplicated into exactly the tile buckets it covers, one per
  slot stream (unused slots carry the sentinel bucket);
- **mid / coarse classes** (r < 32 / < 128 px): buckets are overlapping
  cell pairs {p, p+1} of a half-cell-shifted 64 / 256 px grid; the splat
  goes into the two pairs that hold its cell, and each tile reads one
  pair bucket per window row (two rows per class);
- **global class** (the rest): one bucket that every tile reads.

One stable sort of the int64 key ``bucket << 32 | encode_minmax_f32(depth)``
(sentinel slots get +inf depth) makes every bucket a depth-sorted run. The
JAX package's sort is unstable; the two orders can differ only where two
splats of one bucket have exactly equal depths.

Each span holds at most its class cap of candidates, counted with the
TPU kernel's 128-alignment head (``start % 128``): the caps, ``overflow``
and ``fit_caps`` keep that accounting exactly, though the port reads no
aligned blocks. What the port drops of the TPU layout: the block-tiled
``(4N_pad/128, 16, 128)`` attrs, the trailing DMA pad and the row padding;
attrs are plain ``(R, 4N)`` rows beside int32 ids, as on the pair path.

The repair: in ``assign_buckets`` a mid splat whose cell lies at the edge
of the mid grid (jx = 0 or the last cell) has no second pair bucket, but
the JAX package leaves slot 1 at the coarse pair it set for the same
splat first (vk_gaussian_splatting_tpu/ops/bucket_grid.py:143-157). Where
the coarse grid has three cells or more per row (images wider than 256
px), such a splat then sits in a mid and a coarse bucket, and a tile whose
window reads both blends it twice. Here slot 1 is unused there, as the
docstring of the JAX function says it should be; at 1920x1080 with the
headline scene of chip_smoke.py the fault moved 0.8 % of pixels by up to
0.23 against the pair path (measured on an H100). Images up to 256 px wide get the same integers from both packages.

The gather of the rows by the sort permutation is differentiable with the
JAX package's sort-based backward (raster_bucket._br_bwd): the column
gradients are un-permuted to emit order with ``index_copy_`` and the four
slot-major streams summed (``binning.EmitLayout(streams=4)``). Bucket
assignment is discrete: no gradient reaches ``proj`` through it.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch.ops.binning import EmitLayout, _GatherPairs, tile_rect
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu_torch.ops.response import GS_DEPTH
from vk_gaussian_splatting_tpu_torch.ops.sort import encode_minmax_f32

# pyramid cell sizes (px); class radius bound = cell/2 (the fine bound of
# 8 px comes from the 2x2-tile coverage of the exact duplication)
CLASS_CELL_PX = (16, 64, 256)
FINE_R_BOUND = 8.0
CLASS_R_BOUNDS = (FINE_R_BOUND, 32.0, 128.0)
NUM_SPANS = 6  # fine + 2 mid rows + 2 coarse rows + global
NUM_SLOTS = 4  # fine-class duplication streams
HEAD_ALIGN = 128  # the TPU kernel's DMA alignment, kept in the cap accounting


@dataclasses.dataclass(frozen=True)
class BucketGridSpec:
    """Static geometry of the class pyramid for a given image size."""

    tiles_x: int
    tiles_y: int
    dims: tuple          # class 0: (tiles_x, tiles_y); classes 1-2:
                         # (x-pairs, cell-rows) of the shifted pair grid
    cells_x: tuple       # classes 1-2: shifted cell count per row (pairs + 1)
    offsets: tuple       # linear bucket offset per class + (global, invalid)
    num_buckets: int     # total buckets incl. global + trailing invalid

    @staticmethod
    def build(tiles_x: int, tiles_y: int) -> "BucketGridSpec":
        w, h = tiles_x * 16, tiles_y * 16
        dims = [(tiles_x, tiles_y)]
        cells_x = [tiles_x]
        for cell in CLASS_CELL_PX[1:]:
            # shifted cells 0..gc-1 cover centers in [-cell/2, w + cell/2);
            # buckets are the gc-1 overlapping pairs {p, p+1}
            gc = -(-w // cell) + 1
            cells_x.append(gc)
            dims.append((gc - 1, -(-h // cell) + 1))
        offs = [0]
        for gx, gy in dims:
            offs.append(offs[-1] + gx * gy)
        n = offs[-1] + 1  # + global bucket
        return BucketGridSpec(tiles_x=tiles_x, tiles_y=tiles_y, dims=tuple(dims),
                              cells_x=tuple(cells_x), offsets=tuple(offs),
                              num_buckets=n + 1)  # + invalid sentinel


@dataclasses.dataclass
class BucketBins:
    """Depth-sorted per-bucket segments of the 4N slot rows."""

    attrs: torch.Tensor          # (R, 4N) f32 rows in (bucket, depth) order
    ids: torch.Tensor            # (4N,) i32 splat id per sorted slot
    bucket_starts: torch.Tensor  # (num_buckets + 1,) i32 segment starts
    num_valid: torch.Tensor      # () i64 live slot rows
    overflow: torch.Tensor       # () bool — some tile window exceeds its cap


def assign_buckets(proj: ProjectedSplats, spec: BucketGridSpec) -> torch.Tensor:
    """(4, N) i64 slot-stream bucket ids (sentinel = unused slot).

    Fine splats occupy up to 4 slots, one per covered tile. Mid and coarse
    splats occupy slots 0-1 with the two overlapping pair buckets
    {jx-1, jx} of their shifted-grid cell (one at a grid edge); global
    splats occupy slot 0. A splat must reach the screen with its extent
    rectangle, else every off-screen mid or coarse splat would clamp into
    an edge cell."""
    sentinel = spec.num_buckets - 1
    xy, radius = proj.xy.detach(), proj.radius.detach()
    dev = xy.device
    r = radius.amax(dim=1)
    x, y = xy[:, 0], xy[:, 1]
    rx, ry = radius[:, 0], radius[:, 1]
    w_px, h_px = spec.tiles_x * 16, spec.tiles_y * 16
    onscreen = (x + rx > 0) & (x - rx < w_px) & (y + ry > 0) & (y - ry < h_px)
    valid = proj.valid & (r > 0) & onscreen

    # fine: the exact covered-tile rectangle [x0,x1) x [y0,y1), <= 2x2
    x0, y0, x1, y1 = tile_rect(xy, radius, 16, spec.tiles_x, spec.tiles_y)
    fine = valid & (r < FINE_R_BOUND) & (x1 > x0) & (y1 > y0)

    # slots 0-1 of the other classes: the two x-pair buckets, coarsest first
    b0 = torch.full(r.shape, spec.offsets[3], dtype=torch.int64, device=dev)
    b1 = torch.full(r.shape, sentinel, dtype=torch.int64, device=dev)
    for c in (2, 1):
        gp, gy = spec.dims[c]
        gc = spec.cells_x[c]
        cell = CLASS_CELL_PX[c]
        jx = torch.floor((x + cell / 2) / cell).to(torch.int64).clamp(0, gc - 1)
        jy = torch.floor((y + cell / 2) / cell).to(torch.int64).clamp(0, gy - 1)
        base = spec.offsets[c] + jy * gp
        p0_ok = jx - 1 >= 0
        p1_ok = jx <= gp - 1
        s0 = torch.where(p0_ok, jx - 1, jx)
        in_c = r < CLASS_R_BOUNDS[c]
        b0 = torch.where(in_c, base + s0, b0)
        # a finer class overrides both slots; at its grid's edge slot 1 is
        # unused (the JAX package keeps the coarser class's slot 1 there)
        b1 = torch.where(in_c, torch.where(p0_ok & p1_ok, base + jx, sentinel), b1)

    def fine_tile(tx, ty, use):
        ok = fine & use & (tx < x1) & (ty < y1)
        return torch.where(ok, ty * spec.tiles_x + tx, sentinel)

    ones = torch.ones_like(fine)
    return torch.stack([
        torch.where(fine, fine_tile(x0, y0, ones), torch.where(valid, b0, sentinel)),
        torch.where(fine, fine_tile(torch.minimum(x0 + 1, x1 - 1), y0, x1 > x0 + 1),
                    torch.where(valid, b1, sentinel)),
        fine_tile(x0, torch.minimum(y0 + 1, y1 - 1), y1 > y0 + 1),
        fine_tile(torch.minimum(x0 + 1, x1 - 1), torch.minimum(y0 + 1, y1 - 1),
                  (x1 > x0 + 1) & (y1 > y0 + 1)),
    ])


def window_span_table(spec: BucketGridSpec, device=None) -> torch.Tensor:
    """(T, 6, 2) i64 [start_bucket, end_bucket) window spans per tile.

    Span 0: the tile's own fine bucket; 1-2: mid window rows; 3-4: coarse
    window rows; 5: global. Each span is one bucket (or none, past the
    grid's last row), so one depth-sorted run. Static per image size."""
    t = torch.arange(spec.tiles_x * spec.tiles_y, dtype=torch.int64, device=device)
    tx = t % spec.tiles_x
    ty = t // spec.tiles_x
    cols = [torch.stack([t, t + 1], dim=-1)]
    for c in (1, 2):
        gp, gy = spec.dims[c]
        jx = torch.clamp(tx * 16 // CLASS_CELL_PX[c], max=gp - 1)
        jy = ty * 16 // CLASS_CELL_PX[c]
        for dy in (0, 1):
            row = jy + dy
            s = spec.offsets[c] + row.clamp(0, gy - 1) * gp + jx
            cols.append(torch.stack([s, torch.where(row < gy, s + 1, s)], dim=-1))
    g = torch.tensor([spec.offsets[3], spec.offsets[3] + 1], dtype=torch.int64, device=device)
    cols.append(g.expand(t.shape[0], 2))
    return torch.stack(cols, dim=1)


def span_lengths(bucket_starts: torch.Tensor, spec: BucketGridSpec) -> torch.Tensor:
    """(T, 6) i64 candidate count per window span."""
    spans = window_span_table(spec, bucket_starts.device)
    bs = bucket_starts.to(torch.int64)
    return bs[spans[:, :, 1]] - bs[spans[:, :, 0]]


def required_window_caps(bucket_starts: torch.Tensor, spec: BucketGridSpec) -> torch.Tensor:
    """(4,) i64 per-class capacity requirement: the max over tiles of span
    length plus alignment head (``start % 128``), whatever caps are chosen;
    what ``fit_caps`` sizes them from."""
    spans = window_span_table(spec, bucket_starts.device)
    bs = bucket_starts.to(torch.int64)
    starts = bs[spans[:, :, 0]]
    need = bs[spans[:, :, 1]] - starts + starts % HEAD_ALIGN
    return torch.stack([need[:, 0].max(), need[:, 1:3].max(), need[:, 3:5].max(),
                        need[:, 5].max()])


def _segment_starts(sorted_buckets: torch.Tensor, spec: BucketGridSpec) -> torch.Tensor:
    bucket_ids = torch.arange(spec.num_buckets + 1, device=sorted_buckets.device)
    return torch.searchsorted(sorted_buckets, bucket_ids).to(torch.int32)


def measure_required_caps(proj: ProjectedSplats, spec: BucketGridSpec) -> torch.Tensor:
    """(4,) i64 requirement for one projected frame, from the sorted slot
    bucket ids alone (sort + searchsorted, no payload rows and no
    histogram by atomics)."""
    slots = torch.sort(assign_buckets(proj, spec).reshape(-1)).values
    return required_window_caps(_segment_starts(slots, spec), spec)


def fit_caps(required, margin: float = 1.25) -> tuple:
    """Static per-class caps from measured requirements (host side).

    Each cap is the smallest multiple of 128 whose 128-unit count has at
    most two set bits and that is >= margin * required (>= 128), as in the
    JAX package, so both packages size a scene alike."""
    caps = []
    for r in required:
        u = max(1, -(-int(float(r) * margin) // 128))
        while bin(u).count("1") > 2:
            u += 1
        caps.append(128 * u)
    return tuple(caps)


def window_overflow(bucket_starts: torch.Tensor, spec: BucketGridSpec,
                    caps: tuple) -> torch.Tensor:
    """True if any tile's window span (with its alignment head) exceeds its
    class cap: coverage is then truncated at the span's depth tail."""
    cap_t = torch.tensor(caps, dtype=torch.int64, device=bucket_starts.device)
    return torch.any(required_window_caps(bucket_starts, spec) > cap_t)


def sort_slots(bucket: torch.Tensor, depth: torch.Tensor, rows: torch.Tensor,
               ids: torch.Tensor, sentinel: int, *, streams: int = NUM_SLOTS,
               grad_rows: int = GS_DEPTH):
    """The bin stage's sort: ``streams`` slot-major runs of N slots
    (bucket (streams * N,) int64, slot ``s * N + i`` is splat i) in one
    stable sort of ``bucket << 32 | encode_minmax_f32(depth)``, slots in
    the ``sentinel`` bucket or above at +inf depth; then the gather of the
    (R, N) rows (differentiable, ``binning._GatherPairs``) and the (N,) ids
    into sorted order. Returns (sorted keys, rows, ids)."""
    n = rows.shape[1]
    dkey = torch.where(bucket < sentinel, depth.detach().repeat(streams), float("inf"))
    skey, perm = torch.sort((bucket << 32) | encode_minmax_f32(dkey), stable=True)
    src_sorted = perm % max(n, 1)
    attrs = _GatherPairs.apply(rows, src_sorted, perm, EmitLayout(n, streams=streams),
                               grad_rows)
    return skey, attrs, ids.index_select(0, src_sorted)


def bucket_splats(proj: ProjectedSplats, rows: torch.Tensor, ids: torch.Tensor, *,
                  tiles_x: int, tiles_y: int,
                  caps: tuple = (512, 256, 512, 256), grad_rows: int = GS_DEPTH,
                  sort_depth: torch.Tensor | None = None) -> BucketBins:
    """Bucket and depth-sort the splats for the bucket tile rasterizer.

    rows: (R, N) f32 per-splat attribute rows (ops/response.py), whose first
    ``grad_rows`` get gradients through the sort-based backward; ids: (N,)
    i32 splat ids. caps: per-class window-span capacities (fine, mid row,
    coarse row, global), which only decide ``overflow`` here. sort_depth:
    (N,) a depth that replaces ``proj.depth`` in the sort key (the JAX
    ``_bucket_impl``'s depth_override); the kernel merges on the model's
    depth row, so the caller puts the same depth there."""
    spec = BucketGridSpec.build(tiles_x, tiles_y)
    bucket = assign_buckets(proj, spec).reshape(-1)          # slot-major (4N,)
    depth = proj.depth if sort_depth is None else sort_depth
    skey, attrs, ids_sorted = sort_slots(bucket, depth, rows, ids, spec.num_buckets - 1,
                                         grad_rows=grad_rows)
    starts = _segment_starts(skey >> 32, spec)
    return BucketBins(
        attrs=attrs,
        ids=ids_sorted,
        bucket_starts=starts,
        num_valid=starts[spec.num_buckets - 1].to(torch.int64),
        overflow=window_overflow(starts, spec, caps),
    )
