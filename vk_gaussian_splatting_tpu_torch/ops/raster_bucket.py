"""Bucket-grid tile rasterizer, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch twins and the autograd Function that joins
them.

Counterpart of ``vk_gaussian_splatting_tpu/ops/raster_bucket.py``: K3
(``_make_kernel``, :469) and K4 (``_make_bwd_kernel``, :927, with the slot
reduction of ``_br_bwd``, :1367) for the gs2d and gut3d response models
(``RasterStatics.model``), and K3 for the packed models gs2dp and gut3dp,
which are forward only. The CUDA kernels are ``csrc/raster_bucket_fwd.cu``
and ``csrc/raster_bucket_bwd.cu``, one entry point per model in each; they
share ``csrc/raster_bucket.cuh`` and ``csrc/response.cuh``.

Each 16x16 tile reads its six window spans of the bucket-sorted slot array
(ops/bucket_grid.py): its own fine bucket, two mid rows, two coarse rows and
the global bucket. Span i holds ``n_eff = min(len, cap_i - start % 128)``
candidates, the TPU kernel's capacity with its 128-alignment head, and the
spans' depth-sorted runs are merged into one list ordered by (depth, span,
position in span), the depth being the model's depth row (for 3DGRT the
radial distance render/pipelines puts there), or, in the key-row form
(``RasterStatics.key_is_row``, gs2d: the JAX kernel's ``key_is_row``,
raster_bucket.py:653-660, :1059-1063), the key row ``GS_KEY`` after the
model's rows, which holds the host sorter's rank (render/pipelines.py,
``host_order``) and gets no gradient. Then the tile blends that list front to back with the
pair blender's math (ops/rasterize.py), in steps of ``st.chunk`` lanes
(``RasterConfig.bucket_chunk``): live candidate k sits at lane
``n_head + k``, where ``n_head`` sums the heads of the non-empty spans, so a
pixel freezes at the same lanes as in the TPU kernel, whose merged buffer
holds the dead head lanes first.

The twins lay each tile's merged list out in its own region of a flat pair
array, starting at a multiple of the chunk, and run the pair twins'
sweep (``rasterize._blend_steps``) over it: one sweep serves all four
twins. The backward sums each (tile, lane) gradient into its slot column.

The stochastic form (``RasterStatics.stochastic``) keys merged lane m of
tile t as the TPU kernels key their chunks (raster_bucket.py:744-745,
:1106-1107): ``key = seed + t * n_chunks + m // chunk`` and ``lane = m %
chunk``, m counting the dead head lanes too and n_chunks the chunks of the
kernel's whole merged buffer (``n_chunks``; its ``_chunk_bounds``).

On CUDA tensors the forward launches K3 and the backward K4; on CPU
tensors both run the twins; nothing else decides which. A failed build or
launch raises. gut3d reads the per-tile pixel context (T, 8, 256), which
gets no gradient (the JAX VJP returns zeros for it). What the port drops of the TPU kernels: the tiles-per-step
interleave, the 4x4-tile cell grid, the DMA staging and the odd-even merge
network (a merged lane's rank is a binary-search count here).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import typing

import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.ops.binning import EmitLayout
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import (
    HEAD_ALIGN,
    NUM_SPANS,
    BucketBins,
    BucketGridSpec,
    window_span_table,
)
from vk_gaussian_splatting_tpu_torch.ops.rasterize import (
    CTX_ROWS,
    KEPT_COUNTER,
    OUT_ROWS,
    PIX,
    TRAINED,
    RasterStatics,
    _check,
    _ptr,
    _tile_pixel_coords,
    blend_work,
    check_bucket_model,
    bwd_context,
    check_pix_ctx,
    count_launch,
    entry_name,
    form_of,
    model_args,
    rasterize_tiles_bwd_ref,
    rasterize_tiles_ref,
    zero_counters,
)
from vk_gaussian_splatting_tpu_torch.ops.response import (
    alpha,
    attr_rows,
    may_hit,
    merge_row,
    model_of,
    refuse_backward,
    tile_bound,
    unpack_rows,
)

MAX_BUCKET_CHUNK = 1024  # csrc/raster_bucket_{fwd,bwd}.cu stage at most this many lanes
READER_SEGMENT = 64      # K4's reduce sums a shared column over at most this many tiles per pass


def _span_sizes(caps: tuple) -> list[int]:
    """Per-span capacities: [fine, mid x2, coarse x2, global]."""
    return [caps[0]] + [caps[1]] * 2 + [caps[2]] * 2 + [caps[3]]


def check_caps(caps) -> tuple:
    """The four class caps as ints; raises unless each is a positive
    multiple of 128 (the head accounting needs cap >= 128)."""
    caps = tuple(caps)
    if len(caps) != 4 or any(int(c) != c or c <= 0 or c % HEAD_ALIGN for c in caps):
        raise ValueError(f"bucket caps must be four positive multiples of {HEAD_ALIGN}, "
                         f"got {caps}")
    return tuple(int(c) for c in caps)


@functools.lru_cache(maxsize=16)
def _span_table(tiles_x: int, tiles_y: int, device: torch.device) -> torch.Tensor:
    """(T, 6, 2) i32 window span buckets per tile, kept on ``device``."""
    spec = BucketGridSpec.build(tiles_x, tiles_y)
    return window_span_table(spec, device).to(torch.int32).contiguous()


class _Readers(typing.NamedTuple):
    """Which tiles read each bucket through a shared span (1-5): K4's reduce
    order. All i32 on the device."""

    code: torch.Tensor        # (E,) tile * 8 + span, in (bucket, tile, span) order
    seg_bucket: torch.Tensor  # (S,) the bucket of each segment of <= READER_SEGMENT readers
    seg_first: torch.Tensor   # (S,) its readers [seg_first, seg_last) in ``code``
    seg_last: torch.Tensor
    bucket_seg: torch.Tensor  # (num_buckets + 1,) bucket b owns segments
                              # [bucket_seg[b], bucket_seg[b + 1])


@functools.lru_cache(maxsize=16)
def _readers(tiles_x: int, tiles_y: int, device: torch.device) -> _Readers:
    """The reader table of an image size (static), from window_span_table."""
    spec = BucketGridSpec.build(tiles_x, tiles_y)
    table = window_span_table(spec, device)[:, 1:]                 # (T, 5, 2)
    n_t = table.shape[0]
    tile = torch.arange(n_t, device=device)[:, None].expand(n_t, NUM_SPANS - 1)
    span = torch.arange(1, NUM_SPANS, device=device)[None, :].expand(n_t, NUM_SPANS - 1)
    ok = table[..., 1] > table[..., 0]                              # not past the grid
    bucket = table[..., 0][ok]
    order = torch.sort(bucket, stable=True).indices
    code = (tile * 8 + span)[ok][order]
    start = torch.searchsorted(bucket[order],
                               torch.arange(spec.num_buckets + 1, device=device))
    n_seg = -(-(start[1:] - start[:-1]) // READER_SEGMENT)
    bucket_seg = torch.cat([n_seg.new_zeros(1), torch.cumsum(n_seg, 0)])
    seg_bucket = torch.repeat_interleave(torch.arange(spec.num_buckets, device=device), n_seg)
    seg_first = (start[seg_bucket] + READER_SEGMENT
                 * (torch.arange(seg_bucket.shape[0], device=device) - bucket_seg[seg_bucket]))
    seg_last = torch.minimum(seg_first + READER_SEGMENT, start[seg_bucket + 1])
    return _Readers(*(x.to(torch.int32).contiguous() for x in (
        code, seg_bucket, seg_first, seg_last, bucket_seg)))


def _tile_spans(bucket_starts: torch.Tensor, st: RasterStatics, caps: tuple,
                tiles: torch.Tensor):
    """(first column, live count) of each window span, (n, 6) i64, and the
    alignment head before the first live lane, (n,) i64, of the given
    tiles (raster_bucket._tile_spans and the kernel's n_eff / n_head)."""
    table = _span_table(st.tiles_x, st.tiles_y, bucket_starts.device)[tiles].to(torch.int64)
    bs = bucket_starts.to(torch.int64)
    start = bs[table[..., 0]]
    length = (bs[table[..., 1]] - start).clamp(min=0)
    head = start % HEAD_ALIGN
    cap = torch.tensor(_span_sizes(caps), dtype=torch.int64, device=bs.device)
    n_eff = torch.minimum(length, cap - head)
    n_head = torch.where(n_eff > 0, head, 0).sum(dim=1)
    return start, n_eff, n_head


@dataclasses.dataclass
class _TileLists:
    """The merged candidate lists of some tiles, laid out as a pair array."""

    cols: torch.Tensor        # (n * L,) i64 source column of each lane, -1 for none
    tile_start: torch.Tensor  # (T,) i32 first live lane of each listed tile
    tile_count: torch.Tensor  # (T,) i32 its live lanes
    n_eff: torch.Tensor       # (n, 6) i64 live candidates per span
    key_offset: torch.Tensor  # (n,) i64 the stochastic key of lane p is seed + p // chunk + this


def n_chunks(caps: tuple, chunk: int) -> int:
    """Blend chunks of the TPU kernel's merged buffer of all six spans'
    caps (``len(raster_bucket._chunk_bounds(c_total, chunk))``): the
    stride of the stochastic keys from one tile to the next."""
    return -(-sum(_span_sizes(caps)) // chunk)


def _check_key_order(key: torch.Tensor, live: torch.Tensor, span: torch.Tensor) -> None:
    """Raise unless each span's live keys ascend. The merge ranks a lane by
    counting the keys of the other spans before it, which is right only
    for ascending spans: the key row must be the depth the slots were
    sorted by (``bucket_splats(sort_depth=...)``), else the order breaks
    without a sign."""
    same = (span[1:] == span[:-1]) & live[:, 1:]
    if bool((same & (key[:, 1:] < key[:, :-1])).any()):
        raise ValueError("a window span's key row does not ascend: the key row must hold "
                         "the sort_depth the slots were sorted by")


def _tile_lists(attrs: torch.Tensor, bucket_starts: torch.Tensor, st: RasterStatics,
                caps: tuple, tiles: torch.Tensor) -> _TileLists:
    """Merge each tile's six spans by (depth, span, position in span): one
    stable sort of the depth keys laid out span after span (the key row's
    values with ``st.key_is_row``, whose spans must ascend). Tile b's region
    starts at lane b * L, L a multiple of the chunk, and live candidate k
    sits at b * L + n_head + k, so the chunk boundaries fall at the TPU
    kernel's lanes."""
    dev = attrs.device
    start, n_eff, n_head = _tile_spans(bucket_starts, st, caps, tiles)
    sizes = torch.tensor(_span_sizes(caps), device=dev)
    span = torch.repeat_interleave(torch.arange(NUM_SPANS, device=dev), sizes)
    pos = torch.arange(span.shape[0], device=dev) - (torch.cumsum(sizes, 0) - sizes)[span]
    col = start[:, span] + pos                                      # (n, c_total)
    live = pos < n_eff[:, span]
    depth = attrs[merge_row(st)].detach()
    key = depth[col.clamp(0, depth.shape[0] - 1)] if depth.numel() else col.float()
    key = torch.where(live, key, float("inf"))
    if st.key_is_row:
        _check_key_order(key, live, span)
    merged = torch.gather(torch.where(live, col, -1), 1,
                          torch.sort(key, dim=1, stable=True).indices)
    n = tiles.shape[0]
    n_live = n_eff.sum(dim=1)
    c = st.chunk
    span_len = int((n_head + n_live).max()) if n else 0
    lanes = -(-span_len // c) * c
    k_max = int(n_live.max()) if n else 0
    k = torch.arange(k_max, device=dev)
    keep = k[None, :] < n_live[:, None]
    dst = torch.arange(n, device=dev)[:, None] * lanes + n_head[:, None] + k
    cols = torch.full((n * lanes,), -1, dtype=torch.int64, device=dev)
    cols[dst[keep]] = merged[:, :k_max][keep]
    num_tiles = st.tiles_x * st.tiles_y
    tile_start = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    tile_count = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    tile_start[tiles] = (torch.arange(n, device=dev) * lanes + n_head).to(torch.int32)
    tile_count[tiles] = n_live.to(torch.int32)
    # tile b's lane b * L + m has chunk b * L / c + m // c in the flat array
    key_offset = (tiles.to(torch.int64) * n_chunks(caps, c)
                  - torch.arange(n, device=dev) * (lanes // c))
    return _TileLists(cols, tile_start, tile_count, n_eff, key_offset)


def _all_tiles(st: RasterStatics, device, tiles):
    if tiles is None:
        return torch.arange(st.tiles_x * st.tiles_y, device=device)
    return tiles


def rasterize_buckets_ref(attrs: torch.Tensor, ids: torch.Tensor,
                          bucket_starts: torch.Tensor, st: RasterStatics, caps: tuple,
                          tiles: torch.Tensor | None = None,
                          pix_ctx: torch.Tensor | None = None, seed: int = 0):
    """Plain PyTorch twin of K3: the pair twin over the merged lists.

    Returns ((n, 5, 256) f32, (n, 256) i32) for the tiles of ``tiles`` (all
    by default, in that order). Differentiable in ``attrs``. ``pix_ctx``:
    the (T, 8, 256) pixel context of gut3d; ``seed``: the stochastic
    stream's."""
    tiles = _all_tiles(st, attrs.device, tiles)
    lists = _tile_lists(attrs, bucket_starts, st, caps, tiles)
    c = lists.cols.clamp(min=0)
    return rasterize_tiles_ref(attrs[:, c], ids[c], lists.tile_start, lists.tile_count,
                               st, tiles, pix_ctx, seed, lists.key_offset)


def rasterize_buckets_bwd_ref(attrs: torch.Tensor, bucket_starts: torch.Tensor,
                              ctx: torch.Tensor, st: RasterStatics, caps: tuple,
                              tiles: torch.Tensor | None = None,
                              pix_ctx: torch.Tensor | None = None,
                              seed: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of K4: (rows, P) d_attrs.

    The pair twin backward over the merged lists (``rasterize_tiles_bwd_ref``),
    then each (tile, lane) gradient summed into its slot column, by
    differences of a float64 prefix sum over the lanes sorted by column.
    ``tiles`` restricts the sweep to a subset of tiles (all by default);
    columns only the other tiles read stay zero."""
    tiles = _all_tiles(st, attrs.device, tiles)
    lists = _tile_lists(attrs, bucket_starts, st, caps, tiles)
    d_lanes = rasterize_tiles_bwd_ref(attrs[:, lists.cols.clamp(min=0)], lists.tile_start,
                                      lists.tile_count, ctx, st, tiles, pix_ctx, seed,
                                      lists.key_offset)
    live = lists.cols >= 0
    cols, order = torch.sort(lists.cols[live], stable=True)
    p = attrs.shape[1]
    bounds = torch.searchsorted(cols, torch.arange(p + 1, device=attrs.device))
    layout = EmitLayout(p, seg_start=bounds[:-1], seg_end=bounds[1:])
    return layout.splat_sums(d_lanes[:, live][:, order])


# ---- the per-tile cull of K3 and K4 over their windows (ops/response.may_hit) ---

def _lanes_may_hit(attrs, lists: _TileLists, st: RasterStatics, tiles, pix_ctx):
    """The predicate over ``lists``' lanes, flat (n * L,), False where no
    lane lies."""
    n = tiles.shape[0]
    cols = lists.cols.view(n, -1) if n else lists.cols.view(0, 0)
    blk = unpack_rows(st.model, attrs.detach()[:, cols.clamp(min=0)])  # (rows, n, L)
    may = may_hit(blk, tile_bound(st, tiles, pix_ctx), st)
    return (may & (cols >= 0)).flatten()


@torch.no_grad()
def tile_may_hit(attrs: torch.Tensor, bucket_starts: torch.Tensor, st: RasterStatics,
                 caps: tuple, tiles: torch.Tensor | None = None,
                 pix_ctx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K3's and K4's per-tile cull (csrc/response.cuh ``may_hit``,
    term for term, with the same margins): for each lane of the tiles'
    merged lists, laid out as ``_tile_lists`` lays them (tile b's region
    of L lanes at b * L), whether the lane may hit a pixel of its tile.
    Returns (n * L,) bool, False where no lane lies; True wherever the
    model's alpha can pass its cutoffs at some pixel of the tile (and for
    NaN, inf or degenerate rows)."""
    tiles = _all_tiles(st, attrs.device, tiles)
    lists = _tile_lists(attrs, bucket_starts, st, caps, tiles)
    return _lanes_may_hit(attrs, lists, st, tiles, pix_ctx)


@torch.no_grad()
def tile_lane_hits(attrs: torch.Tensor, bucket_starts: torch.Tensor, st: RasterStatics,
                   caps: tuple, tiles: torch.Tensor | None = None,
                   pix_ctx: torch.Tensor | None = None) -> torch.Tensor:
    """Whether the model's alpha (ops/response.alpha) passes its cutoffs at
    some pixel of its tile, for each lane of ``tile_may_hit``'s layout,
    every pixel counted, frozen or not: what the cull must never drop."""
    tiles = _all_tiles(st, attrs.device, tiles)
    lists = _tile_lists(attrs, bucket_starts, st, caps, tiles)
    n, c = tiles.shape[0], st.chunk
    cols = lists.cols.view(n, -1) if n else lists.cols.view(0, 0)
    px, py = _tile_pixel_coords(tiles, st.tiles_x)
    pix = pix_ctx[tiles] if model_of(st).uses_pix else None
    hits = []
    for k in range(0, cols.shape[1], c):
        part = cols[:, k:k + c]
        block = unpack_rows(st.model, attrs.detach()[:, part.clamp(min=0)]).permute(1, 0, 2)
        hits.append((alpha(block, px, py, pix, (part >= 0)[:, None, :], st) > 0).any(dim=1))
    return torch.cat(hits, dim=1).flatten() if hits else lists.cols >= 0


class BucketWork(typing.NamedTuple):
    """What the bucket kernels' bounds count (``bucket_work``)."""

    evals: int        # (pixel, lane) alpha evaluations up to each pixel's freeze
    hits: int         # those whose alpha passes the cutoffs
    live: int         # live candidates read, summed over the tiles
    shared: int       # the live candidates of shared spans (mid, coarse, global)
    comparisons: int  # key comparisons of the merges
    tested: int       # lanes the cull (K3, K4) tests: the live lanes of the steps each tile enters
    kept: int         # the lanes of those it keeps
    kept_evals: int   # the evaluations of those lanes up to each pixel's freeze
    draws: int        # those whose alpha passes the cutoffs (before a stochastic accept)


@torch.no_grad()
def bucket_work(attrs: torch.Tensor, bucket_starts: torch.Tensor, st: RasterStatics,
                caps: tuple, tiles: torch.Tensor | None = None,
                pix_ctx: torch.Tensor | None = None, seed: int = 0) -> BucketWork:
    """The work of the given tiles (all by default): the alpha evaluations
    both kernels make and the hits (as ``rasterize.blend_work`` counts them
    over the merged lists), the live candidates, the merge's key
    comparisons, where each live lane binary-searches the five other spans
    (ceil(log2(m + 1)) steps for a span of m), and the lanes the cull of K3
    and K4 tests and keeps (``tile_may_hit``) with the kept lanes'
    evaluations. A tile enters a blend step while some pixel is not frozen
    at its start (the kernels' early exit); a stochastic ``st`` sweeps the
    stream of ``seed`` (``draws``: where the kernels hash a uniform)."""
    tiles = _all_tiles(st, attrs.device, tiles)
    lists = _tile_lists(attrs, bucket_starts, st, caps, tiles)
    evals, hits, tested, kept, kept_evals, draws = blend_work(
        attrs[:, lists.cols.clamp(min=0)], lists.tile_start, lists.tile_count, st, tiles,
        pix_ctx, keep=_lanes_may_hit(attrs, lists, st, tiles, pix_ctx), seed=seed,
        key_offset=lists.key_offset)
    steps = torch.ceil(torch.log2(lists.n_eff.double() + 1))
    others = steps.sum(dim=1, keepdim=True) - steps
    return BucketWork(evals, hits, int(lists.n_eff.sum()), int(lists.n_eff[:, 1:].sum()),
                      int((lists.n_eff * others).sum()), tested, kept, kept_evals, draws)


def _check_inputs(attrs, bucket_starts, st, caps, ids=None, ctx=None, pix_ctx=None) -> int:
    """Validate the blend inputs; returns the slot count P."""
    check_bucket_model(st)
    spec = BucketGridSpec.build(st.tiles_x, st.tiles_y)
    dev = attrs.device
    p = attrs.shape[1] if attrs.dim() == 2 else -1
    _check("attrs", attrs, torch.float32, (attr_rows(st), p), dev)
    check_pix_ctx(pix_ctx, st, dev)
    if ids is not None:
        _check("ids", ids, torch.int32, (p,), dev)
    _check("bucket_starts", bucket_starts, torch.int32, (spec.num_buckets + 1,), dev)
    if ctx is not None:
        _check("ctx", ctx, torch.float32, (st.tiles_x * st.tiles_y, CTX_ROWS, PIX), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no bucket blender for device {dev}")
    if dev.type == "cuda" and not 1 <= st.chunk <= MAX_BUCKET_CHUNK:
        raise ValueError(f"bucket chunk {st.chunk} outside [1, {MAX_BUCKET_CHUNK}]")
    return p


def _check_shared_memory(name: str, caps: tuple, st: RasterStatics) -> None:
    """Raise unless one block of kernel ``name`` for ``st.model`` fits the
    current card's shared memory at these caps (all six spans' keys and
    lane indices plus one chunk's staged lanes, whose size is the
    model's)."""
    need = _fn(name, "_smem", st)(sum(_span_sizes(caps)), st.chunk)
    limit = _fn(name, "_smem_limit", st)()
    if need > limit:
        raise ValueError(f"bucket caps {caps} with chunk {st.chunk} need {need} B of shared "
                         f"memory per {st.model} block; the card allows {limit} B")


def _bucket_fwd(attrs, ids, bucket_starts, st, caps, pix_ctx, seed):
    """K3 on CUDA tensors (one launch counted, its kept-lane count left in
    the form's ``KEPT_COUNTER``), the twin on CPU tensors."""
    caps = check_caps(caps)
    p = _check_inputs(attrs, bucket_starts, st, caps, ids=ids, pix_ctx=pix_ctx)
    dev = attrs.device
    if dev.type == "cpu":
        return rasterize_buckets_ref(attrs, ids, bucket_starts, st, caps, pix_ctx=pix_ctx,
                                     seed=seed)
    num_tiles = st.tiles_x * st.tiles_y
    spans = _span_table(st.tiles_x, st.tiles_y, dev)
    out = torch.empty((num_tiles, OUT_ROWS, PIX), dtype=torch.float32, device=dev)
    out_id = torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _check_shared_memory("raster_bucket_fwd", caps, st)
        kept = torch.zeros((1,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("raster_bucket_fwd", st=st)(
            attrs.data_ptr(), p, ids.data_ptr(), bucket_starts.data_ptr(), spans.data_ptr(),
            _ptr(pix_ctx), num_tiles, st.tiles_x, *caps, st.chunk, *model_args(st),
            st.min_transmittance, st.depth_iso, out.data_ptr(), out_id.data_ptr(),
            kept.data_ptr(), seed, stream)
    if err != 0:
        raise RuntimeError(f"raster_bucket_fwd ({form_of(st)}) launch failed: cudaError {err}")
    count_launch(rasterize_buckets, st)
    setattr(rasterize_buckets, KEPT_COUNTER[form_of(st)], kept)
    return out, out_id


def rasterize_buckets_bwd(attrs: torch.Tensor, bucket_starts: torch.Tensor,
                          ctx: torch.Tensor, st: RasterStatics, caps: tuple,
                          pix_ctx: torch.Tensor | None = None, seed: int = 0) -> torch.Tensor:
    """(rows, P) d_attrs from the (T, 5, 256) ``bwd_context``.

    CUDA tensors launch csrc/raster_bucket_bwd.cu's entry for the form of
    ``st`` and count one launch in ``rasterize_buckets_bwd.launches``
    (gs2d), ``.launches_gut3d``, their ``_stoch`` forms (``seed``: the
    forward's) or gs2d's key-row forms (``.launches_keyrow``,
    ``.launches_stoch_keyrow``: the key row gets exact zeros); CPU tensors
    run the plain twin. The kernel stores
    each fine column's gradient once; the gradients of a shared span's
    lanes go to a per-tile scratch that two more passes sum over each
    column's reading tiles in a fixed order (``_readers``). No float
    atomics: the result repeats bit for bit. The kernel sweeps only the
    lanes its per-tile cull keeps (``tile_may_hit``) and leaves in
    ``rasterize_buckets_bwd.kept`` (gs2d) or ``.kept_gut3d`` a one-element
    int32 tensor on the card: the (tile, lane) pairs it kept over the blend
    steps it entered (``BucketWork.kept``), to be read with ``int()``
    after a synchronise. A forward-only (packed) model raises
    NotImplementedError."""
    refuse_backward(st)
    caps = check_caps(caps)
    p = _check_inputs(attrs, bucket_starts, st, caps, ctx=ctx, pix_ctx=pix_ctx)
    dev = attrs.device
    if dev.type == "cpu":
        return rasterize_buckets_bwd_ref(attrs, bucket_starts, ctx, st, caps, pix_ctx=pix_ctx,
                                         seed=seed)
    spec = BucketGridSpec.build(st.tiles_x, st.tiles_y)
    num_tiles = st.tiles_x * st.tiles_y
    spans = _span_table(st.tiles_x, st.tiles_y, dev)
    readers = _readers(st.tiles_x, st.tiles_y, dev)
    n_seg = readers.seg_bucket.shape[0]
    shared_lanes = sum(_span_sizes(caps)[1:])
    grad_rows = model_of(st).grad_rows
    with torch.cuda.device(dev):
        _check_shared_memory("raster_bucket_bwd", caps, st)
        d_attrs = torch.zeros_like(attrs)  # the kernels write live columns only
        scratch = torch.empty((grad_rows, num_tiles * shared_lanes), dtype=torch.float32,
                              device=dev)
        partial = torch.empty((grad_rows, n_seg, max(caps[1:])), dtype=torch.float32,
                              device=dev)
        kept = torch.zeros((1,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("raster_bucket_bwd", st=st)(
            attrs.data_ptr(), p, bucket_starts.data_ptr(), spans.data_ptr(),
            *(x.data_ptr() for x in readers), n_seg, ctx.data_ptr(), _ptr(pix_ctx), num_tiles,
            st.tiles_x, *caps, spec.offsets[1], spec.offsets[3], st.chunk, *model_args(st),
            st.min_transmittance, scratch.data_ptr(), partial.data_ptr(), d_attrs.data_ptr(),
            kept.data_ptr(), seed, stream)
    if err != 0:
        raise RuntimeError(f"raster_bucket_bwd ({form_of(st)}) launch failed: cudaError {err}")
    count_launch(rasterize_buckets_bwd, st)
    setattr(rasterize_buckets_bwd, KEPT_COUNTER[form_of(st)], kept)
    return d_attrs


zero_counters(rasterize_buckets_bwd, TRAINED)


class _RasterizeBuckets(torch.autograd.Function):
    """The bucket blend with its backward kernel (raster_bucket.bucket_render's
    custom VJP): K3 / K4 on CUDA tensors, the twins on CPU tensors; the
    backward of a packed model raises NotImplementedError."""

    @staticmethod
    def forward(ctx, attrs, ids, bucket_starts, pix_ctx, st, caps, seed):
        out, out_id = _bucket_fwd(attrs, ids, bucket_starts, st, caps, pix_ctx, seed)
        ctx.mark_non_differentiable(out_id)
        ctx.save_for_backward(attrs, bucket_starts, pix_ctx, out)
        ctx.st, ctx.caps, ctx.seed = st, caps, seed
        return out, out_id

    @staticmethod
    def backward(ctx, g_out, g_id):
        with timing.span("backward.blend"):
            attrs, bucket_starts, pix_ctx, out = ctx.saved_tensors
            d_attrs = rasterize_buckets_bwd(attrs, bucket_starts, bwd_context(out, g_out),
                                            ctx.st, ctx.caps, pix_ctx, ctx.seed)
            return d_attrs, None, None, None, None, None, None


def rasterize_buckets(bins: BucketBins, st: RasterStatics, caps: tuple,
                      pix_ctx: torch.Tensor | None = None, seed: int = 0):
    """Blend bucketed splats into per-tile outputs.

    bins: from ops/bucket_grid.bucket_splats at the same tiles_x/y, rows of
    ``st.model``; st: the blend statics with ``chunk`` = the bucket blend
    chunk; caps: the four class caps; pix_ctx: the (T, 8, 256) pixel
    context of gut3d (None for gs2d); seed: the stochastic stream's (read
    only if ``st.stochastic``). Returns ((T, 5, 256) f32 rows r, g, b, T,
    depth; (T, 256) i32 ids), every tile written. CUDA tensors launch
    csrc/raster_bucket_fwd.cu's entry for the form of ``st`` and count one
    launch in ``rasterize_buckets.launches`` (gs2d), or the form's
    ``LAUNCH_COUNTER`` (``.launches_gut3d``, ``.launches_gs2dp``,
    ``.launches_gut3dp``, each also with ``_stoch``; ``.launches_keyrow`` and
    ``.launches_stoch_keyrow`` for gs2d's key-row form, whose bins carry
    the key row ``GS_KEY`` and were sorted by it); CPU tensors run the
    plain twin. The kernel blends only the lanes its
    per-tile cull keeps (``tile_may_hit``; the outputs are bit for bit the
    sweep over every lane) and leaves the kept count in
    ``rasterize_buckets.kept`` or the form's ``KEPT_COUNTER``, as
    ``rasterize_buckets_bwd`` does. Gradients reach ``bins.attrs`` through
    rgb and T."""
    return _RasterizeBuckets.apply(bins.attrs, bins.ids, bins.bucket_starts, pix_ctx, st, caps,
                                   int(seed))


zero_counters(rasterize_buckets)

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_MODEL = [_F, _F, _F, _F, _I]  # alpha_min, alpha_clamp, qmax, kernel_min_response, degree
_ARGTYPES = {  # the C entry points' parameters, in order (csrc/raster_bucket_*.cu)
    "raster_bucket_fwd": [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *_MODEL,
                          _F, _F, _P, _P, _P, _I, _P],
    "raster_bucket_bwd": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, *_MODEL, _F, _P, _P, _P, _P, _I, _P],
    "_smem": [_I, _I],
    "_smem_limit": [],
}


def _fn(name: str, suffix: str = "", st: RasterStatics | None = None):
    """The C function of csrc/<name>.cu for the form of ``st`` (gs2d
    without ``st``), or its ``_smem`` / ``_smem_limit`` query with
    ``suffix``."""
    symbol = (name if st is None else entry_name(name, st)) + suffix
    return _build.entry(name, symbol, _ARGTYPES[suffix or name])
