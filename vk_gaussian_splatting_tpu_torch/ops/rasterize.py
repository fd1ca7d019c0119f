"""Pair-list tile blender, forward and backward: the CUDA kernels' wrappers,
their plain PyTorch twins, the autograd Function that joins them, and
``assemble_image``.

Counterpart of ``vk_gaussian_splatting_tpu/ops/rasterize_pallas.py``: K1
(``_make_fwd_kernel``, :202-364) and K2 (``_make_bwd_kernel``, :367-483,
wrapped by ``_rt_bwd``, :599-633) for the gs2d and gut3d response models
(``RasterStatics.model``, ops/response.py), and ``assemble_image``
(:645-680). The CUDA kernels are ``csrc/rasterize_fwd.cu`` and
``csrc/rasterize_bwd.cu``, one entry point per model in each.

The gut3d model reads a per-tile pixel context ``pix_ctx``, (T, 8, 256) f32
rays (render/rays.py); it gets no gradient, as in the JAX package, where
the rays depend on the camera alone. Its attributes are 15 f32 rows,
gs2d's 10 (ops/response.py).

Per tile the output is rows ``(r, g, b, T, depth)`` over the tile's 256
pixels, ``(T, 5, 256)`` f32, plus the picked splat ids ``(T, 256)`` int32 —
the id never passes through a float. Unlike the TPU kernel, every tile is
written: an empty tile is rgb 0, T 1, depth 0, id -1.

``rasterize_tiles`` is differentiable in ``attrs`` through rgb and T; the
picked depth and id are not differentiated (as in the JAX package). On CUDA
tensors the forward launches K1 and the backward K2; on CPU tensors both
run the plain twins; nothing else decides which. A failed build or launch
raises. Each wrapper counts its launches per model: ``launches`` for gs2d,
``launches_gut3d`` for gut3d.
"""

from __future__ import annotations

import ctypes
import dataclasses
import typing

import torch

from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.ops.response import (
    ATTR_B,
    ATTR_R,
    PIX,
    PIX_ROWS,
    TILE,
    WARP_OF_PIXEL,
    WARP_PIXELS,
    WARPS,
    alpha,
    alpha_vjp,
    bound_of_warp,
    may_hit,
    model_of,
    pair_reach,
    reach_may_hit,
    tile_bound,
    warp_bound,
)

OUT_ROWS = 5       # r, g, b, T, depth
CTX_ROWS = 5       # backward context: g_r, g_g, g_b, S_total, g_T * T_final
GRAD_ROWS = ATTR_B + 1  # gs2d: rows 0-8 get gradients; the depth row gets none
MAX_CHUNK = 256    # csrc/rasterize_{fwd,bwd}.cu stage at most this many pairs
# the launch counter of each model, an attribute of each kernel's wrapper
LAUNCH_COUNTER = {"gs2d": "launches", "gut3d": "launches_gut3d"}
# the kept count of the last launch of each culling kernel (K1, K2, K3, K4),
# an attribute of its wrapper, per model
KEPT_COUNTER = {"gs2d": "kept", "gut3d": "kept_gut3d"}


@dataclasses.dataclass(frozen=True)
class RasterStatics:
    """Static blend parameters (render/pipelines.raster_statics builds them)."""

    tiles_x: int
    tiles_y: int
    chunk: int = 128             # freeze granularity: blend steps end at p % chunk == 0
    alpha_min: float = 1.0 / 255.0
    alpha_clamp: float = 0.999
    qmax: float = 8.0
    min_transmittance: float = 1e-4
    depth_iso: float = 0.7       # depth-pick transmittance threshold
    model: str = "gs2d"          # response model (ops/response.py)
    kernel_degree: int = 2       # gut3d generalized-Gaussian degree
    kernel_min_response: float = 0.0113  # gut3d response cutoff


def _tile_pixel_coords(tiles: torch.Tensor, tiles_x: int, dtype=torch.float32):
    """Pixel-center coordinates of the given tiles as (n, 256, 1) columns."""
    pix = torch.arange(PIX, device=tiles.device)
    tx = (tiles % tiles_x)[:, None]
    ty = (tiles // tiles_x)[:, None]
    px = (tx * TILE + pix % TILE).to(dtype) + 0.5
    py = (ty * TILE + pix // TILE).to(dtype) + 0.5
    return px[..., None], py[..., None]


def _tile_steps(tile_start, tile_count, tiles, c):
    """(start, end, first chunk, step count) of the given tiles' pair ranges."""
    start = tile_start[tiles].to(torch.int64)
    end = start + tile_count[tiles].to(torch.int64)
    first_block = start // c
    nsteps = torch.where(end > start, (end - 1) // c - first_block + 1, 0)
    return start, end, first_block, nsteps


class _Step(typing.NamedTuple):
    """One blend step of the twins' sweep, vectorized over tiles."""

    p: torch.Tensor          # (n, c) global pair index of each lane
    pc: torch.Tensor         # (n, c) the same, clamped to a valid column
    lane_live: torch.Tensor  # (n, c) the lane lies in its tile's [start, end)
    live: torch.Tensor       # (n, 256, c) lane live and pixel not frozen
    block: torch.Tensor      # (n, rows, c) the lanes' attribute rows
    alpha: torch.Tensor      # (n, 256, c), 0 where not live or cut off
    q: torch.Tensor          # 1 - alpha
    excl: torch.Tensor       # exclusive product of q along the lanes
    tcol: torch.Tensor       # (n, 256, 1) T at the step's start


class _Pixels(typing.NamedTuple):
    """What the alpha of the given tiles reads of their pixels."""

    px: torch.Tensor         # (n, 256, 1) pixel centers
    py: torch.Tensor
    pix: torch.Tensor | None  # (n, 8, 256) pixel context (gut3d), else None


def _chunks(attrs, tile_start, tile_count, st: RasterStatics, tiles):
    """Each blend step's pairs of the given tiles, vectorized over tiles:
    (p, pc, in_range, rows): the (n, c) global pair index of each lane, the
    same clamped to a valid column, whether it lies in its tile's [start,
    end), and the lanes' (rows, n, c) attribute rows. For tile t, step k
    covers the global chunk ``first_block[t] + k``."""
    c = st.chunk
    start, end, first_block, nsteps = _tile_steps(tile_start, tile_count, tiles, c)
    lane = torch.arange(c, device=attrs.device)
    p_max = max(attrs.shape[1] - 1, 0)
    for k in range(int(nsteps.max()) if tiles.shape[0] else 0):
        p = (first_block + k)[:, None] * c + lane                       # (n, c)
        pc = p.clamp(max=p_max)
        yield p, pc, (p >= start[:, None]) & (p < end[:, None]), attrs[:, pc]


def _blend_steps(attrs, tile_start, tile_count, st: RasterStatics, tiles, pix_ctx=None):
    """The front-to-back sweep both twins walk, one ``_Step`` per blend
    step (``_chunks``), with the TPU kernel's chunk semantics.

    A pixel is frozen for a whole step when its T at the step's start is
    <= min_transmittance. T advances after each step is yielded. Returns
    the tiles' ``_Pixels`` too."""
    n = tiles.shape[0]
    px, py = _tile_pixel_coords(tiles, st.tiles_x)
    pixels = _Pixels(px, py, pix_ctx[tiles] if model_of(st).uses_pix else None)

    def steps():
        tcol = torch.ones((n, PIX, 1), dtype=attrs.dtype, device=attrs.device)
        for p, pc, lane_live, rows in _chunks(attrs, tile_start, tile_count, st, tiles):
            live = lane_live[:, None, :] & (tcol > st.min_transmittance)
            block = rows.permute(1, 0, 2)                               # (n, R, c)
            a = alpha(block, px, py, pixels.pix, live, st)              # (n, 256, c)
            q = 1.0 - a
            incl = torch.cumprod(q, dim=-1)
            excl = torch.cat([torch.ones_like(q[..., :1]), incl[..., :-1]], dim=-1)
            yield _Step(p, pc, lane_live, live, block, a, q, excl, tcol)
            tcol = tcol * excl[..., -1:] * q[..., -1:]

    return pixels, steps()


def _all_tiles(tile_start, tiles):
    if tiles is None:
        return torch.arange(tile_start.shape[0], device=tile_start.device)
    return tiles


def rasterize_tiles_ref(attrs: torch.Tensor, ids: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        st: RasterStatics, tiles: torch.Tensor | None = None,
                        pix_ctx: torch.Tensor | None = None):
    """Plain PyTorch twin of the kernel, with the TPU kernel's chunk semantics.

    Each step of the sweep (``_blend_steps``) is an ``(n, 256, chunk)``
    alpha block of ``st.model`` with an exclusive product along the lanes.
    ``tiles`` selects a subset of tiles (all by default); the result rows
    follow it. ``pix_ctx``: the (T, 8, 256) pixel context of gut3d.
    """
    c = st.chunk
    dev = attrs.device
    depth_row = model_of(st).depth_row
    tiles = _all_tiles(tile_start, tiles)
    n = tiles.shape[0]
    lane = torch.arange(c, device=dev)
    acc = torch.zeros((n, PIX, 3), dtype=attrs.dtype, device=dev)
    tcol = torch.ones((n, PIX, 1), dtype=attrs.dtype, device=dev)
    pick_d = torch.zeros((n, PIX), dtype=attrs.dtype, device=dev)
    pick_id = torch.full((n, PIX), -1, dtype=torch.int32, device=dev)
    picked = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
    for s in _blend_steps(attrs, tile_start, tile_count, st, tiles, pix_ctx)[1]:
        w = s.alpha * s.excl * s.tcol
        acc = acc + torch.stack(
            [(w * s.block[:, ch:ch + 1, :]).sum(-1) for ch in range(ATTR_R, ATTR_B + 1)],
            dim=-1)
        # depth and id at the first lane where T drops below depth_iso
        t_after = s.tcol * s.excl * s.q
        cond = (t_after < st.depth_iso) & (s.alpha > 0.0)
        first = torch.where(cond, lane, c).amin(dim=-1)             # (n, 256)
        upd = (first < c) & ~picked
        fl = first.clamp(max=c - 1)
        d_sel = torch.gather(s.block[:, depth_row, :], 1, fl)
        id_sel = ids[torch.gather(s.pc, 1, fl)]
        pick_d = torch.where(upd, d_sel, pick_d)
        pick_id = torch.where(upd, id_sel, pick_id)
        picked = picked | upd
        tcol = s.tcol * s.excl[..., -1:] * s.q[..., -1:]
    out = torch.cat([acc.transpose(1, 2), tcol.transpose(1, 2), pick_d[:, None, :]], 1)
    return out, pick_id


@torch.no_grad()
def blend_work(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
               st: RasterStatics, tiles: torch.Tensor | None = None,
               pix_ctx: torch.Tensor | None = None,
               keep: torch.Tensor | None = None) -> tuple[int, ...]:
    """(evaluations, hits) of a frame: the (pixel, pair) alpha evaluations
    both kernels make (every pair of each step a pixel enters live), and
    those whose alpha passes the cutoffs, where the kernels do the blend
    or gradient work. What a kernel's bound counts. ``tiles`` restricts
    the count to a subset of tiles (all by default).

    ``keep``, a bool per pair (a kernel's cull), adds three counts over the
    steps a tile enters (some pixel live at the step's start): (tested,
    kept, kept evaluations), the pairs the cull tests, those it keeps, and
    the kept pairs' evaluations. A (P, WARPS) ``keep`` (K1's per-warp cull,
    ``pair_warp_may_hit``) counts the kept (warp, pair) bits instead, and
    as kept evaluations the live (pixel, pair)s whose warp keeps the pair
    (``WARP_OF_PIXEL``)."""
    evals = hits = tested = kept = kept_evals = 0
    for s in _blend_steps(attrs, tile_start, tile_count, st, _all_tiles(tile_start, tiles),
                          pix_ctx)[1]:
        evals += int(s.live.sum())
        hits += int((s.alpha > 0).sum())
        if keep is not None:
            lanes = s.lane_live & s.live.flatten(1).any(dim=1)[:, None]  # (n, c)
            tested += int(lanes.sum())
            k = keep[s.pc]                                              # (n, c[, WARPS])
            if keep.dim() == 2:
                kept += int((lanes[..., None] & k).sum())
                kept_evals += int((s.live & k[..., WARP_OF_PIXEL.to(k.device)]
                                   .transpose(1, 2)).sum())
            else:
                kept += int((lanes & k).sum())
                kept_evals += int((s.live & k[:, None, :]).sum())
    return (evals, hits) if keep is None else (evals, hits, tested, kept, kept_evals)


@torch.no_grad()
def pair_may_hit(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
                 st: RasterStatics, tiles: torch.Tensor | None = None,
                 pix_ctx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K2's per-tile cull (csrc/response.cuh ``may_hit``, term
    for term, with the same margins; ops/response.may_hit): (P,) bool,
    whether each pair may hit a pixel of the tile whose list holds it. True
    wherever the model's alpha can pass its cutoffs at some pixel of the
    tile (and for NaN, inf or degenerate rows); False for pairs outside the
    ranges of ``tiles`` (all by default)."""
    tiles = _all_tiles(tile_start, tiles)
    bound = tile_bound(st, tiles, pix_ctx)
    keep = torch.zeros(attrs.shape[1], dtype=torch.bool, device=attrs.device)
    for p, _, in_range, rows in _chunks(attrs.detach(), tile_start, tile_count, st, tiles):
        keep[p[in_range]] = may_hit(rows, bound, st)[in_range]
    return keep


@torch.no_grad()
def pair_warp_may_hit(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
                      st: RasterStatics, tiles: torch.Tensor | None = None,
                      pix_ctx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K1's per-warp cull (csrc/rasterize_fwd.cu: each pair's
    csrc/response.cuh ``reach`` against each warp's ``warp_bound``, term for
    term; ops/response.pair_reach, reach_may_hit): (P, WARPS) bool, whether
    each pair may hit a pixel of each warp of the tile whose list holds it
    (warp w's pixels ``WARP_PIXELS[w]``). True wherever the model's alpha
    can pass its cutoffs at some pixel of the warp (and for NaN, inf or
    degenerate rows); False for pairs outside the ranges of ``tiles`` (all
    by default)."""
    tiles = _all_tiles(tile_start, tiles)
    bound = warp_bound(st, tiles, pix_ctx)
    keep = torch.zeros((attrs.shape[1], WARPS), dtype=torch.bool, device=attrs.device)
    for p, _, in_range, rows in _chunks(attrs.detach(), tile_start, tile_count, st, tiles):
        reach = pair_reach(rows, st)
        m = torch.stack([reach_may_hit(reach, bound_of_warp(bound, w), st)
                         for w in range(WARPS)], dim=-1)                # (n, c, WARPS)
        keep[p[in_range]] = m[in_range]
    return keep


@torch.no_grad()
def pair_hits(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
              st: RasterStatics, tiles: torch.Tensor | None = None,
              pix_ctx: torch.Tensor | None = None, per_warp: bool = False) -> torch.Tensor:
    """(P,) bool: whether each pair's alpha (ops/response.alpha) passes the
    cutoffs at some pixel of its tile, every pixel counted, frozen or not:
    what ``pair_may_hit`` must never drop. False outside ``tiles``' ranges.
    ``per_warp``: (P, WARPS), at some pixel of each of K1's warps
    (``WARP_PIXELS``): what ``pair_warp_may_hit`` must never drop."""
    tiles = _all_tiles(tile_start, tiles)
    px, py = _tile_pixel_coords(tiles, st.tiles_x)
    pix = pix_ctx[tiles] if model_of(st).uses_pix else None
    shape = (attrs.shape[1], WARPS) if per_warp else (attrs.shape[1],)
    hits = torch.zeros(shape, dtype=torch.bool, device=attrs.device)
    for p, _, in_range, rows in _chunks(attrs.detach(), tile_start, tile_count, st, tiles):
        a = alpha(rows.permute(1, 0, 2), px, py, pix, in_range[:, None, :], st) > 0
        if per_warp:                                                    # (n, WARPS, 32, c)
            a = a[:, WARP_PIXELS.flatten().to(a.device)].unflatten(1, (WARPS, 32))
            hits[p[in_range]] = a.any(dim=2).transpose(1, 2)[in_range]
        else:
            hits[p[in_range]] = a.any(dim=1)[in_range]
    return hits


def bwd_context(out: torch.Tensor, g_out: torch.Tensor) -> torch.Tensor:
    """(T, 5, 256) per-pixel backward context from the saved forward output
    and its cotangent (rasterize_pallas._rt_bwd): g_rgb, S_total =
    sum_ch out_rgb * g_rgb, and g_T * T_final. Rows 0-3 of ``out`` are the
    blend before the background; the depth row's cotangent is dropped."""
    g_rgb = g_out[:, 0:3]
    s_total = (out[:, 0:3] * g_rgb).sum(dim=1, keepdim=True)
    gt_tn = g_out[:, 3:4] * out[:, 3:4]
    return torch.cat([g_rgb, s_total, gt_tn], dim=1).contiguous()


def rasterize_tiles_bwd_ref(attrs: torch.Tensor, tile_start: torch.Tensor,
                            tile_count: torch.Tensor, ctx: torch.Tensor,
                            st: RasterStatics, tiles: torch.Tensor | None = None,
                            pix_ctx: torch.Tensor | None = None):
    """Plain PyTorch twin of the backward kernel: (rows, P) d_attrs.

    Hand-derived, vectorized like the forward twin: the same forward-order
    sweep (``_blend_steps``) with the same per-step freeze. With T_k the
    transmittance before pair k and the suffix the colour still to come
    after it, S_total - s_incl:

        dalpha_k = T_k (g_rgb . c_k) - (suffix_k + g_T T_final) / max(1 - alpha_k, 1 - alpha_clamp)
        dcolor_k = sum_pix g_rgb w_k,   w_k = alpha_k T_k

    and the model's VJP (ops/response.alpha_vjp) takes dalpha to the
    geometry rows. Each pair lies in one tile's range, so its gradient is
    written once. The depth row and pairs no tile visits stay zero. ``tiles``
    restricts the sweep to a subset of tiles (all by default); pairs of the
    other tiles then stay zero too.
    """
    model = model_of(st)
    tiles = _all_tiles(tile_start, tiles)
    pctx = ctx[tiles]
    g_rgb = pctx[:, 0:3].transpose(1, 2)                              # (n, 256, 3)
    s_total = pctx[:, 3, :, None]
    gt_tn = pctx[:, 4, :, None]

    d_attrs = torch.zeros_like(attrs)
    s_run = torch.zeros_like(s_total)
    pixels, steps = _blend_steps(attrs, tile_start, tile_count, st, tiles, pix_ctx)
    for s in steps:
        t_k = s.excl * s.tcol
        w = s.alpha * t_k
        blk = s.block
        cg = (g_rgb[..., 0:1] * blk[:, ATTR_R:ATTR_R + 1, :]
              + g_rgb[..., 1:2] * blk[:, ATTR_R + 1:ATTR_R + 2, :]
              + g_rgb[..., 2:3] * blk[:, ATTR_B:ATTR_B + 1, :])
        wcg = w * cg
        suffix = s_total - (s_run + torch.cumsum(wcg, dim=-1))
        qsafe = torch.clamp(s.q, min=1.0 - st.alpha_clamp)
        dalpha = t_k * cg - (suffix + gt_tn) / qsafe
        d_blk = blk.new_zeros((blk.shape[0], model.grad_rows, blk.shape[2]))
        d_blk[:, list(model.geo_rows)] = alpha_vjp(blk, pixels.px, pixels.py, pixels.pix,
                                                   s.live, st, dalpha)
        d_blk[:, ATTR_R:ATTR_B + 1] = torch.stack(
            [(g_rgb[..., ch:ch + 1] * w).sum(dim=1) for ch in range(3)], dim=1)
        d_attrs[:model.grad_rows, s.p[s.lane_live]] = d_blk.permute(1, 0, 2)[:, s.lane_live]
        s_run = s_run + wcg.sum(dim=-1, keepdim=True)
    return d_attrs


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, attrs on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_pix_ctx(pix_ctx, st, device) -> None:
    """The (T, 8, 256) f32 pixel context a gut3d blend needs; none for gs2d."""
    if model_of(st).uses_pix:
        if pix_ctx is None:
            raise ValueError(f"the {st.model} model needs a pixel context")
        _check("pix_ctx", pix_ctx, torch.float32, (st.tiles_x * st.tiles_y, PIX_ROWS, PIX),
               device)
    elif pix_ctx is not None:
        raise ValueError(f"the {st.model} model takes no pixel context")


def _check_pairs(attrs, tile_start, tile_count, st, ids=None, pix_ctx=None) -> int:
    """Validate the blend inputs; returns the pair count P."""
    num_tiles = st.tiles_x * st.tiles_y
    dev = attrs.device
    p = attrs.shape[1] if attrs.dim() == 2 else -1
    _check("attrs", attrs, torch.float32, (model_of(st).rows, p), dev)
    if ids is not None:
        _check("ids", ids, torch.int32, (p,), dev)
    _check("tile_start", tile_start, torch.int32, (num_tiles,), dev)
    _check("tile_count", tile_count, torch.int32, (num_tiles,), dev)
    check_pix_ctx(pix_ctx, st, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no blender for device {dev}")
    if dev.type == "cuda" and not 1 <= st.chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {st.chunk} outside [1, {MAX_CHUNK}]")
    return p


def count_launch(wrapper, st) -> None:
    """One more launch of ``wrapper``'s kernel for ``st.model``."""
    name = LAUNCH_COUNTER[st.model]
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def model_args(st):
    """The C entry points' model arguments after the chunk: alpha_min,
    alpha_clamp, qmax, kernel_min_response, kernel_degree."""
    return (st.alpha_min, st.alpha_clamp, st.qmax, st.kernel_min_response, st.kernel_degree)


def _blend_fwd(attrs, ids, tile_start, tile_count, st, pix_ctx):
    """K1 on CUDA tensors (its cull and blend kernels, one launch counted),
    the twin on CPU tensors."""
    p = _check_pairs(attrs, tile_start, tile_count, st, ids, pix_ctx)
    dev = attrs.device
    if dev.type == "cpu":
        return rasterize_tiles_ref(attrs, ids, tile_start, tile_count, st, pix_ctx=pix_ctx)
    num_tiles = st.tiles_x * st.tiles_y
    fn = _kernel("rasterize_fwd", st)
    out = torch.empty((num_tiles, OUT_ROWS, PIX), dtype=torch.float32, device=dev)
    out_id = torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
    masks = torch.empty((p,), dtype=torch.uint8, device=dev)  # the cull's byte per pair
    with torch.cuda.device(dev):
        kept = torch.zeros((1,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(attrs.data_ptr(), p, ids.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), _ptr(pix_ctx), num_tiles, st.tiles_x, st.chunk,
                 *model_args(st), st.min_transmittance, st.depth_iso,
                 out.data_ptr(), out_id.data_ptr(), kept.data_ptr(), masks.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_fwd ({st.model}) launch failed: cudaError {err}")
    count_launch(rasterize_tiles, st)
    setattr(rasterize_tiles, KEPT_COUNTER[st.model], kept)
    return out, out_id


def rasterize_tiles_bwd(attrs: torch.Tensor, tile_start: torch.Tensor,
                        tile_count: torch.Tensor, ctx: torch.Tensor,
                        st: RasterStatics, pix_ctx: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, P) d_attrs from the (T, 5, 256) ``bwd_context``.

    CUDA tensors launch csrc/rasterize_bwd.cu's entry for ``st.model`` and
    count one launch in ``rasterize_tiles_bwd.launches`` (gs2d) or
    ``.launches_gut3d``; CPU tensors run the plain twin. The kernel writes
    each visited pair's gradient once with a plain store, in a fixed
    reduction order, so its result repeats bit for bit. Where it culls the
    model's pair lists (``Model.cull_pairs``: gs2d) it sweeps only the
    pairs its per-tile cull keeps (``pair_may_hit``). It leaves in
    ``rasterize_tiles_bwd.kept`` (gs2d) or ``.kept_gut3d`` a one-element
    int32 tensor on the card: the pairs it kept (all, where it does not
    cull) over the blend steps it entered (``blend_work``'s ``kept``, or
    ``tested``), to be read with ``int()`` after a synchronise."""
    p = _check_pairs(attrs, tile_start, tile_count, st, pix_ctx=pix_ctx)
    dev = attrs.device
    num_tiles = st.tiles_x * st.tiles_y
    _check("ctx", ctx, torch.float32, (num_tiles, CTX_ROWS, PIX), dev)
    if dev.type == "cpu":
        return rasterize_tiles_bwd_ref(attrs, tile_start, tile_count, ctx, st, pix_ctx=pix_ctx)
    fn = _kernel("rasterize_bwd", st)
    d_attrs = torch.zeros_like(attrs)  # the kernel writes visited, kept pairs only
    with torch.cuda.device(dev):
        kept = torch.zeros((1,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(attrs.data_ptr(), p, tile_start.data_ptr(), tile_count.data_ptr(),
                 ctx.data_ptr(), _ptr(pix_ctx), num_tiles, st.tiles_x, st.chunk,
                 *model_args(st), st.min_transmittance, d_attrs.data_ptr(), kept.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd ({st.model}) launch failed: cudaError {err}")
    count_launch(rasterize_tiles_bwd, st)
    setattr(rasterize_tiles_bwd, KEPT_COUNTER[st.model], kept)
    return d_attrs


rasterize_tiles_bwd.launches = rasterize_tiles_bwd.launches_gut3d = 0
rasterize_tiles_bwd.kept = rasterize_tiles_bwd.kept_gut3d = 0


class _RasterizeTiles(torch.autograd.Function):
    """The blend with its backward kernel (rasterize_pallas.rasterize_tiles'
    custom VJP): K1 / K2 on CUDA tensors, the twins on CPU tensors. The
    pixel context gets no gradient (the JAX VJP returns zeros for it)."""

    @staticmethod
    def forward(ctx, attrs, ids, tile_start, tile_count, pix_ctx, st):
        out, out_id = _blend_fwd(attrs, ids, tile_start, tile_count, st, pix_ctx)
        ctx.mark_non_differentiable(out_id)
        ctx.save_for_backward(attrs, tile_start, tile_count, pix_ctx, out)
        ctx.st = st
        return out, out_id

    @staticmethod
    def backward(ctx, g_out, g_id):
        attrs, tile_start, tile_count, pix_ctx, out = ctx.saved_tensors
        d_attrs = rasterize_tiles_bwd(attrs, tile_start, tile_count,
                                      bwd_context(out, g_out), ctx.st, pix_ctx)
        return d_attrs, None, None, None, None, None


def rasterize_tiles(attrs: torch.Tensor, ids: torch.Tensor,
                    tile_start: torch.Tensor, tile_count: torch.Tensor,
                    st: RasterStatics, pix_ctx: torch.Tensor | None = None):
    """Blend sorted pair attributes into per-tile outputs.

    attrs: (rows, P) f32 rows of ``st.model`` in (tile, depth) order; ids:
    (P,) i32; tile_start, tile_count: (T,) i32, T = tiles_x * tiles_y;
    pix_ctx: the (T, 8, 256) f32 pixel context of gut3d (None for gs2d).
    Returns ((T, 5, 256) f32 rows r, g, b, T, depth; (T, 256) i32 ids).
    CUDA tensors launch csrc/rasterize_fwd.cu's entry for the model and
    count one launch in ``rasterize_tiles.launches`` (gs2d) or
    ``.launches_gut3d``; CPU tensors run the plain twin. The kernel's warps
    skip the pairs its per-warp cull drops (``pair_warp_may_hit``), and it
    leaves in ``rasterize_tiles.kept`` (gs2d) or ``.kept_gut3d`` a
    one-element int32 tensor on the card: the kept (warp, pair) bits over
    the blend steps it entered (``blend_work``'s ``kept`` with that mask),
    to be read with ``int()`` after a synchronise. Gradients reach
    ``attrs`` through rgb and T (``rasterize_tiles_bwd``).
    """
    return _RasterizeTiles.apply(attrs, ids, tile_start, tile_count, pix_ctx, st)


rasterize_tiles.launches = rasterize_tiles.launches_gut3d = 0
rasterize_tiles.kept = rasterize_tiles.kept_gut3d = 0

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_MODEL = [_F, _F, _F, _F, _I]  # alpha_min, alpha_clamp, qmax, kernel_min_response, degree
_ARGTYPES = {  # the C entry points' parameters, in order (csrc/*.cu)
    "rasterize_fwd": [_P, _L, _P, _P, _P, _P, _I, _I, _I, *_MODEL, _F, _F, _P, _P, _P, _P, _P],
    "rasterize_bwd": [_P, _L, _P, _P, _P, _P, _I, _I, _I, *_MODEL, _F, _P, _P, _P],
}


def entry_name(name: str, st) -> str:
    """The C entry point of kernel ``name`` for ``st.model``: ``name`` for
    gs2d, ``name + "_gut3d"`` for gut3d (the same source, another
    instantiation of its model template)."""
    model_of(st)
    return name if st.model == "gs2d" else f"{name}_{st.model}"


def _kernel(name: str, st):
    return _build.entry(name, entry_name(name, st), _ARGTYPES[name])


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def rasterize_bins(bins, st: RasterStatics, pix_ctx: torch.Tensor | None = None):
    """Convenience wrapper over a TileBins (ops/binning.py)."""
    return rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start,
                           bins.tile_count, st, pix_ctx)


def assemble_image(out: torch.Tensor, out_id: torch.Tensor, tiles_x: int,
                   tiles_y: int, width: int, height: int,
                   background=(0.0, 0.0, 0.0)):
    """Per-tile outputs -> (H, W, 3) image, (H, W) transmittance, (H, W)
    picked depth and (H, W) i32 splat id. The background is blended under
    the splats as rgb + T·bg. No tile needs masking: every tile is written."""
    blocks = out.reshape(tiles_y, tiles_x, OUT_ROWS, TILE, TILE)
    full = blocks.permute(0, 3, 1, 4, 2).reshape(tiles_y * TILE, tiles_x * TILE, OUT_ROWS)
    full = full[:height, :width]
    ids = out_id.reshape(tiles_y, tiles_x, TILE, TILE).permute(0, 2, 1, 3)
    ids = ids.reshape(tiles_y * TILE, tiles_x * TILE)[:height, :width]
    trans = full[..., 3]
    bg = torch.tensor(background, dtype=torch.float32, device=out.device)
    img = full[..., 0:3] + trans[..., None] * bg
    return (img.contiguous(), trans.contiguous(), full[..., 4].detach().contiguous(),
            ids.contiguous())
