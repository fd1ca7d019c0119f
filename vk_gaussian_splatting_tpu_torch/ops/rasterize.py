"""Pair-list tile blender, forward and backward: the CUDA kernels' wrappers,
their plain PyTorch twins, the autograd Function that joins them, and
``assemble_image``.

Counterpart of ``vk_gaussian_splatting_tpu/ops/rasterize_pallas.py``: K1
(``_make_fwd_kernel``, :202-364) and K2 (``_make_bwd_kernel``, :367-483,
wrapped by ``_rt_bwd``, :599-633) for the gs2d model, and
``assemble_image`` (:645-680). The CUDA kernels are ``csrc/rasterize_fwd.cu``
and ``csrc/rasterize_bwd.cu``.

Per tile the output is rows ``(r, g, b, T, depth)`` over the tile's 256
pixels, ``(T, 5, 256)`` f32, plus the picked splat ids ``(T, 256)`` int32 —
the id never passes through a float. Unlike the TPU kernel, every tile is
written: an empty tile is rgb 0, T 1, depth 0, id -1.

``rasterize_tiles`` is differentiable in ``attrs`` through rgb and T; the
picked depth and id are not differentiated (as in the JAX package). On CUDA
tensors the forward launches K1 and the backward K2; on CPU tensors both
run the plain twins; nothing else decides which. A failed build or launch
raises.
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
    GS_DEPTH,
    GS_ROWS,
    gs2d_alpha,
    gs2d_alpha_vjp,
)

TILE = 16
PIX = TILE * TILE  # 256 pixels per tile
OUT_ROWS = 5       # r, g, b, T, depth
CTX_ROWS = 5       # backward context: g_r, g_g, g_b, S_total, g_T * T_final
GRAD_ROWS = ATTR_B + 1  # rows 0-8 get gradients; the depth row gets none
MAX_CHUNK = 256    # csrc/rasterize_{fwd,bwd}.cu stage at most this many pairs


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


def _tile_pixel_coords(tiles: torch.Tensor, tiles_x: int):
    """Pixel-center coordinates of the given tiles as (n, 256, 1) columns."""
    pix = torch.arange(PIX, device=tiles.device)
    tx = (tiles % tiles_x)[:, None]
    ty = (tiles // tiles_x)[:, None]
    px = (tx * TILE + pix % TILE).to(torch.float32) + 0.5
    py = (ty * TILE + pix // TILE).to(torch.float32) + 0.5
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
    block: torch.Tensor      # (n, GS_ROWS, c) the lanes' attribute rows
    alpha: torch.Tensor      # (n, 256, c), 0 where not live or cut off
    q: torch.Tensor          # 1 - alpha
    excl: torch.Tensor       # exclusive product of q along the lanes
    tcol: torch.Tensor       # (n, 256, 1) T at the step's start


def _blend_steps(attrs, tile_start, tile_count, st: RasterStatics, tiles):
    """The front-to-back sweep both twins walk, one ``_Step`` per blend
    step, with the TPU kernel's chunk semantics.

    For tile t, step k covers the global chunk ``first_block[t] + k``, masked
    to the tile's ``[start, end)``. A pixel is frozen for a whole step when
    its T at the step's start is <= min_transmittance. T advances after each
    step is yielded. Returns (px, py) too: the (n, 256, 1) pixel centers."""
    c = st.chunk
    start, end, first_block, nsteps = _tile_steps(tile_start, tile_count, tiles, c)
    n = tiles.shape[0]
    px, py = _tile_pixel_coords(tiles, st.tiles_x)
    lane = torch.arange(c, device=attrs.device)
    p_max = max(attrs.shape[1] - 1, 0)

    def steps():
        tcol = torch.ones((n, PIX, 1), dtype=torch.float32, device=attrs.device)
        for k in range(int(nsteps.max()) if n else 0):
            p = (first_block + k)[:, None] * c + lane                   # (n, c)
            lane_live = (p >= start[:, None]) & (p < end[:, None])
            live = lane_live[:, None, :] & (tcol > st.min_transmittance)
            pc = p.clamp(max=p_max)
            block = attrs[:, pc].permute(1, 0, 2)                       # (n, R, c)
            alpha = gs2d_alpha(block, px, py, live, st)                 # (n, 256, c)
            q = 1.0 - alpha
            incl = torch.cumprod(q, dim=-1)
            excl = torch.cat([torch.ones_like(q[..., :1]), incl[..., :-1]], dim=-1)
            yield _Step(p, pc, lane_live, live, block, alpha, q, excl, tcol)
            tcol = tcol * excl[..., -1:] * q[..., -1:]

    return px, py, steps()


def _all_tiles(tile_start, tiles):
    if tiles is None:
        return torch.arange(tile_start.shape[0], device=tile_start.device)
    return tiles


def rasterize_tiles_ref(attrs: torch.Tensor, ids: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        st: RasterStatics, tiles: torch.Tensor | None = None):
    """Plain PyTorch twin of the kernel, with the TPU kernel's chunk semantics.

    Each step of the sweep (``_blend_steps``) is an ``(n, 256, chunk)``
    alpha block with an exclusive product along the lanes. ``tiles`` selects
    a subset of tiles (all by default); the result rows follow it.
    """
    c = st.chunk
    dev = attrs.device
    tiles = _all_tiles(tile_start, tiles)
    n = tiles.shape[0]
    lane = torch.arange(c, device=dev)
    acc = torch.zeros((n, PIX, 3), dtype=torch.float32, device=dev)
    tcol = torch.ones((n, PIX, 1), dtype=torch.float32, device=dev)
    pick_d = torch.zeros((n, PIX), dtype=torch.float32, device=dev)
    pick_id = torch.full((n, PIX), -1, dtype=torch.int32, device=dev)
    picked = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
    for s in _blend_steps(attrs, tile_start, tile_count, st, tiles)[2]:
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
        d_sel = torch.gather(s.block[:, GS_DEPTH, :], 1, fl)
        id_sel = ids[torch.gather(s.pc, 1, fl)]
        pick_d = torch.where(upd, d_sel, pick_d)
        pick_id = torch.where(upd, id_sel, pick_id)
        picked = picked | upd
        tcol = s.tcol * s.excl[..., -1:] * s.q[..., -1:]
    out = torch.cat([acc.transpose(1, 2), tcol.transpose(1, 2), pick_d[:, None, :]], 1)
    return out, pick_id


@torch.no_grad()
def blend_work(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
               st: RasterStatics, tiles: torch.Tensor | None = None) -> tuple[int, int]:
    """(evaluations, hits) of a frame: the (pixel, pair) alpha evaluations
    both kernels make (every pair of each step a pixel enters live), and
    those whose alpha passes the cutoffs, where the kernels do the blend
    or gradient work. What a kernel's bound counts. ``tiles`` restricts
    the count to a subset of tiles (all by default)."""
    evals = hits = 0
    for s in _blend_steps(attrs, tile_start, tile_count, st, _all_tiles(tile_start, tiles))[2]:
        evals += int(s.live.sum())
        hits += int((s.alpha > 0).sum())
    return evals, hits


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
                            st: RasterStatics, tiles: torch.Tensor | None = None):
    """Plain PyTorch twin of the backward kernel: (GS_ROWS, P) d_attrs.

    Hand-derived, vectorized like the forward twin: the same forward-order
    sweep (``_blend_steps``) with the same per-step freeze. With T_k the
    transmittance before pair k and the suffix the colour still to come
    after it, S_total - s_incl:

        dalpha_k = T_k (g_rgb . c_k) - (suffix_k + g_T T_final) / max(1 - alpha_k, 1 - alpha_clamp)
        dcolor_k = sum_pix g_rgb w_k,   w_k = alpha_k T_k

    and the gs2d VJP (ops/response.gs2d_alpha_vjp) takes dalpha to the
    geometry rows. Each pair lies in one tile's range, so its gradient is
    written once. The depth row and pairs no tile visits stay zero. ``tiles``
    restricts the sweep to a subset of tiles (all by default); pairs of the
    other tiles then stay zero too.
    """
    tiles = _all_tiles(tile_start, tiles)
    pctx = ctx[tiles]
    g_rgb = pctx[:, 0:3].transpose(1, 2)                              # (n, 256, 3)
    s_total = pctx[:, 3, :, None]
    gt_tn = pctx[:, 4, :, None]

    d_attrs = torch.zeros_like(attrs)
    s_run = torch.zeros_like(s_total)
    px, py, steps = _blend_steps(attrs, tile_start, tile_count, st, tiles)
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
        d_geo = gs2d_alpha_vjp(blk, px, py, s.live, st, dalpha)     # (n, 6, c)
        dcol = torch.stack([(g_rgb[..., ch:ch + 1] * w).sum(dim=1) for ch in range(3)],
                           dim=1)                                   # (n, 3, c)
        d_blk = torch.cat([d_geo, dcol], dim=1).permute(1, 0, 2)    # (9, n, c)
        d_attrs[:GRAD_ROWS, s.p[s.lane_live]] = d_blk[:, s.lane_live]
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


def _check_pairs(attrs, tile_start, tile_count, st, ids=None) -> int:
    """Validate the blend inputs; returns the pair count P."""
    num_tiles = st.tiles_x * st.tiles_y
    dev = attrs.device
    p = attrs.shape[1] if attrs.dim() == 2 else -1
    _check("attrs", attrs, torch.float32, (GS_ROWS, p), dev)
    if ids is not None:
        _check("ids", ids, torch.int32, (p,), dev)
    _check("tile_start", tile_start, torch.int32, (num_tiles,), dev)
    _check("tile_count", tile_count, torch.int32, (num_tiles,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no blender for device {dev}")
    if dev.type == "cuda" and not 1 <= st.chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {st.chunk} outside [1, {MAX_CHUNK}]")
    return p


def _blend_fwd(attrs, ids, tile_start, tile_count, st):
    """K1 on CUDA tensors (one launch counted), the twin on CPU tensors."""
    p = _check_pairs(attrs, tile_start, tile_count, st, ids)
    dev = attrs.device
    if dev.type == "cpu":
        return rasterize_tiles_ref(attrs, ids, tile_start, tile_count, st)
    num_tiles = st.tiles_x * st.tiles_y
    fn = _kernel("rasterize_fwd")
    out = torch.empty((num_tiles, OUT_ROWS, PIX), dtype=torch.float32, device=dev)
    out_id = torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(attrs.data_ptr(), p, ids.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), num_tiles, st.tiles_x, st.chunk,
                 st.alpha_min, st.alpha_clamp, st.qmax, st.min_transmittance,
                 st.depth_iso, out.data_ptr(), out_id.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rasterize_fwd launch failed: cudaError {err}")
    rasterize_tiles.launches += 1
    return out, out_id


def rasterize_tiles_bwd(attrs: torch.Tensor, tile_start: torch.Tensor,
                        tile_count: torch.Tensor, ctx: torch.Tensor,
                        st: RasterStatics) -> torch.Tensor:
    """(GS_ROWS, P) d_attrs from the (T, 5, 256) ``bwd_context``.

    CUDA tensors launch csrc/rasterize_bwd.cu and count one launch in
    ``rasterize_tiles_bwd.launches``; CPU tensors run the plain twin. The
    kernel writes each visited pair's gradient once with a plain store, in
    a fixed reduction order, so its result repeats bit for bit."""
    p = _check_pairs(attrs, tile_start, tile_count, st)
    dev = attrs.device
    num_tiles = st.tiles_x * st.tiles_y
    _check("ctx", ctx, torch.float32, (num_tiles, CTX_ROWS, PIX), dev)
    if dev.type == "cpu":
        return rasterize_tiles_bwd_ref(attrs, tile_start, tile_count, ctx, st)
    fn = _kernel("rasterize_bwd")
    d_attrs = torch.zeros_like(attrs)  # the kernel writes visited pairs only
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(attrs.data_ptr(), p, tile_start.data_ptr(), tile_count.data_ptr(),
                 ctx.data_ptr(), num_tiles, st.tiles_x, st.chunk, st.alpha_min,
                 st.alpha_clamp, st.qmax, st.min_transmittance, d_attrs.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd launch failed: cudaError {err}")
    rasterize_tiles_bwd.launches += 1
    return d_attrs


rasterize_tiles_bwd.launches = 0


class _RasterizeTiles(torch.autograd.Function):
    """The blend with its backward kernel (rasterize_pallas.rasterize_tiles'
    custom VJP): K1 / K2 on CUDA tensors, the twins on CPU tensors."""

    @staticmethod
    def forward(ctx, attrs, ids, tile_start, tile_count, st):
        out, out_id = _blend_fwd(attrs, ids, tile_start, tile_count, st)
        ctx.mark_non_differentiable(out_id)
        ctx.save_for_backward(attrs, ids, tile_start, tile_count, out)
        ctx.st = st
        return out, out_id

    @staticmethod
    def backward(ctx, g_out, g_id):
        attrs, _, tile_start, tile_count, out = ctx.saved_tensors
        d_attrs = rasterize_tiles_bwd(attrs, tile_start, tile_count,
                                      bwd_context(out, g_out), ctx.st)
        return d_attrs, None, None, None, None


def rasterize_tiles(attrs: torch.Tensor, ids: torch.Tensor,
                    tile_start: torch.Tensor, tile_count: torch.Tensor,
                    st: RasterStatics):
    """Blend sorted pair attributes into per-tile outputs.

    attrs: (GS_ROWS, P) f32 gs2d rows in (tile, depth) order; ids: (P,) i32;
    tile_start, tile_count: (T,) i32, T = tiles_x * tiles_y.
    Returns ((T, 5, 256) f32 rows r, g, b, T, depth; (T, 256) i32 ids).
    CUDA tensors launch csrc/rasterize_fwd.cu and count one launch in
    ``rasterize_tiles.launches``; CPU tensors run the plain twin. Gradients
    reach ``attrs`` through rgb and T (``rasterize_tiles_bwd``).
    """
    return _RasterizeTiles.apply(attrs, ids, tile_start, tile_count, st)


rasterize_tiles.launches = 0

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # the C entry points' parameters, in order (csrc/*.cu)
    "rasterize_fwd": [_P, _L, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P],
    "rasterize_bwd": [_P, _L, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P],
}


def _kernel(name: str):
    return _build.entry(name, name, _ARGTYPES[name])


def rasterize_bins(bins, st: RasterStatics):
    """Convenience wrapper over a TileBins (ops/binning.py)."""
    return rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start,
                           bins.tile_count, st)


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
