"""Pair-list tile blender, forward: the CUDA kernel's wrapper, its plain
PyTorch twin, and ``assemble_image``.

Counterpart of ``vk_gaussian_splatting_tpu/ops/rasterize_pallas.py``: K1
(``_make_fwd_kernel``, :202-364) for the gs2d model, and ``assemble_image``
(:645-680). The CUDA kernel is ``csrc/rasterize_fwd.cu``.

Per tile the output is rows ``(r, g, b, T, depth)`` over the tile's 256
pixels, ``(T, 5, 256)`` f32, plus the picked splat ids ``(T, 256)`` int32 —
the id never passes through a float. Unlike the TPU kernel, every tile is
written: an empty tile is rgb 0, T 1, depth 0, id -1.

``rasterize_tiles`` launches the kernel for CUDA tensors and runs the twin
for CPU tensors; nothing else decides which. A failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.ops.response import (
    ATTR_B,
    ATTR_R,
    GS_DEPTH,
    GS_ROWS,
    gs2d_alpha,
)

TILE = 16
PIX = TILE * TILE  # 256 pixels per tile
OUT_ROWS = 5       # r, g, b, T, depth
MAX_CHUNK = 256    # csrc/rasterize_fwd.cu stages at most this many pairs


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


def rasterize_tiles_ref(attrs: torch.Tensor, ids: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        st: RasterStatics, tiles: torch.Tensor | None = None):
    """Plain PyTorch twin of the kernel, with the TPU kernel's chunk semantics.

    For tile t, step k covers the global chunk ``first_block[t] + k``, masked
    to the tile's ``[start, end)``; the steps are vectorized over tiles as an
    ``(n, 256, chunk)`` alpha block with an exclusive product along the
    lanes. A pixel is frozen for a whole step when its T at the step's start
    is <= min_transmittance. ``tiles`` selects a subset of tiles (all by
    default); the result rows follow it.
    """
    c = st.chunk
    dev = attrs.device
    if tiles is None:
        tiles = torch.arange(tile_start.shape[0], device=dev)
    start = tile_start[tiles].to(torch.int64)
    end = start + tile_count[tiles].to(torch.int64)
    first_block = start // c
    nsteps = torch.where(end > start, (end - 1) // c - first_block + 1, 0)
    n = tiles.shape[0]
    px, py = _tile_pixel_coords(tiles, st.tiles_x)
    lane = torch.arange(c, device=dev)

    acc = torch.zeros((n, PIX, 3), dtype=torch.float32, device=dev)
    tcol = torch.ones((n, PIX, 1), dtype=torch.float32, device=dev)
    pick_d = torch.zeros((n, PIX), dtype=torch.float32, device=dev)
    pick_id = torch.full((n, PIX), -1, dtype=torch.int32, device=dev)
    picked = torch.zeros((n, PIX), dtype=torch.bool, device=dev)
    p_max = max(attrs.shape[1] - 1, 0)
    for k in range(int(nsteps.max()) if n else 0):
        p = (first_block + k)[:, None] * c + lane                   # (n, c)
        live = ((p >= start[:, None]) & (p < end[:, None]))[:, None, :]
        pc = p.clamp(max=p_max)
        block = attrs[:, pc].permute(1, 0, 2)                       # (n, R, c)
        alpha = gs2d_alpha(block, px, py, live, st)                 # (n, 256, c)
        alpha = torch.where(tcol > st.min_transmittance, alpha, 0.0)
        q = 1.0 - alpha
        incl = torch.cumprod(q, dim=-1)
        excl = torch.cat([torch.ones_like(q[..., :1]), incl[..., :-1]], dim=-1)
        w = alpha * excl * tcol
        acc = acc + torch.stack(
            [(w * block[:, ch:ch + 1, :]).sum(-1) for ch in range(ATTR_R, ATTR_B + 1)],
            dim=-1)
        # depth and id at the first lane where T drops below depth_iso
        t_after = tcol * excl * q
        cond = (t_after < st.depth_iso) & (alpha > 0.0)
        first = torch.where(cond, lane, c).amin(dim=-1)             # (n, 256)
        upd = (first < c) & ~picked
        fl = first.clamp(max=c - 1)
        d_sel = torch.gather(block[:, GS_DEPTH, :], 1, fl)
        id_sel = ids[torch.gather(pc, 1, fl)]
        pick_d = torch.where(upd, d_sel, pick_d)
        pick_id = torch.where(upd, id_sel, pick_id)
        picked = picked | upd
        tcol = tcol * excl[..., -1:] * q[..., -1:]
    out = torch.cat([acc.transpose(1, 2), tcol.transpose(1, 2), pick_d[:, None, :]], 1)
    return out, pick_id


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, attrs on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rasterize_tiles(attrs: torch.Tensor, ids: torch.Tensor,
                    tile_start: torch.Tensor, tile_count: torch.Tensor,
                    st: RasterStatics):
    """Blend sorted pair attributes into per-tile outputs.

    attrs: (GS_ROWS, P) f32 gs2d rows in (tile, depth) order; ids: (P,) i32;
    tile_start, tile_count: (T,) i32, T = tiles_x * tiles_y.
    Returns ((T, 5, 256) f32 rows r, g, b, T, depth; (T, 256) i32 ids).
    CUDA tensors launch csrc/rasterize_fwd.cu and count one launch in
    ``rasterize_tiles.launches``; CPU tensors run the plain twin.
    """
    num_tiles = st.tiles_x * st.tiles_y
    dev = attrs.device
    p = attrs.shape[1] if attrs.dim() == 2 else -1
    _check("attrs", attrs, torch.float32, (GS_ROWS, p), dev)
    _check("ids", ids, torch.int32, (p,), dev)
    _check("tile_start", tile_start, torch.int32, (num_tiles,), dev)
    _check("tile_count", tile_count, torch.int32, (num_tiles,), dev)
    if dev.type == "cpu":
        return rasterize_tiles_ref(attrs, ids, tile_start, tile_count, st)
    if dev.type != "cuda":
        raise ValueError(f"no blender for device {dev}")
    if not 1 <= st.chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {st.chunk} outside [1, {MAX_CHUNK}]")
    fn = _kernel()
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


rasterize_tiles.launches = 0


def _kernel():
    fn = _build.load("rasterize_fwd").rasterize_fwd
    c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fn.argtypes = [c_ptr, ctypes.c_longlong, c_ptr, c_ptr, c_ptr, c_int, c_int,
                   c_int, c_float, c_float, c_float, c_float, c_float, c_ptr,
                   c_ptr, c_ptr]
    fn.restype = c_int
    return fn


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
    return img.contiguous(), trans.contiguous(), full[..., 4].contiguous(), ids.contiguous()
