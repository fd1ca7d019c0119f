"""The 3DGS raster frame as a function of (splats, camera, config).

Counterpart of ``vk_gaussian_splatting_tpu/render/pipelines.py`` for the
VERT/MESH pipelines with ``method="pairs"``: project -> bin (pair expansion +
one (tile, depth) sort, ops/binning.py) -> tile blend (ops/rasterize.py, the
CUDA kernel on a card) -> assemble, matching the dist+sort+raster stages of
gaussian_splatting.cpp:1298-1464. Configurations this port does not run yet
raise ``NotImplementedError`` naming their ROADMAP.md item; none of them
quietly takes another path.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch.config import (
    CameraType,
    Pipeline,
    RenderConfig,
    StochasticMode,
    tiles_x,
    tiles_y,
)
from vk_gaussian_splatting_tpu_torch.ops.binning import TileBins, bin_splats
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats, project_splats
from vk_gaussian_splatting_tpu_torch.ops.rasterize import (
    RasterStatics,
    assemble_image,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera
from vk_gaussian_splatting_tpu_torch.scene.splat_set import PreparedSplats


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor          # (H, W, 3)
    transmittance: torch.Tensor  # (H, W)
    depth: torch.Tensor          # (H, W) picked depth at T < depth_iso (0 = none)
    splat_id: torch.Tensor       # (H, W) i32 picked splat id (-1 = none)
    num_pairs: torch.Tensor      # () live pairs
    overflow: torch.Tensor       # () bool — slot/pair budget truncated coverage


def gs_attr_rows(proj: ProjectedSplats):
    """Per-splat gs2d attribute rows (ops/response.py) and splat ids.

    Returns ((10, N) f32 rows, (N,) i32 ids). The ids are int32, exact for
    every id below 2^31, where the JAX layout carries two f32 rows."""
    n = proj.xy.shape[0]
    if n > 1 << 31:
        raise ValueError(f"{n} splat ids exceed int32")
    rows = torch.stack([
        proj.xy[:, 0], proj.xy[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.alpha,
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        proj.depth,
    ], dim=0)
    ids = torch.arange(n, dtype=torch.int32, device=proj.xy.device)
    return rows, ids


def raster_statics(cfg: RenderConfig) -> RasterStatics:
    return RasterStatics(
        tiles_x=tiles_x(cfg),
        tiles_y=tiles_y(cfg),
        chunk=cfg.raster.chunk,
        alpha_min=cfg.raster.alpha_min,
        alpha_clamp=cfg.raster.alpha_clamp,
        qmax=cfg.raster.alpha_cull_qmax,
        depth_iso=cfg.raster.depth_iso_threshold,
    )


def bin_for_cfg(proj: ProjectedSplats, rows: torch.Tensor, ids: torch.Tensor,
                cfg: RenderConfig, max_pairs: int) -> TileBins:
    exact = cfg.raster.expansion == "exact"
    return bin_splats(
        proj, rows, ids,
        tile_size=cfg.raster.tile_size,
        tiles_x=tiles_x(cfg), tiles_y=tiles_y(cfg),
        chunk=cfg.raster.chunk,
        slots_k=cfg.raster.slots_k,
        max_pairs=max_pairs if exact else 0,
        expansion=cfg.raster.expansion,
    )


def _reject_unported(cfg: RenderConfig, host_order) -> None:
    rc = cfg.raster
    pipeline_item = {Pipeline.MESH_3DGUT: "3DGUT", Pipeline.RTX: "3DGRT"}.get(
        cfg.pipeline, "lighting and shadows")
    unported = [
        (cfg.pipeline not in (Pipeline.VERT, Pipeline.MESH),
         f"pipeline {cfg.pipeline.name}", pipeline_item),
        (rc.method == "bucket", "raster.method='bucket'", "bucket path"),
        (host_order is not None, "host_order", "remaining IO (AsyncHostSorter)"),
        (cfg.stochastic != StochasticMode.NONE, f"stochastic={cfg.stochastic.name}",
         "stochastic and post"),
        (cfg.temporal_samples > 1, "temporal_samples > 1", "stochastic and post"),
        (rc.pair_format == "packed", "raster.pair_format='packed'", "packed tier"),
        (cfg.denoise == "atrous", "denoise='atrous'", "stochastic and post"),
        (cfg.camera_type == CameraType.FISHEYE, "camera_type=FISHEYE", "3DGUT"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md queue 1: {item})")
    if rc.method != "pairs":
        raise ValueError(f"unknown raster.method {rc.method!r}")
    if rc.pair_format != "f32":
        raise ValueError(f"unknown raster.pair_format {rc.pair_format!r}")


def render_3dgs(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                max_pairs: int = 0, host_order: torch.Tensor | None = None) -> RenderOutput:
    """3DGS raster pipeline (PIPELINE_VERT / PIPELINE_MESH), forward.

    max_pairs: pair budget of ``raster.expansion="exact"``."""
    if cfg.raster.tile_size != 16:
        raise ValueError("the tile blender requires tile_size == 16")
    _reject_unported(cfg, host_order)
    proj = project_splats(prepared, cam, cfg)
    rows, ids = gs_attr_rows(proj)
    bins = bin_for_cfg(proj, rows, ids, cfg, max_pairs)
    st = raster_statics(cfg)
    out, out_id = rasterize_bins(bins, st)
    img, trans, depth, splat_id = assemble_image(
        out, out_id, st.tiles_x, st.tiles_y, cfg.width, cfg.height, cfg.background)
    return RenderOutput(image=img, transmittance=trans, depth=depth,
                        splat_id=splat_id, num_pairs=bins.num_pairs,
                        overflow=bins.overflow)


def render(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
           max_pairs: int = 0, **kw) -> RenderOutput:
    """Pipeline dispatch (shaderio.h:61-66 pipeline ids). Only VERT and MESH
    are ported; render_3dgs rejects the others with NotImplementedError."""
    return render_3dgs(prepared, cam, cfg, max_pairs, **kw)
