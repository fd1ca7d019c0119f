"""Per-pixel debug traces (counterpart of ``vk_gaussian_splatting_tpu/debug.py``;
the reference's shader feedback).

The reference instruments the integrator with a 200-entry per-pixel trace
(hit distance, alpha, transmittance, integrated radiance —
shaderio.h:332-399, rgen:128-150) read back for plotting. Here, as in the
JAX package, the same quantities are evaluated for one pixel analytically
from the projected splats: a numeric oracle for any pixel without touching
the kernels. The per-splat test runs on the splats' device; only the
pixel's contributors (at most ``max_entries``) go to the host, where the
transmittance and radiance sums are numpy, in the JAX package's operations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.config import CameraType, RenderConfig
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu_torch.ops.raytrace import (
    FRAME_RGB,
    _chunk_alpha_t,
    _splat_frames,
    _splat_rows,
    splat_view_colors,
)
from vk_gaussian_splatting_tpu_torch.scene.cameras import view_transform_points


@dataclasses.dataclass
class PixelTrace:
    """Sorted per-splat contributions at one pixel."""

    splat_id: np.ndarray       # (K,)
    depth: np.ndarray          # (K,)
    alpha: np.ndarray          # (K,)
    transmittance: np.ndarray  # (K,) T before each splat
    weight: np.ndarray         # (K,) alpha * T
    radiance: np.ndarray       # (K,3) cumulative integrated radiance
    final_color: np.ndarray    # (3,)
    final_transmittance: float


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _compose(ids: np.ndarray, depth: np.ndarray, alpha: np.ndarray,
             colors: np.ndarray) -> PixelTrace:
    """The front-to-back sums over the pixel's sorted contributors (numpy,
    the JAX package's dtypes: T and the radiance in float64 from float32
    alphas)."""
    t = np.concatenate([[1.0], np.cumprod(1.0 - alpha)[:-1]])
    w = alpha * t
    radiance = np.cumsum(w[:, None] * colors, axis=0)
    return PixelTrace(
        splat_id=ids,
        depth=depth,
        alpha=alpha,
        transmittance=t,
        weight=w,
        radiance=radiance,
        final_color=radiance[-1] if len(ids) else np.zeros(3),
        final_transmittance=float(np.prod(1.0 - alpha)) if len(ids) else 1.0,
    )


def pixel_trace(proj: ProjectedSplats, x: int, y: int,
                cfg: RenderConfig, max_entries: int = 200) -> PixelTrace:
    """Contribution trace for pixel (x, y) under the gs2d model: the splats
    whose conic response at the pixel centre passes the blend's cutoffs, in
    depth order (stable), at most ``max_entries``. The blend's freeze at
    T < min_transmittance is not modelled."""
    rc = cfg.raster
    px, py = x + 0.5, y + 0.5
    dx = px - proj.xy[:, 0]
    dy = py - proj.xy[:, 1]
    conic = proj.conic
    d = conic[:, 0] * dx * dx + 2 * conic[:, 1] * dx * dy + conic[:, 2] * dy * dy
    g = torch.exp(-0.5 * d)
    a_raw = proj.alpha * g
    mask = (d <= rc.alpha_cull_qmax) & (a_raw >= rc.alpha_min) & proj.valid
    ids = torch.nonzero(mask).flatten()
    order = torch.argsort(proj.depth[ids], stable=True)
    ids = ids[order][:max_entries]
    alpha = np.minimum(_host(a_raw[ids]), np.float32(rc.alpha_clamp))
    return _compose(_host(ids), _host(proj.depth[ids]), alpha, _host(proj.color[ids]))


def format_trace(trace: PixelTrace, limit: int = 20) -> str:
    """Human-readable dump (the ShaderFeedbackUI table analog)."""
    lines = [f"{'#':>4} {'splat':>8} {'depth':>9} {'alpha':>7} {'T':>7} "
             f"{'weight':>7}"]
    for i in range(min(len(trace.splat_id), limit)):
        lines.append(
            f"{i:>4} {trace.splat_id[i]:>8} {trace.depth[i]:>9.4f} "
            f"{trace.alpha[i]:>7.4f} {trace.transmittance[i]:>7.4f} "
            f"{trace.weight[i]:>7.4f}")
    lines.append(f"final color {trace.final_color}, "
                 f"T {trace.final_transmittance:.5f}, "
                 f"{len(trace.splat_id)} contributors")
    return "\n".join(lines)


def _pixel_ray(cam, x: int, y: int, cfg: RenderConfig):
    """World-space ray through the pixel centre (pinhole or equidistant
    fisheye — cameras.h.slang:27-105): (origin float32 (3,), direction
    float64 (3,)) numpy."""
    px, py = x + 0.5, y + 0.5
    u = (px - float(cam.cx)) / float(cam.fx)
    v = (py - float(cam.cy)) / float(cam.fy)
    if cfg.camera_type == CameraType.FISHEYE:
        r = np.sqrt(u * u + v * v)
        theta = r  # equidistant: angle proportional to radius
        s = np.sin(theta) / max(r, 1e-12)
        d_cam = np.asarray([u * s, v * s, np.cos(theta)])
    else:
        d_cam = np.asarray([u, v, 1.0])
    d_cam = d_cam / np.linalg.norm(d_cam)
    rot = _host(cam.viewmat)[:3, :3]
    origin = _host(cam.position)
    return origin, rot.T @ d_cam


def pixel_trace_gut(prepared, cam, x: int, y: int, cfg: RenderConfig,
                    order: str = "depth", max_entries: int = 200) -> PixelTrace:
    """Contribution trace for pixel (x, y) under the exact 3D ray response:
    the gut3d (order="depth": the view-depth blend order of the 3DGUT
    raster) and 3DGRT (order="radial": distance from the camera) oracle.
    Evaluates particleProcessHit along the pixel's camera ray
    (threedgrt.h.slang:57-223) by the tracer's ``_chunk_alpha_t`` over the
    ``_splat_frames`` of every splat (scaled by cfg.splat_scale; no degree-0
    response floor)."""
    dev = prepared.means.device
    origin, direction = _pixel_ray(cam, x, y, cfg)
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dev)
    d = torch.as_tensor(np.asarray(direction, np.float32), device=dev)
    colors, opac = splat_view_colors(prepared, o, cfg)
    n = prepared.num_splats
    ids0 = torch.arange(n, dtype=torch.float32, device=dev)
    frames = _splat_frames(_splat_rows(prepared, colors, opac, ids0), cfg.splat_scale)
    alpha, t_hit = _chunk_alpha_t(frames, o[None], d[None], cfg.rt.kernel_degree,
                                  cfg.rt.alpha_min, cfg.rt.alpha_clamp)
    alpha, t_hit = alpha[0], t_hit[0]

    if order == "radial":
        key = torch.linalg.norm(prepared.means - o, dim=-1)
    else:
        key = view_transform_points(cam.viewmat, prepared.means)[:, 2]
    ids = torch.nonzero((alpha > 0.0) & (t_hit > 0.0)).flatten()
    ids = ids[torch.argsort(key[ids], stable=True)][:max_entries]
    cols = frames[FRAME_RGB:FRAME_RGB + 3][:, ids].T
    return _compose(_host(ids), _host(t_hit[ids]), _host(alpha[ids]), _host(cols))
