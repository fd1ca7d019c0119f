"""Visual helpers: infinite ground grid + transform gizmo overlays
(counterpart of ``vk_gaussian_splatting_tpu/render/helpers.py``; the
reference's grid_helper_vk, transform_helper_vk and visual_helpers.slang).

The reference rasterizes helper geometry into a separate GBuffer and
composites it over the scene using scene depth (VisualHelpers::render,
visual_helpers_vk.h:74-80). Here, as in the JAX package, the helpers are
evaluated analytically per pixel — elementwise tensor passes, no geometry:

- grid: camera-ray / y=0-plane intersection, adaptive 1/10/100 LOD line
  pattern with distance fade, coloured X/Z axes (grid_helper_vk.h:36-41),
  checkerboard see-through where occluded by scene depth;
- gizmo: anti-aliased distance fields to the projected axis segments
  (translate/scale) or axis rings (rotate), X=red Y=green Z=blue.

The 3x3 products are float32 multiply-adds (no matmul, no TF32 path).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.config import RenderConfig
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera

AXIS_COLORS = ((0.9, 0.2, 0.2),    # X red
               (0.2, 0.8, 0.2),    # Y green
               (0.25, 0.4, 0.95))  # Z blue


def _axis_color(ax: int, device) -> torch.Tensor:
    return torch.tensor(AXIS_COLORS[ax], dtype=torch.float32, device=device)


def _pixel_centres(cfg: RenderConfig, device):
    """(ys, xs) (H, W) float32 pixel centres."""
    ys = torch.arange(cfg.height, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(cfg.width, dtype=torch.float32, device=device) + 0.5
    return torch.meshgrid(ys, xs, indexing="ij")


def _pixel_rays(cam: Camera, cfg: RenderConfig):
    ys, xs = _pixel_centres(cfg, cam.viewmat.device)
    d_cam = torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                         torch.ones_like(xs)], -1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    r = cam.viewmat[:3, :3]
    dirs = torch.stack([d_cam[..., 0] * r[0, j] + d_cam[..., 1] * r[1, j]
                        + d_cam[..., 2] * r[2, j] for j in range(3)], -1)
    return dirs, cam.position


def _line_mask(coord: torch.Tensor, spacing, width_w: torch.Tensor) -> torch.Tensor:
    """1 on grid lines of the given spacing, anti-aliased by the world-space
    per-pixel footprint width_w (screen-constant line thickness).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    d = torch.abs(coord - torch.round(coord / spacing) * spacing)
    return torch.clamp(1.5 - d / torch.clamp(width_w, min=1e-8), 0.0, 1.0)


def _checker(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """((x // 2 + y // 2) % 2) as float32; ``//`` floors float inputs."""
    return torch.remainder(torch.div(xs, 2, rounding_mode="floor")
                           + torch.div(ys, 2, rounding_mode="floor"), 2).to(torch.float32)


def render_grid_overlay(
    image: torch.Tensor,       # (H, W, 3)
    depth: torch.Tensor,       # (H, W) scene view-z (0 = background)
    cam: Camera,
    cfg: RenderConfig,
    plane_y: float = 0.0,
    base_spacing: float = 1.0,
    opacity: float = 0.55,
    fade_distance: float = 80.0,
) -> torch.Tensor:
    """Composite the infinite X/Z grid under/over the scene."""
    dirs, origin = _pixel_rays(cam, cfg)
    dy = dirs[..., 1]
    t = (plane_y - origin[1]) / torch.where(torch.abs(dy) < 1e-8, 1e-8, dy)
    hit = t > 0
    px = origin[0] + t * dirs[..., 0]
    pz = origin[2] + t * dirs[..., 2]

    # world-space footprint of one pixel at the hit point (for constant
    # screen-space thickness, grid_helper_vk.h:37)
    foot = t / cam.fx * 1.5

    # adaptive LOD: minor lines at base, major at 10x, fade minor as the
    # footprint approaches the spacing (grid_helper_vk.h:36)
    lod = torch.clamp(torch.floor(torch.log10(torch.clamp(
        foot * 10.0 / base_spacing, min=1e-6))), min=0.0)
    s_minor = base_spacing * torch.pow(10.0, lod)
    s_major = s_minor * 10.0

    m_minor = torch.maximum(_line_mask(px, s_minor, foot), _line_mask(pz, s_minor, foot))
    m_major = torch.maximum(_line_mask(px, s_major, foot), _line_mask(pz, s_major, foot))
    line = torch.maximum(0.45 * m_minor, m_major)

    # coloured axes: the X axis lies along z=0, the Z axis along x=0
    # (X=red, Z=blue — grid_helper_vk.h:38); a spacing of 1e30 (finite in
    # float32) leaves one line at 0
    ax_x = _line_mask(pz, 1e30, foot * 1.2)   # z == 0 line
    ax_z = _line_mask(px, 1e30, foot * 1.2)   # x == 0 line
    color = torch.full(image.shape, 0.62, dtype=torch.float32, device=image.device)
    color = torch.where((ax_x > 0)[..., None],
                        _axis_color(0, image.device) * ax_x[..., None]
                        + color * (1 - ax_x[..., None]), color)
    color = torch.where((ax_z > 0)[..., None],
                        _axis_color(2, image.device) * ax_z[..., None]
                        + color * (1 - ax_z[..., None]), color)
    line = torch.maximum(line, torch.maximum(ax_x, ax_z))

    # distance fade
    fade = torch.clamp(1.0 - t / fade_distance, 0.0, 1.0)
    alpha = opacity * line * fade * hit.to(torch.float32)

    # occlusion: scene covers the grid where scene depth < grid t; occluded
    # grid shows as a sparse checkerboard (grid_helper_vk.h:40)
    ys, xs = torch.meshgrid(torch.arange(cfg.height, device=image.device),
                            torch.arange(cfg.width, device=image.device), indexing="ij")
    checker = _checker(xs, ys)
    occluded = (depth > 0) & (depth < t)
    alpha = torch.where(occluded, alpha * 0.15 * checker, alpha)

    return image * (1 - alpha[..., None]) + color * alpha[..., None]


def _segment_distance(px, py, a, b):
    """(H,W) pixel distance to the 2D segment a->b (both (2,))."""
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab), min=1e-8)
    t = torch.clamp(((px - a[0]) * ab[0] + (py - a[1]) * ab[1]) / denom, 0., 1.)
    qx = a[0] + t * ab[0]
    qy = a[1] + t * ab[1]
    return torch.sqrt((px - qx) ** 2 + (py - qy) ** 2)


def _project(cam: Camera, p: torch.Tensor):
    """(..., 3) world -> (u, v, z)."""
    r, tr = cam.viewmat[:3, :3], cam.viewmat[:3, 3]
    pc = [p[..., 0] * r[i, 0] + p[..., 1] * r[i, 1] + p[..., 2] * r[i, 2] + tr[i]
          for i in range(3)]
    z = torch.clamp(pc[2], min=1e-6)
    return (cam.fx * pc[0] / z + cam.cx, cam.fy * pc[1] / z + cam.cy, z)


def ring_angles(ring_segments: int, device) -> torch.Tensor:
    """(ring_segments + 1,) float32 angles over [0, 2 pi]: i times the
    float32 step 2 pi / n, the endpoint exact. At the default 48 segments
    (and most others) these are the values ``jnp.linspace(0, 2 * pi, 49)``
    gives on the CPU bit for bit; at some counts XLA rounds its quotient
    one ulp apart."""
    stop = np.float32(2 * math.pi)
    delta = float(stop / np.float32(ring_segments))
    theta = torch.arange(ring_segments, dtype=torch.float32, device=device) * delta
    return torch.cat([theta, torch.full((1,), float(stop), dtype=torch.float32, device=device)])


def render_gizmo_overlay(
    image: torch.Tensor,
    depth: torch.Tensor,
    cam: Camera,
    cfg: RenderConfig,
    origin,                    # (3,) gizmo anchor (selected instance origin)
    size: float = 1.0,
    mode: str = "translate",   # translate | scale | rotate
    thickness_px: float = 2.0,
    ring_segments: int = 48,
) -> torch.Tensor:
    """Composite a translate/scale axis triad or rotate rings at ``origin``
    (TransformHelperVk modes). Helpers draw on top with dithered
    see-through when occluded (visual_helpers.slang:112-121)."""
    dev = image.device
    ys, xs = _pixel_centres(cfg, dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    out = image
    checker = _checker(xs, ys)
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    for ax in range(3):
        col = _axis_color(ax, dev)
        if mode in ("translate", "scale"):
            tip = origin + size * eye[ax]
            ua, va, za = _project(cam, origin)
            ub, vb, zb = _project(cam, tip)
            dist = _segment_distance(xs, ys, torch.stack([ua, va]), torch.stack([ub, vb]))
            zmid = 0.5 * (za + zb)
            alpha = torch.clamp(1.5 - dist / thickness_px, 0.0, 1.0)
            if mode == "scale":   # cube end caps read as scale handles
                tipd = torch.sqrt((xs - ub) ** 2 + (ys - vb) ** 2)
                alpha = torch.maximum(alpha, (tipd < 3 * thickness_px).to(torch.float32))
            occ = (depth > 0) & (depth < zmid)
        else:  # rotate: ring in the plane orthogonal to the axis
            theta = ring_angles(ring_segments, dev)
            e1 = eye[(ax + 1) % 3]
            e2 = eye[(ax + 2) % 3]
            pts = origin[None] + size * (torch.cos(theta)[:, None] * e1
                                         + torch.sin(theta)[:, None] * e2)
            u, v, z = _project(cam, pts)
            dist = torch.full_like(xs, 1e30)
            for i in range(ring_segments):
                dist = torch.minimum(dist, _segment_distance(
                    xs, ys, torch.stack([u[i], v[i]]), torch.stack([u[i + 1], v[i + 1]])))
            alpha = torch.clamp(1.5 - dist / thickness_px, 0.0, 1.0)
            occ = (depth > 0) & (depth < torch.mean(z))
        alpha = torch.where(occ, alpha * 0.35 * checker, alpha)
        out = out * (1 - alpha[..., None]) + col * alpha[..., None]
    return out
