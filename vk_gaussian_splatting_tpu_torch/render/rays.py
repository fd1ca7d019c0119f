"""Per-pixel camera rays packed into per-tile blocks for the gut3d blender
(counterpart of ``vk_gaussian_splatting_tpu/render/rays.py:24-116``).

Re-expresses the fragment-shader ray generation of
threedgut_raster.frag.slang:92-109 (generatePinholeRay / generateFisheyeRay +
thin-lens depthOfField, cameras.h.slang:27-105) as one vectorized pass over
the padded tile grid, emitting the (T, 8, 256) pixel context the tile
blenders read per tile (rows RAY_* of ops/response.py; rows 6-7 zero).

Thin-lens DoF draws two uniforms per pixel. The JAX package draws them from
``jax.random`` keyed on the frame's sample id; torch cannot reproduce that
stream bit for bit, so here they come from a ``torch.Generator`` seeded
from the sample id (``DOF_SEED + sample_id``): a sample's rays are
reproducible in the port but not equal to the JAX package's. The lens
itself, ``_thin_lens``, takes the uniforms as inputs, so the tests feed it
the JAX samples and hold it to the JAX lens exactly.
"""

from __future__ import annotations

import math

import torch

from vk_gaussian_splatting_tpu_torch.config import (
    CameraType,
    RenderConfig,
    ShutterType,
    tiles_x,
    tiles_y,
)
from vk_gaussian_splatting_tpu_torch.ops.projection import fisheye_max_angle
from vk_gaussian_splatting_tpu_torch.ops.rasterize import PIX, TILE
from vk_gaussian_splatting_tpu_torch.ops.response import PIX_ROWS
from vk_gaussian_splatting_tpu_torch.scene.cameras import (
    Camera,
    quat_slerp,
    shutter_poses,
    shutter_time,
)

DOF_SEED = 0x3D6F  # the JAX package's key for the lens samples


def _thin_lens(dirs: torch.Tensor, origin: torch.Tensor, r1: torch.Tensor,
               r2: torch.Tensor, cam: Camera):
    """Thin-lens perturbation (cameras.h.slang:85-105) of (H, W, 3) unit
    directions and origins, with (H, W) uniforms r1, r2 in [0, 1): a lens
    point at angle 2 pi r1 and radius sqrt(r2 aperture) on the start pose's
    right/up plane, aimed through the focal point at focus_dist."""
    r_wc = cam.viewmat[:3, :3].T
    a = r1 * (2.0 * math.pi)
    rad = r2 * cam.aperture
    lens = (torch.cos(a)[..., None] * r_wc[:, 0]
            + torch.sin(a)[..., None] * r_wc[:, 1]) * torch.sqrt(rad)[..., None]
    new_dir = dirs * cam.focus_dist - lens
    new_dir = new_dir / torch.linalg.norm(new_dir, dim=-1, keepdim=True)
    return new_dir, origin + lens


def build_tile_rays(cam: Camera, cfg: RenderConfig, sample_id: int = 0) -> torch.Tensor:
    """(T, 8, 256): rows 0-2 unit ray direction, 3-5 ray origin (world/model
    space). Pinhole or fisheye per ``cfg.camera_type`` (a fisheye pixel
    outside the FOV cone gets a degenerate backward ray that hits nothing),
    each pixel at its own scan time's pose under a rolling shutter, and
    thin-lens DoF where ``cam.aperture > 0``: the lens samples are drawn
    every call and kept by a select, so no host sync decides it."""
    tx, ty = tiles_x(cfg), tiles_y(cfg)
    w_pad, h_pad = tx * TILE, ty * TILE
    dev = cam.viewmat.device
    ys, xs = torch.meshgrid(torch.arange(h_pad, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(w_pad, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    if cfg.camera_type == CameraType.PINHOLE:
        d_cam = torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                             torch.ones_like(xs)], -1)
        d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    else:
        # inverse equidistant fisheye: theta = r / f
        mx = (xs - cam.cx) / cam.fx
        my = (ys - cam.cy) / cam.fy
        theta = torch.sqrt(mx * mx + my * my)
        max_angle = fisheye_max_angle(cfg.width, cfg.height, cam.cx, cam.cy, cam.fx, cam.fy)
        safe = torch.clamp(theta, min=1e-8)
        sin_t = torch.sin(theta)
        d_cam = torch.stack([sin_t * mx / safe, sin_t * my / safe, torch.cos(theta)], -1)
        back = torch.tensor([0.0, 0.0, -1.0], device=dev)
        d_cam = torch.where((theta < max_angle)[..., None], d_cam, back)

    if cfg.shutter == ShutterType.GLOBAL:
        r_wc = cam.viewmat[:3, :3].T
        dirs = torch.matmul(d_cam, r_wc.T)                           # (H,W,3)
        origin = cam.position.expand(dirs.shape)
    else:
        # rolling shutter: each pixel's ray uses the pose at its exact scan
        # time (the per-pixel analog of projectPointWithShutter)
        t = shutter_time(cfg.shutter, xs, ys, cfg.width, cfg.height)
        (q0, t0), (q1, t1) = shutter_poses(cam)
        q = quat_slerp(q0, q1, t)                                    # (H,W,4)
        # world vectors via the conjugate (camera->world) rotation
        w, x, y, z = -q[..., 0], q[..., 1], q[..., 2], q[..., 3]

        def rot(vx, vy, vz):
            ox = ((1 - 2 * (y * y + z * z)) * vx + 2 * (x * y - w * z) * vy
                  + 2 * (x * z + w * y) * vz)
            oy = (2 * (x * y + w * z) * vx + (1 - 2 * (x * x + z * z)) * vy
                  + 2 * (y * z - w * x) * vz)
            oz = (2 * (x * z - w * y) * vx + 2 * (y * z + w * x) * vy
                  + (1 - 2 * (x * x + y * y)) * vz)
            return ox, oy, oz

        dirs = torch.stack(rot(d_cam[..., 0], d_cam[..., 1], d_cam[..., 2]), -1)
        tt = t0 + t[..., None] * (t1 - t0)                           # (H,W,3)
        origin = -torch.stack(rot(tt[..., 0], tt[..., 1], tt[..., 2]), -1)

    gen = torch.Generator(device=dev).manual_seed(DOF_SEED + int(sample_id))
    r1 = torch.rand((h_pad, w_pad), generator=gen, device=dev)
    r2 = torch.rand((h_pad, w_pad), generator=gen, device=dev)
    lens_dirs, lens_origin = _thin_lens(dirs, origin, r1, r2, cam)
    dof = cam.aperture > 0.0
    dirs = torch.where(dof, lens_dirs, dirs)
    origin = torch.where(dof, lens_origin, origin)

    # pack (H,W,3)+(H,W,3) -> (T, 8, 256)
    full = torch.cat([dirs, origin, dirs.new_zeros((h_pad, w_pad, PIX_ROWS - 6))], dim=-1)
    blocks = full.reshape(ty, TILE, tx, TILE, PIX_ROWS)
    return blocks.permute(0, 2, 4, 1, 3).reshape(ty * tx, PIX_ROWS, PIX).contiguous()
