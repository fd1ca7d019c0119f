"""Pinhole cameras (counterpart of ``vk_gaussian_splatting_tpu/scene/cameras.py:24-125``).

OpenCV-convention cameras: the view matrix maps world -> camera with +x
right, +y down, +z forward. No projection matrix is built — the tile
rasterizer works directly in pixel space with (fx, fy, cx, cy). The
fisheye, depth-of-field and rolling-shutter helpers are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device


@dataclasses.dataclass
class Camera:
    """Camera parameters as float32 tensors on one device.

    viewmat: (4,4) world->camera, OpenCV axes.
    fx, fy, cx, cy: 0-d pixel-space intrinsics.
    near, far: 0-d clip distances (depth culling only; no projective clip).
    """

    viewmat: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor

    @property
    def position(self) -> torch.Tensor:
        """World-space camera center -Rᵀt (a full-f32 matmul while TF32 is
        off, as the JAX package's precision=HIGHEST one)."""
        r = self.viewmat[:3, :3]
        return -torch.matmul(r.T, self.viewmat[:3, 3])


def make_camera(viewmat, fx, fy, cx, cy, near=0.01, far=1e4,
                device: torch.device | str | None = None) -> Camera:
    """Camera from pixel-space intrinsics, on ``device`` (default: the card)."""
    device = resolve_device(device)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return Camera(viewmat=f32(viewmat), fx=f32(fx), fy=f32(fy), cx=f32(cx),
                  cy=f32(cy), near=f32(near), far=f32(far))


def look_at(eye, center, up, width: int, height: int, fov_y_rad: float = 0.8,
            near: float = 0.01, far: float = 1e4,
            device: torch.device | str | None = None) -> Camera:
    """Build a pinhole camera looking from eye at center (OpenCV axes: y down).

    Float64 numpy up to the final cast, exactly as the JAX package does.
    On ``device``, by default the card."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)  # y-down completes right-handed (x, y, z)=(right, down, fwd)
    r = np.stack([right, down, fwd], axis=0)  # world->camera rotation rows
    t = -r @ eye
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = r
    viewmat[:3, 3] = t
    fy = 0.5 * height / np.tan(0.5 * fov_y_rad)
    return make_camera(viewmat, fy, fy, width * 0.5, height * 0.5, near, far,
                       device=device)


def view_transform_points(viewmat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(N,3) world points -> camera space via the (4,4) viewmat.

    A matmul, as in the JAX package (whose precision=HIGHEST dot rounds like
    torch's f32 one). It must stay full f32: TF32 shifts projected
    positions visibly, so ``torch.backends.cuda.matmul.allow_tf32`` stays
    False (its default) wherever this runs on a card."""
    return torch.matmul(points, viewmat[:3, :3].T) + viewmat[:3, 3]
