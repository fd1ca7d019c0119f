"""Cameras (counterpart of ``vk_gaussian_splatting_tpu/scene/cameras.py``).

OpenCV-convention cameras: the view matrix maps world -> camera with +x
right, +y down, +z forward. No projection matrix is built — the tile
rasterizer works directly in pixel space with (fx, fy, cx, cy). A camera
carries what the 3DGUT and 3DGRT pipelines read besides: thin-lens depth of
field (focus distance, aperture), the OpenCV / fisheye distortion pack, and
the rolling-shutter end pose with the shutter helpers below. Whether the
sensor is pinhole or fisheye is ``RenderConfig.camera_type``. ``CameraSet``
holds the host-side presets (an active camera and a named list).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.config import ShutterType
from vk_gaussian_splatting_tpu_torch.devices import resolve_device


@dataclasses.dataclass
class Camera:
    """Camera parameters as float32 tensors on one device.

    viewmat: (4,4) world->camera, OpenCV axes.
    fx, fy, cx, cy: 0-d pixel-space intrinsics.
    near, far: 0-d clip distances (depth culling only; no projective clip).
    focus_dist, aperture: 0-d thin-lens DoF (camera_set.h dofMode/focusDist/aperture).
    distortion: (18,) OpenCV pack (threedgut_camera_models.h.slang:26-42), all
      zeros = ideal lens: [0:6] rational radial k1..k6, [6:8] tangential p1 p2,
      [8:12] thin-prism s1..s4, [12:16] fisheye theta-poly k1..k4, [16] fisheye
      max angle override (0 = auto), [17] pad.
    viewmat_end: (4,4) rolling-shutter end pose (SensorState.endPose); equals
      viewmat for a global shutter.
    """

    viewmat: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    focus_dist: torch.Tensor
    aperture: torch.Tensor
    distortion: torch.Tensor
    viewmat_end: torch.Tensor

    @property
    def position(self) -> torch.Tensor:
        """World-space camera center -Rᵀt (a full-f32 matmul while TF32 is
        off, as the JAX package's precision=HIGHEST one)."""
        r = self.viewmat[:3, :3]
        return -torch.matmul(r.T, self.viewmat[:3, 3])


def make_camera(viewmat, fx, fy, cx, cy, near=0.01, far=1e4, focus_dist=1.0,
                aperture=0.0, distortion=None, viewmat_end=None,
                device: torch.device | str | None = None) -> Camera:
    """Camera from pixel-space intrinsics, on ``device`` (default: the card).
    The JAX defaults: no DoF, an ideal lens, a global shutter. Every field
    is a copy: on the CPU no field shares memory with the caller's arrays or
    with another field (viewmat_end defaults to viewmat's values)."""
    device = resolve_device(device)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    if distortion is None:
        distortion = np.zeros((18,), np.float32)
    if viewmat_end is None:
        viewmat_end = viewmat
    return Camera(viewmat=f32(viewmat), fx=f32(fx), fy=f32(fy), cx=f32(cx),
                  cy=f32(cy), near=f32(near), far=f32(far), focus_dist=f32(focus_dist),
                  aperture=f32(aperture), distortion=f32(distortion),
                  viewmat_end=f32(viewmat_end))


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


# ---------------------------------------------------------------------------
# Rolling shutter (threedgut_sensors.h.slang + projectPointWithShutter,
# threedgut_camera_projections.h.slang:189-238): the camera pose slerps
# between viewmat (shutter start) and viewmat_end (shutter end) per pixel
# row or column scan time. Column arithmetic in the JAX package's order.
# ---------------------------------------------------------------------------


def rotmat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """(3,3) rotation -> (w, x, y, z) unit quaternion (branchless via the
    four Shepperd candidates, normalized pick of the largest)."""
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    qw = torch.sqrt(torch.clamp(1 + m00 + m11 + m22, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=0.0)) / 2

    def sign_of(a):
        return torch.sign(torch.where(a == 0, 1.0, a))

    q = torch.stack([qw, qx * sign_of(m21 - m12), qy * sign_of(m02 - m20),
                     qz * sign_of(m10 - m01)])
    return q / torch.linalg.norm(q).clamp_min(1e-12)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Slerp between (4,) quaternions at (...,) parameters -> (..., 4)."""
    d = torch.sum(q0 * q1)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(torch.clamp(d, -1.0, 1.0))
    theta = torch.arccos(d)
    sin_t = torch.sin(theta)
    use_lerp = sin_t < 1e-5
    safe = torch.where(use_lerp, 1.0, sin_t)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


def shutter_time(shutter: int, u: torch.Tensor, v: torch.Tensor,
                 width: int, height: int) -> torch.Tensor:
    """relativeShutterTime (threedgut_camera_projections.h.slang:61-76)."""
    if shutter == ShutterType.ROLLING_TOP_TO_BOTTOM:
        return torch.clamp(torch.floor(v) / (height - 1.0), 0.0, 1.0)
    if shutter == ShutterType.ROLLING_LEFT_TO_RIGHT:
        return torch.clamp(torch.floor(u) / (width - 1.0), 0.0, 1.0)
    if shutter == ShutterType.ROLLING_BOTTOM_TO_TOP:
        return torch.clamp((height - torch.ceil(v)) / (height - 1.0), 0.0, 1.0)
    if shutter == ShutterType.ROLLING_RIGHT_TO_LEFT:
        return torch.clamp((width - torch.ceil(u)) / (width - 1.0), 0.0, 1.0)
    return torch.full_like(u, 0.5)


def shutter_poses(cam: Camera):
    """((q0, t0), (q1, t1)) world->camera quaternion+translation pair for the
    shutter start/end viewmats."""
    return ((rotmat_to_quat(cam.viewmat[:3, :3]), cam.viewmat[:3, 3]),
            (rotmat_to_quat(cam.viewmat_end[:3, :3]), cam.viewmat_end[:3, 3]))


def shutter_transform_cols(cam: Camera, alpha: torch.Tensor, px, py, pz):
    """World -> camera at per-element shutter times: rotate by the slerped
    world->camera quaternion, add the lerped translation. Column inputs of
    any broadcastable shape."""
    (q0, t0), (q1, t1) = shutter_poses(cam)
    q = quat_slerp(q0, q1, alpha)                     # (..., 4)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # q * p * q^-1 expanded (rows of R(q))
    cxx = ((1 - 2 * (y * y + z * z)) * px + 2 * (x * y - w * z) * py
           + 2 * (x * z + w * y) * pz)
    cyy = (2 * (x * y + w * z) * px + (1 - 2 * (x * x + z * z)) * py
           + 2 * (y * z - w * x) * pz)
    czz = (2 * (x * z - w * y) * px + 2 * (y * z + w * x) * py
           + (1 - 2 * (x * x + y * y)) * pz)
    tt = t0 + alpha[..., None] * (t1 - t0)            # (..., 3)
    return (cxx + tt[..., 0], cyy + tt[..., 1], czz + tt[..., 2])


class CameraSet:
    """Host-side camera presets (camera_set.h:116-216): active camera + named list."""

    def __init__(self):
        self.cameras: list[Camera] = []
        self.names: list[str] = []
        self.active: int = -1

    def add(self, cam: Camera, name: str = "") -> int:
        self.cameras.append(cam)
        self.names.append(name or f"camera {len(self.cameras) - 1}")
        if self.active < 0:
            self.active = 0
        return len(self.cameras) - 1

    def get(self) -> Camera:
        return self.cameras[self.active]
