"""Camera paths of the traffic mixes, as plain numbers.

A pose is made on the host in float64 and rounded once to float32; the
program gets it through its own ``make_camera`` and the reference reads the
same numbers, so both sides see one camera. OpenCV axes: the view matrix
maps world to camera with +x right, +y down, +z forward.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pose:
    viewmat: np.ndarray   # (4, 4) float32 world -> camera
    fx: float
    fy: float
    cx: float
    cy: float
    near: float
    far: float
    width: int
    height: int


def look_at(eye, center, width: int, height: int, fov_y: float, near: float,
            far: float) -> Pose:
    """A pinhole pose at ``eye`` looking at ``center``, world +y as up."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(center, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = rot
    viewmat[:3, 3] = -rot @ eye
    f = 0.5 * height / math.tan(0.5 * fov_y)
    return Pose(viewmat, float(np.float32(f)), float(np.float32(f)), width * 0.5,
                height * 0.5, near, far, width, height)


def ring(start: float, views: int, radius: float, elevation: float, width: int,
         height: int, fov_y: float, near: float, far: float) -> list[Pose]:
    """``views`` poses evenly around the y axis at ``radius`` from the
    origin, looking at it, the first at azimuth ``start`` (radians)."""
    poses = []
    for k in range(views):
        az = start + 2.0 * math.pi * k / views
        eye = radius * np.array([math.cos(elevation) * math.sin(az), -math.sin(elevation),
                                 -math.cos(elevation) * math.cos(az)])
        poses.append(look_at(eye, np.zeros(3), width, height, fov_y, near, far))
    return poses


def start_azimuth(seed: int) -> float:
    """The seed's start angle in [0, 2 pi), from a generator of its own."""
    return float(np.random.default_rng(seed).uniform(0.0, 2.0 * math.pi))
