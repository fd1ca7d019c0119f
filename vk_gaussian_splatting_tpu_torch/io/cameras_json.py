"""INRIA ``cameras.json`` import (camera_set.h:216-270 importCamerasINRIA):
counterpart of ``vk_gaussian_splatting_tpu/io/cameras_json.py``.

Each entry carries the camera-to-world rotation (columns: the camera axes),
the position (the camera centre), fx / fy and the image size, in the RDF
world of the training data. Splats convert RDF -> RUB on load, so the
cameras take the same world flip F = diag(1, -1, -1); the OpenCV camera
axes stay. The view matrices are made in float64 and rounded once to f32,
as in the JAX package.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera, make_camera


def import_cameras_inria(path: str, to_rub: bool = True,
                         device: torch.device | str | None = None) -> list[tuple[str, Camera]]:
    """[(image name, Camera on ``device``)] of a cameras.json (default: the card)."""
    device = resolve_device(device)
    with open(path) as f:
        data = json.load(f)
    flip = np.diag([1.0, -1.0, -1.0]) if to_rub else np.eye(3)
    out = []
    for item in data:
        r_c2w = flip @ np.asarray(item["rotation"], np.float64)
        pos = flip @ np.asarray(item["position"], np.float64)
        viewmat = np.eye(4, dtype=np.float32)
        viewmat[:3, :3] = r_c2w.T
        viewmat[:3, 3] = -r_c2w.T @ pos
        cam = make_camera(viewmat, fx=item["fx"], fy=item["fy"], cx=item["width"] * 0.5,
                          cy=item["height"] * 0.5, device=device)
        out.append((item.get("img_name", str(item.get("id", len(out)))), cam))
    return out
