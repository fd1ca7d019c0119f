"""antimatter15 .splat format (32 bytes a record, no header): counterpart of
``vk_gaussian_splatting_tpu/io/splat_file.py``.

Vectorized numpy form of loadSplatFile (ply_loader_async.cpp:41-180):
position f32x3, linear scale f32x3 (-> log), rgba u8x4 (rgb -> f_dc by the
inverse SH0 fold, a -> logit opacity), quaternion u8x4 stored (x, y, z, w)
as q * 128 + 128. Decoded on the host, the splats land on ``device``.

The reference stores the decoded quaternion's (x, y, z, w) into its
(w, x, y, z) slots despite its own comment (ply_loader_async.cpp:136-142);
like the JAX package, this reader stores (w, x, y, z).
"""

from __future__ import annotations

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.scene.splat_set import SH_C0, CoordinateSystem, SplatSet

_DTYPE = np.dtype([
    ("position", "<f4", 3),
    ("scale", "<f4", 3),
    ("color", "u1", 4),
    ("rotation", "u1", 4),
])


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32, copy=False)


def load_splat_file(path: str, to_rub: bool = True,
                    device: torch.device | str | None = None) -> SplatSet:
    """Read a .splat file into a SplatSet on ``device`` (default: the card)."""
    device = resolve_device(device)
    rec = np.fromfile(path, dtype=_DTYPE)
    if rec.size == 0:
        raise ValueError(f"empty or invalid .splat file: {path}")
    q = (rec["rotation"].astype(np.float32) - 128.0) / 128.0      # (n, 4) x, y, z, w
    alpha = np.clip(rec["color"][:, 3].astype(np.float32) / 255.0, 1e-6, 1 - 1e-6)
    arrays = dict(
        means=rec["position"].astype(np.float32),
        scales=np.log(np.maximum(rec["scale"].astype(np.float32), 1e-30)),
        quats=np.concatenate([q[:, 3:4], q[:, 0:3]], axis=1),     # w, x, y, z
        opacities=np.log(alpha / (1.0 - alpha)),
        sh_dc=(rec["color"][:, 0:3].astype(np.float32) / 255.0 - 0.5) / SH_C0,
        sh_rest=np.zeros((rec.size, 0, 3), np.float32),
    )
    splats = SplatSet(**{k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
                         for k, v in arrays.items()})
    if to_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RDF, CoordinateSystem.RUB)
    return splats


def save_splat_file(path: str, splats: SplatSet, from_rub: bool = True) -> None:
    """Write ``splats`` as a .splat file (SH beyond degree 0 is dropped)."""
    if from_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RUB, CoordinateSystem.RDF)
    means = _host(splats.means)
    rec = np.zeros(means.shape[0], dtype=_DTYPE)
    rec["position"] = means
    rec["scale"] = np.exp(_host(splats.scales))
    q = _host(splats.quats)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    xyzw = np.concatenate([q[:, 1:4], q[:, 0:1]], axis=1)
    rec["rotation"] = np.clip(np.round(xyzw * 128.0 + 128.0), 0, 255).astype(np.uint8)
    rgb = 0.5 + SH_C0 * _host(splats.sh_dc)
    a = 1.0 / (1.0 + np.exp(-_host(splats.opacities)))
    rgba = np.concatenate([rgb, a[:, None]], axis=1)
    rec["color"] = np.clip(np.round(rgba * 255.0), 0, 255).astype(np.uint8)
    rec.tofile(path)
