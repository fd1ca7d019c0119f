"""Numpy in, numpy out: the same numbers for this package and the JAX one.

The JAX package's parameters, as numpy arrays, come in as tensors of this
package, and go back out as numpy dicts whose keys are the JAX
constructors' argument names, so a test can feed both packages one input:

    splats = splat_set_from_numpy(d)                  # here
    jax_splats = SplatSet(**{k: jnp.asarray(v) ...})  # there, same d
"""

from __future__ import annotations

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera, make_camera
from vk_gaussian_splatting_tpu_torch.scene.splat_set import SplatSet

SPLAT_FIELDS = ("means", "scales", "quats", "opacities", "sh_dc", "sh_rest")
CAMERA_FIELDS = ("viewmat", "fx", "fy", "cx", "cy", "near", "far")


def random_splat_arrays(seed: int, n: int, sh_degree: int = 3,
                        extent: float = 3.0, scale_range=(-5.0, -3.0)) -> dict:
    """Numpy splat parameters from ``numpy.random.default_rng(seed)``, with
    the distributions of ``random_splats``: one input for both packages."""
    rng = np.random.default_rng(seed)
    m = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]

    def f32(a):
        return np.asarray(a, np.float32)

    return dict(
        means=f32(rng.uniform(-extent, extent, (n, 3))),
        scales=f32(rng.uniform(*scale_range, (n, 3))),
        quats=f32(rng.normal(size=(n, 4))),
        opacities=f32(rng.uniform(-2.0, 4.0, n)),
        sh_dc=f32(rng.normal(size=(n, 3)) * 0.8),
        sh_rest=f32(rng.normal(size=(n, m, 3)) * 0.1),
    )


def splat_set_from_numpy(d: dict, device: torch.device | str | None = None) -> SplatSet:
    """SplatSet from a dict of numpy arrays keyed by SPLAT_FIELDS."""
    return SplatSet(**{k: torch.as_tensor(np.asarray(d[k], np.float32), device=device)
                       for k in SPLAT_FIELDS})


def splat_set_to_numpy(s: SplatSet) -> dict:
    return {k: getattr(s, k).detach().cpu().numpy() for k in SPLAT_FIELDS}


def camera_from_numpy(d: dict, device: torch.device | str | None = None) -> Camera:
    """Camera from a dict of numpy values keyed by CAMERA_FIELDS."""
    return make_camera(**{k: d[k] for k in CAMERA_FIELDS}, device=device)


def camera_to_numpy(c: Camera) -> dict:
    """The camera as make_camera arguments (also the JAX ``make_camera``'s)."""
    return {k: getattr(c, k).detach().cpu().numpy() for k in CAMERA_FIELDS}
