"""Spherical-harmonics radiance evaluation and band rotation (counterpart
of ``vk_gaussian_splatting_tpu/ops/sh.py``).

Matches the reference polynomial and sign conventions exactly
(shaders/threedgs_particle_storage.h.slang:48-159, fetchViewDependentRadiance):
degree-0 is folded into the base color at prepare time (splat_set.py), so
this module only evaluates degrees 1..3 as an additive radiance term.
``band_rotation`` and ``rotate_sh_rest`` rotate the stored bands into world
space for rotated instances (scene/instances.py).
"""

from __future__ import annotations

import numpy as np
import torch

SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Basis values for degrees 1..degree. dirs (...,3) unit vectors -> (...,M)
    where M = {1:3, 2:8, 3:15}[degree], deg-major coefficient order."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = []
    if degree >= 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        cols += [
            SH_C3[0] * (3.0 * xx - yy) * y,
            SH_C3[1] * x * y * z,
            SH_C3[2] * (4.0 * zz - xx - yy) * y,
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * (xx - yy) * z,
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if not cols:
        return dirs.new_zeros(dirs.shape[:-1] + (0,))
    return torch.stack(cols, dim=-1)


def _band_slices(stored_m: int):
    """[(start, count, degree)] band blocks present in an (N, M, 3) layout."""
    out = []
    if stored_m >= 3:
        out.append((0, 3, 1))
    if stored_m >= 8:
        out.append((3, 5, 2))
    if stored_m >= 15:
        out.append((8, 7, 3))
    return out


def band_rotation(rotmat, degree: int) -> np.ndarray:
    """(2l+1, 2l+1) float64 rotation of band-l coefficients for a world
    rotation R (numpy (3, 3)).

    Sampling construction: 4(2l+1) unit directions d_i from the JAX
    package's seeded generator; with A[i,j] = Y_j(d_i) and At[i,j] =
    Y_j(R^-1 d_i), the rotated function f'(d) = f(R^-1 d) satisfies
    A c' = At c, solved by least squares. The basis is evaluated on float32
    directions, as the JAX package (x64 off) evaluates it, then widened to
    float64 for the solve."""
    n = 2 * degree + 1
    rng = np.random.default_rng(degree * 7919 + 11)
    d = rng.normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.asarray(rotmat, np.float64)
    lo, cnt, _ = {1: (0, 3, 1), 2: (3, 5, 2), 3: (8, 7, 3)}[degree]

    def basis(dirs):
        b = sh_basis(torch.as_tensor(np.asarray(dirs, np.float32)), degree)
        return b.numpy().astype(np.float64)[:, lo:lo + cnt]

    m, *_ = np.linalg.lstsq(basis(d), basis(d @ r), rcond=None)
    return m


def rotate_sh_rest(sh_rest: torch.Tensor, rotmat) -> torch.Tensor:
    """(N, M, 3) model-space SH coefficients -> world space under the
    instance rotation R (model->world): block-diagonal per-band rotation,
    each band a float32 multiply-and-sum (no matmul, so no TF32 path)."""
    parts = []
    for lo, cnt, deg in _band_slices(sh_rest.shape[1]):
        m = torch.as_tensor(band_rotation(rotmat, deg), dtype=torch.float32,
                            device=sh_rest.device)
        block = sh_rest[:, lo:lo + cnt, :].to(torch.float32)
        parts.append((m[None, :, :, None] * block[:, None, :, :]).sum(dim=2))
    if not parts:
        return sh_rest
    return torch.cat(parts, dim=1)


def eval_sh_radiance(sh_rest: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Additive view-dependent radiance.

    sh_rest: (N, M, 3) float coefficients (already dequantized).
    dirs:    (N, 3) unit view directions.
    degree:  requested degree, clamped to what sh_rest stores.
    Returns (N, 3) rgb to add to the base color. The contraction is an f32
    multiply-and-sum, never a matmul, so no TF32 path can reach it.
    """
    stored_m = sh_rest.shape[1]
    stored_degree = 3 if stored_m >= 15 else 2 if stored_m >= 8 else 1 if stored_m >= 3 else 0
    degree = min(degree, stored_degree)
    if degree < 1:
        return sh_rest.new_zeros(sh_rest.shape[:1] + (3,), dtype=torch.float32)
    m = {1: 3, 2: 8, 3: 15}[degree]
    basis = sh_basis(dirs, degree)  # (N, m)
    return (basis[:, :, None] * sh_rest[:, :m, :].to(torch.float32)).sum(dim=1)
