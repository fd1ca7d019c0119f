"""Spherical-harmonics radiance evaluation (counterpart of
``vk_gaussian_splatting_tpu/ops/sh.py:32-63,119-136``).

Matches the reference polynomial and sign conventions exactly
(shaders/threedgs_particle_storage.h.slang:48-159, fetchViewDependentRadiance):
degree-0 is folded into the base color at prepare time (splat_set.py), so
this module only evaluates degrees 1..3 as an additive radiance term. Band
rotation for rotated instances is not ported yet.
"""

from __future__ import annotations

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
