"""Splat-set data model (counterpart of ``vk_gaussian_splatting_tpu/scene/splat_set.py``).

- ``SplatSet`` mirrors the *raw* PLY parameterization (splat_set.h:33-47):
  log-space scales, logit opacities, (w,x,y,z) quaternions, SH coefficients.
- ``PreparedSplats`` mirrors the device-resident form the reference
  precomputes at upload time (splat_set_vk.cpp:265-345): 3D covariances from
  (scale, quat), sigmoid-activated opacity, SH0 folded into a base RGB color,
  and the SH rest coefficients with optional fp16 / uint8 quantization
  (splat_set_vk.cpp:396-447).

Coordinate-system conversion follows the spz convention tables
(3rdparty/spz/src/cc/splat-types.h:24-80, used via splat_set.h:78-114).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.config import ShFormat

SH_C0 = 0.28209479177387814


class CoordinateSystem(enum.IntEnum):
    """Axis conventions (spz splat-types.h:24-33). Letters = direction of +x,+y,+z."""

    UNSPECIFIED = 0
    LDB = 1
    RDB = 2
    LUB = 3
    RUB = 4  # Three.js
    LDF = 5
    RDF = 6  # PLY / INRIA 3DGS
    LUF = 7  # GLB
    RUF = 8  # Unity


def _axes_match(a: CoordinateSystem, b: CoordinateSystem) -> tuple[bool, bool, bool]:
    an, bn = int(a) - 1, int(b) - 1
    if an < 0 or bn < 0:
        return True, True, True
    return tuple(((an >> i) & 1) == ((bn >> i) & 1) for i in range(3))


def coordinate_flips(from_cs: CoordinateSystem, to_cs: CoordinateSystem):
    """Returns (flip_p[3], flip_q[3], flip_sh[15]) numpy sign arrays (splat-types.h:55-80)."""
    xm, ym, zm = _axes_match(from_cs, to_cs)
    x, y, z = (1.0 if m else -1.0 for m in (xm, ym, zm))
    flip_p = np.array([x, y, z], np.float32)
    flip_q = np.array([y * z, x * z, x * y], np.float32)
    flip_sh = np.array(
        [y, z, x, x * y, y * z, 1.0, x * z, 1.0, y, x * y * z, y, z, x, z, x],
        np.float32,
    )
    return flip_p, flip_q, flip_sh


def _sh_degree_of(m: int) -> int:
    return 3 if m >= 15 else 2 if m >= 8 else 1 if m >= 3 else 0


@dataclasses.dataclass
class SplatSet:
    """Raw splat parameters, SoA tensors sharing leading dim N.

      means      (N, 3)  world positions
      scales     (N, 3)  log-space axis scales
      quats      (N, 4)  rotation quaternions (w, x, y, z), not necessarily unit
      opacities  (N,)    logit-space opacity
      sh_dc      (N, 3)  degree-0 SH (f_dc)
      sh_rest    (N, M, 3)  higher-degree SH, coefficient-major with RGB per
                 coefficient; M in {0, 3, 8, 15}
    """

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh_dc: torch.Tensor
    sh_rest: torch.Tensor

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def max_sh_degree(self) -> int:
        """SH degree stored (splat_set.h:52-74)."""
        return _sh_degree_of(self.sh_rest.shape[1])

    def convert_coordinates(self, from_cs: CoordinateSystem, to_cs: CoordinateSystem) -> "SplatSet":
        """Axis-flip conversion incl. quaternion & SH sign flips (splat_set.h:78-114)."""
        flip_p, flip_q, flip_sh = coordinate_flips(from_cs, to_cs)
        dev = self.means.device
        m = self.sh_rest.shape[1]
        flip_q4 = torch.from_numpy(np.concatenate([np.ones(1, np.float32), flip_q])).to(dev)
        return dataclasses.replace(
            self,
            means=self.means * torch.from_numpy(flip_p).to(dev),
            quats=self.quats * flip_q4,
            sh_rest=self.sh_rest * torch.from_numpy(flip_sh[:m]).to(dev)[None, :, None],
        )

    def prepare(self, sh_format: ShFormat = ShFormat.FLOAT32) -> "PreparedSplats":
        return prepare_splats(self, sh_format)


def covariance_from_scale_rot(scales_log: torch.Tensor, quats: torch.Tensor,
                              scale_multiplier: float = 1.0) -> torch.Tensor:
    """3D covariance Σ = R S Sᵀ Rᵀ packed as (N,6): xx,xy,xz,yy,yz,zz.

    Matches the reference upload-time precompute (splat_set_vk.cpp:265-288):
    scales exponentiate from log space, quaternion normalized. Column
    arithmetic in the JAX package's order, so both packages round alike.
    """
    s = torch.exp(scales_log) * scale_multiplier          # (N,3)
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # rows of M = R @ diag(s): m[i][j] = R[i][j] * s[j]
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    m = [[r[i][0] * s0, r[i][1] * s1, r[i][2] * s2] for i in range(3)]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return torch.stack(
        [dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)],
        dim=-1,
    )


def activate_color_opacity(sh_dc: torch.Tensor, opacities_logit: torch.Tensor) -> torch.Tensor:
    """(N,4) RGBA: SH0 folded to base color + sigmoid opacity (splat_set_vk.cpp:313-345)."""
    rgb = torch.clamp(0.5 + SH_C0 * sh_dc, 0.0, 1.0)
    a = torch.sigmoid(opacities_logit).clamp(0.0, 1.0)
    return torch.cat([rgb, a[:, None]], dim=-1)


def quantize_sh(sh_rest: torch.Tensor, sh_format: ShFormat) -> torch.Tensor:
    """Quantize SH rest coefficients like storeSh (splat_set_vk.cpp:104-112).

    uint8 maps [-1, 1] onto [0, 255]; fp16 is a straight cast. The returned
    tensor keeps quantized *values* in its storage dtype; dequantization
    happens in :func:`dequantize_sh`.
    """
    if sh_format == ShFormat.FLOAT32:
        return sh_rest.to(torch.float32)
    if sh_format == ShFormat.FLOAT16:
        return sh_rest.to(torch.float16)
    if sh_format == ShFormat.UINT8:
        norm = (sh_rest.clamp(-1.0, 1.0) + 1.0) * 0.5
        return torch.round(norm * 255.0).to(torch.uint8)
    raise ValueError(f"unknown sh format {sh_format}")


def dequantize_sh(sh: torch.Tensor) -> torch.Tensor:
    if sh.dtype == torch.uint8:
        return sh.to(torch.float32) / 255.0 * 2.0 - 1.0
    return sh.to(torch.float32)


@dataclasses.dataclass
class PreparedSplats:
    """Device-resident render form (the reference's VRAM layout, splat_set_vk.cpp:117-170).

      means   (N, 3) f32
      cov3d   (N, 6) f32 packed symmetric covariance (xx,xy,xz,yy,yz,zz)
      color   (N, 4) f32 activated base RGBA
      sh      (N, M, 3) in sh_format dtype (deg-major, RGB-interleaved)
      scales_log / quats retained for size culling
    """

    means: torch.Tensor
    cov3d: torch.Tensor
    color: torch.Tensor
    sh: torch.Tensor
    scales_log: torch.Tensor
    quats: torch.Tensor

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def max_sh_degree(self) -> int:
        return _sh_degree_of(self.sh.shape[1])


def prepare_splats(splats: SplatSet, sh_format: ShFormat = ShFormat.FLOAT32,
                   scale_multiplier: float = 1.0) -> PreparedSplats:
    """The upload-time transform (SplatSetVk::initDataStorage, splat_set_vk.cpp:117-170)."""
    return PreparedSplats(
        means=splats.means.to(torch.float32),
        cov3d=covariance_from_scale_rot(splats.scales, splats.quats, scale_multiplier),
        color=activate_color_opacity(splats.sh_dc, splats.opacities),
        sh=quantize_sh(splats.sh_rest, sh_format),
        scales_log=splats.scales.to(torch.float32),
        quats=splats.quats.to(torch.float32),
    )


def random_splats(generator: torch.Generator, n: int, sh_degree: int = 3,
                  extent: float = 3.0, scale_range=(-5.0, -3.0)) -> SplatSet:
    """Synthetic splat set for tests and benchmarks, made on the generator's
    device. Same distributions as the JAX package's ``random_splats``; the
    numbers differ (torch and jax.random are different streams)."""
    m = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]
    dev = generator.device
    kw = dict(generator=generator, device=dev, dtype=torch.float32)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **kw) * (hi - lo) + lo

    return SplatSet(
        means=uniform((n, 3), -extent, extent),
        scales=uniform((n, 3), *scale_range),
        quats=torch.randn((n, 4), **kw),
        opacities=uniform((n,), -2.0, 4.0),
        sh_dc=torch.randn((n, 3), **kw) * 0.8,
        sh_rest=(torch.randn((n, m, 3), **kw) * 0.1 if m
                 else torch.zeros((n, 0, 3), device=dev, dtype=torch.float32)),
    )
