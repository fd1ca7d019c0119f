"""EWA splat projection, the 3DGS path (counterpart of
``vk_gaussian_splatting_tpu/ops/projection.py:36-212``).

Per-splat math of the reference's raster shaders, vectorized over all
splats:

- covariance projection J·W·Σ·Wᵀ·Jᵀ (threedgs.h.slang:26-56)
- low-pass dilation +0.3 px, Mip-Splatting alpha compensation
  sqrt(det_orig / det_blur), eigenvalue extent with sqrt(8)·σ radius clamped
  to 2048 px (threedgs.h.slang:60-121)
- NDC center frustum cull with dilation margin and optional screen-size cull
  (dist.comp.slang:64-133)

The tile blender consumes the *conic* (inverse 2D covariance) directly.
Everything is column arithmetic in the JAX package's order, so both
packages round alike. The unscented-transform (3DGUT) half is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch.config import RenderConfig
from vk_gaussian_splatting_tpu_torch.ops.sh import eval_sh_radiance
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera, view_transform_points
from vk_gaussian_splatting_tpu_torch.scene.splat_set import PreparedSplats, dequantize_sh


@dataclasses.dataclass
class ProjectedSplats:
    """Per-splat 2D render attributes (all (N,...) f32 except valid)."""

    xy: torch.Tensor       # (N,2) pixel-space projected center
    conic: torch.Tensor    # (N,3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # (N,)  view-space z
    radius: torch.Tensor   # (N,2) rect extent half-size in pixels (0 = culled)
    color: torch.Tensor    # (N,3) rgb (base + SH radiance)
    alpha: torch.Tensor    # (N,)  opacity (incl. MS compensation)
    valid: torch.Tensor    # (N,)  bool


def ewa_project_cov(cov6: torch.Tensor, p_view: torch.Tensor, fx, fy,
                    view_rot: torch.Tensor, tan_fovx, tan_fovy) -> torch.Tensor:
    """Project (N,6) packed world covariances to (N,3) packed (a, b, c) 2D ones.

    threedgs.h.slang:26-56. The x/z, y/z terms in the Jacobian are clamped to
    1.3·tan(fov) (INRIA's stabilization) so off-frustum splats don't produce
    degenerate conics before the cull masks them.
    """
    x, y, z = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    inv_z = 1.0 / z
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = torch.clamp(x * inv_z, -lim_x, lim_x) * z
    ty = torch.clamp(y * inv_z, -lim_y, lim_y) * z

    # J rows: (j00, 0, j02) and (0, j11, j12)
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z

    sxx, sxy, sxz, syy, syz, szz = (cov6[:, i] for i in range(6))
    w = view_rot  # (3,3)

    # M = W Σ Wᵀ, symmetric; t[i][k] = (W_i Σ)_k
    t_rows = []
    for i in range(3):
        wi0, wi1, wi2 = w[i, 0], w[i, 1], w[i, 2]
        t_rows.append((wi0 * sxx + wi1 * sxy + wi2 * sxz,
                       wi0 * sxy + wi1 * syy + wi2 * syz,
                       wi0 * sxz + wi1 * syz + wi2 * szz))

    def m_entry(i, jx):
        ti = t_rows[i]
        return ti[0] * w[jx, 0] + ti[1] * w[jx, 1] + ti[2] * w[jx, 2]

    m00 = m_entry(0, 0)
    m01 = m_entry(0, 1)
    m02 = m_entry(0, 2)
    m11 = m_entry(1, 1)
    m12 = m_entry(1, 2)
    m22 = m_entry(2, 2)

    # cov2d = J M Jᵀ with J's sparsity expanded
    a = j00 * j00 * m00 + 2.0 * j00 * j02 * m02 + j02 * j02 * m22
    b = (j00 * j11 * m01 + j00 * j12 * m02
         + j02 * j11 * m12 + j02 * j12 * m22)
    c = j11 * j11 * m11 + 2.0 * j11 * j12 * m12 + j12 * j12 * m22
    return torch.stack([a, b, c], -1)


def project_splats(prepared: PreparedSplats, cam: Camera,
                   cfg: RenderConfig) -> ProjectedSplats:
    """Full per-splat preprocessing stage (dist.comp + raster mesh-shader math)."""
    rc = cfg.raster
    means = prepared.means
    p_view = view_transform_points(cam.viewmat, means)
    depth = p_view[..., 2]

    zsafe = torch.where(torch.abs(depth) < 1e-6, 1e-6, depth)
    u = cam.fx * p_view[..., 0] / zsafe + cam.cx
    v = cam.fy * p_view[..., 1] / zsafe + cam.cy
    xy = torch.stack([u, v], -1)

    tan_fovx = 0.5 * cfg.width / cam.fx
    tan_fovy = 0.5 * cfg.height / cam.fy

    cov2d = ewa_project_cov(prepared.cov3d, p_view, cam.fx, cam.fy,
                            cam.viewmat[:3, :3], tan_fovx, tan_fovy)

    det_orig = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    a = cov2d[:, 0] + rc.dilation
    b = cov2d[:, 1]
    c = cov2d[:, 2] + rc.dilation
    det = a * c - b * b

    # opacity with optional Mip-Splatting compensation (threedgs.h.slang:63-76)
    alpha = prepared.color[:, 3] * cfg.opacity_gain
    if rc.ms_antialiasing:
        alpha = alpha * torch.sqrt(torch.clamp(
            det_orig / torch.where(det == 0, 1.0, det), min=0.0))

    det_safe = torch.where(det <= 0, 1.0, det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)

    # eigenvalues -> extent radius (threedgs.h.slang:91-118)
    mid = 0.5 * (a + c)
    term = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + term
    lambda2 = mid - term
    if rc.point_cloud_mode:
        lambda1 = torch.full_like(lambda1, 0.2)
        lambda2 = torch.full_like(lambda2, 0.2)
    radius = torch.clamp(rc.extent_sigma * torch.sqrt(torch.clamp(lambda1, min=0.0)),
                         max=rc.max_basis_px) * cfg.splat_scale
    radius = torch.ceil(radius)[:, None].expand(-1, 2)

    # frustum cull on the center in dilated NDC (dist.comp.slang:64-90)
    clip = 1.0 + rc.frustum_dilation
    ndc_x = (u - cam.cx) / (0.5 * cfg.width)
    ndc_y = (v - cam.cy) / (0.5 * cfg.height)
    valid = (
        (depth > cam.near)
        & (depth < cam.far)
        & (torch.abs(ndc_x) <= clip)
        & (torch.abs(ndc_y) <= clip)
        & (det > 0)
        & (lambda2 > 0)
        & (alpha >= rc.alpha_min)
    )

    if rc.size_culling:
        # projected bounding-sphere diameter in pixels (dist.comp.slang:93-133)
        scale_max = torch.exp(prepared.scales_log).amax(dim=-1) * cfg.splat_scale
        extent_px = (scale_max * 2.8284271247 * 2.0) * torch.maximum(cam.fx, cam.fy) \
            / torch.clamp(torch.abs(depth), min=1e-4)
        valid = valid & (extent_px >= rc.size_culling_min_px)

    # color = activated base + SH radiance along camera->splat dir
    # (threedgs_raster.mesh.slang:238-243)
    rgb = prepared.color[:, :3]
    if cfg.sh_degree >= 1 and prepared.sh.shape[1] > 0:
        dirs = means - cam.position
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
        sh_rad = eval_sh_radiance(dequantize_sh(prepared.sh), dirs, cfg.sh_degree)
        if cfg.show_sh_only:
            rgb = torch.full_like(rgb, 0.5) + sh_rad
        else:
            rgb = rgb + sh_rad
        rgb = torch.clamp(rgb, min=0.0)

    radius = torch.where(valid[:, None], radius, 0.0)
    return ProjectedSplats(xy=xy, conic=conic, depth=depth, radius=radius,
                           color=rgb, alpha=alpha, valid=valid)
