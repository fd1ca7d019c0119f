"""Splat projection: EWA for 3DGS and the unscented transform for 3DGUT and
3DGRT (counterpart of ``vk_gaussian_splatting_tpu/ops/projection.py:36-429``).

Per-splat math of the reference's raster shaders, vectorized over all
splats:

- covariance projection J·W·Σ·Wᵀ·Jᵀ (threedgs.h.slang:26-56)
- low-pass dilation +0.3 px, Mip-Splatting alpha compensation
  sqrt(det_orig / det_blur), eigenvalue extent with sqrt(8)·σ radius clamped
  to 2048 px (threedgs.h.slang:60-121)
- NDC center frustum cull with dilation margin and optional screen-size cull
  (dist.comp.slang:64-133)

The tile blender consumes the *conic* (inverse 2D covariance) directly.
``ut_project_splats`` projects seven sigma points through the sensor model
of ``RenderConfig.camera_type`` (pinhole with OpenCV distortion, or the
fisheye theta polynomial), with the rolling-shutter fixed point, for the
binning of the gut3d pipelines. ``project_splats`` is pinhole EWA whatever
``camera_type`` says, as in the JAX package. Everything is column
arithmetic in the JAX package's order, so both packages round alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.config import CameraType, RenderConfig, ShutterType
from vk_gaussian_splatting_tpu_torch.ops.sh import eval_sh_radiance
from vk_gaussian_splatting_tpu_torch.scene.cameras import (
    Camera,
    shutter_time,
    shutter_transform_cols,
    view_transform_points,
)
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

    radius = torch.where(valid[:, None], radius, 0.0)
    return ProjectedSplats(xy=xy, conic=conic, depth=depth, radius=radius,
                           color=splat_rgb(prepared, cam, cfg), alpha=alpha, valid=valid)


def splat_rgb(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig) -> torch.Tensor:
    """(N,3) color = activated base + SH radiance along camera->splat dir
    (threedgs_raster.mesh.slang:238-243), for both projections, under the
    child span project.sh."""
    rgb = prepared.color[:, :3]
    if cfg.sh_degree >= 1 and prepared.sh.shape[1] > 0:
        with timing.span("project.sh"):
            dirs = prepared.means - cam.position
            dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
            sh_rad = eval_sh_radiance(dequantize_sh(prepared.sh), dirs, cfg.sh_degree)
            if cfg.show_sh_only:
                rgb = torch.full_like(rgb, 0.5) + sh_rad
            else:
                rgb = rgb + sh_rad
            rgb = torch.clamp(rgb, min=0.0)
    return rgb


# ---------------------------------------------------------------------------
# 3DGUT: unscented-transform projection (threedgut.h.slang:29-121 + camera
# projections threedgut_camera_projections.h.slang:149-171)
# ---------------------------------------------------------------------------

GUT_DELTA = 1.7320508075688772  # sqrt(3) = sqrt(alpha^2 (D + kappa)), D=3
GUT_ALPHA_THRESHOLD = 0.01
GUT_MARGIN = 0.1                # GUT_IN_IMAGE_MARGIN_FACTOR
GUT_DILATION = 0.3
SHUTTER_ITERATIONS = 5          # projectPointWithShutter's fixed point


def fisheye_max_angle(width, height, cx, cy, fx, fy):
    """threedgut_camera_models.h.slang:89-120 computeMaxAngle."""
    mx = torch.maximum(cx, width - cx)
    my = torch.maximum(cy, height - cy)
    max_radius = torch.sqrt(mx * mx + my * my)
    return torch.maximum(max_radius / fx, max_radius / fy)


def project_point_cols(cam: Camera, x, y, z, cfg: RenderConfig, margin: float = GUT_MARGIN):
    """Column core of the sensor projection: (x, y, z) -> (u, v, valid), for
    columns of any shape."""
    d = cam.distortion
    if cfg.camera_type == CameraType.PINHOLE:
        zs = torch.where(z <= 1e-8, 1e-8, z)
        un = x / zs
        vn = y / zs
        r2 = un * un + vn * vn
        a1 = 2.0 * un * vn
        a2 = r2 + 2.0 * un * un
        a3 = r2 + 2.0 * vn * vn
        num = 1.0 + r2 * (d[0] + r2 * (d[1] + r2 * d[2]))
        den = 1.0 + r2 * (d[3] + r2 * (d[4] + r2 * d[5]))
        icd = num / torch.where(den == 0, 1.0, den)
        du = d[6] * a1 + d[7] * a2 + r2 * (d[8] + r2 * d[9])
        dv = d[6] * a3 + d[7] * a1 + r2 * (d[10] + r2 * d[11])
        und = icd * un + du
        vnd = icd * vn + dv
        valid_radial = (icd > 0.8) & (icd < 1.2)
        # out-of-limits: push to the clipping radius along the undistorted
        # direction (camera_projections:127-137)
        roi = float(np.sqrt(np.float32(cfg.width ** 2 + cfg.height ** 2)))
        rsafe = torch.sqrt(torch.clamp(r2, min=1e-12))
        u = torch.where(valid_radial, cam.fx * und + cam.cx, (roi / rsafe) * un + cam.cx)
        v = torch.where(valid_radial, cam.fy * vnd + cam.cy, (roi / rsafe) * vn + cam.cy)
        valid = (z > 0) & valid_radial
    else:
        rho = torch.sqrt(torch.clamp(x * x + y * y, min=1e-14))
        theta_full = torch.atan2(rho, z)
        auto_angle = fisheye_max_angle(cfg.width, cfg.height, cam.cx, cam.cy, cam.fx, cam.fy)
        max_angle = torch.where(d[16] > 0, d[16], auto_angle)
        theta = torch.minimum(theta_full, max_angle)
        # theta * (1 + poly(theta^2) * theta^2) / rho (Horner,
        # camera_projections:159-165)
        t2 = theta * theta
        poly = d[12] + t2 * (d[13] + t2 * (d[14] + t2 * d[15]))
        delta = theta * (poly * t2 + 1.0) / rho
        u = cam.fx * x * delta + cam.cx
        v = cam.fy * y * delta + cam.cy
        valid = theta_full < max_angle
    tol_x = cfg.width * margin
    tol_y = cfg.height * margin
    valid = valid & (u > -tol_x) & (v > -tol_y) & (u < cfg.width + tol_x) & (v < cfg.height + tol_y)
    return u, v, valid


def camera_project_points(cam: Camera, p_cam: torch.Tensor, cfg: RenderConfig,
                          margin: float = GUT_MARGIN):
    """Project camera-space points through the configured sensor model.

    p_cam (..., 3) -> (uv (..., 2), valid (...,)). Full OpenCV models
    (projectPointPinhole / projectPointFisheye, camera_projections:91-171):
    pinhole with rational radial + tangential + thin-prism distortion (valid
    while 0.8 < icD < 1.2, out-of-limits points clipped outward); fisheye
    with the theta-polynomial and maxAngle FOV cone. All-zero distortion
    (the default) reduces to the ideal models."""
    u, v, valid = project_point_cols(cam, p_cam[..., 0], p_cam[..., 1], p_cam[..., 2], cfg,
                                     margin)
    return torch.stack([u, v], -1), valid


def ut_project_splats(prepared: PreparedSplats, cam: Camera,
                      cfg: RenderConfig) -> ProjectedSplats:
    """Unscented-transform projection (threedgutParticleProjection).

    Seven sigma points (mean, mean ± sqrt(3)·s_i·R[:,i]) project through the
    sensor model; the UT weights collapse to w_mean = 0, w_i = 1/6 for the
    center and w0_cov = 2 for the covariance (lambda = 0, alpha=1, beta=2 —
    threedgut_definitions.h.slang:44-51). Under a rolling shutter each point
    re-projects 5 times at the pose of its previous iterate's scan time
    (threedgut_camera_projections.h.slang:226-236). The seven points ride
    one (7, N) batch: elementwise, the same operations as seven columns.
    ``radius`` is the per-axis (N, 2) rect of the opacity-bounded extent
    (threedgutProjectedExtentConicOpacity)."""
    rc = cfg.raster
    means = prepared.means
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    q = prepared.quats / torch.linalg.norm(prepared.quats, dim=-1, keepdim=True).clamp_min(1e-12)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    # rotation columns (world-from-canonical R): rcol[i] = i-th column of R
    rcol = (
        (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy + qw * qz), 2 * (qx * qz - qw * qy)),
        (2 * (qx * qy - qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz + qw * qx)),
        (2 * (qx * qz + qw * qy), 2 * (qy * qz - qw * qx), 1 - 2 * (qx * qx + qy * qy)),
    )
    s = torch.exp(prepared.scales_log) * cfg.splat_scale       # (N,3)

    # 7 sigma points: mean, mean ± sqrt(3)·s_i·R[:,i]
    cols = [[mx], [my], [mz]]
    for i in range(3):
        for j in range(3):
            ax = GUT_DELTA * s[:, i] * rcol[i][j]
            cols[j] += [means[:, j] + ax, means[:, j] - ax]
    px, py, pz = (torch.stack(c) for c in cols)                # (7, N) each

    vm = cam.viewmat
    cxx = vm[0, 0] * px + vm[0, 1] * py + vm[0, 2] * pz + vm[0, 3]
    cyy = vm[1, 0] * px + vm[1, 1] * py + vm[1, 2] * pz + vm[1, 3]
    czz = vm[2, 0] * px + vm[2, 1] * py + vm[2, 2] * pz + vm[2, 3]
    u, v, ok = project_point_cols(cam, cxx, cyy, czz, cfg)
    if cfg.shutter != ShutterType.GLOBAL:
        for _ in range(SHUTTER_ITERATIONS):
            t = shutter_time(cfg.shutter, u, v, cfg.width, cfg.height)
            cxx, cyy, czz = shutter_transform_cols(cam, t, px, py, pz)
            u, v, ok = project_point_cols(cam, cxx, cyy, czz, cfg)
    depth = czz[0]

    w_i = 1.0 / 6.0
    cu = w_i * (u[1] + u[2] + u[3] + u[4] + u[5] + u[6])      # mean weight = 0
    cv = w_i * (v[1] + v[2] + v[3] + v[4] + v[5] + v[6])
    w0_cov = 2.0  # lambda/(D+lambda) + (1 - alpha^2 + beta)
    cov_a = cov_b = cov_c = 0.0
    for idx in range(7):
        du = u[idx] - cu
        dv = v[idx] - cv
        wgt = w0_cov if idx == 0 else w_i
        cov_a = cov_a + wgt * du * du
        cov_b = cov_b + wgt * du * dv
        cov_c = cov_c + wgt * dv * dv

    a = cov_a + GUT_DILATION
    b = cov_b
    c = cov_c + GUT_DILATION
    det = a * c - b * b
    det_safe = torch.where(det == 0, 1.0, det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)

    alpha = prepared.color[:, 3] * cfg.opacity_gain
    if rc.ms_antialiasing:
        det_orig = cov_a * cov_c - cov_b * cov_b
        alpha = alpha * torch.sqrt(torch.clamp(det_orig / det_safe, min=2.5e-5))

    # tight opacity-bounded rect extent (threedgutProjectedExtentConicOpacity)
    max_power = torch.log(torch.clamp(alpha, min=GUT_ALPHA_THRESHOLD) / GUT_ALPHA_THRESHOLD)
    extent_factor = torch.clamp(torch.sqrt(2.0 * max_power), max=3.33)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radius = extent_factor * torch.sqrt(lam)
    rx = torch.minimum(extent_factor * torch.sqrt(torch.clamp(a, min=0.0)), radius)
    ry = torch.minimum(extent_factor * torch.sqrt(torch.clamp(c, min=0.0)), radius)
    rect = torch.ceil(torch.stack([rx, ry], -1))

    valid = ok.any(dim=0) & (det != 0) & (alpha >= GUT_ALPHA_THRESHOLD) & (radius > 0)
    rect = torch.where(valid[:, None], rect, 0.0)
    return ProjectedSplats(xy=torch.stack([cu, cv], -1), conic=conic, depth=depth,
                           radius=rect, color=splat_rgb(prepared, cam, cfg), alpha=alpha,
                           valid=valid)
