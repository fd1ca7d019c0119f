"""Reference (oracle) rasterizer: naive per-pixel blend over all splats.

Implements exactly the fragment math of threedgs_raster.frag.slang:236-309 —
``A = dot(fragPos, fragPos)`` Gaussian falloff with discard at A > 8, opacity
``exp(-0.5 A) * alpha``, and sorted front-to-back "under" compositing
``w = α·T, T *= (1-α)`` — but vectorized over (pixels × splats) with no tile
binning. O(H·W·N) memory: use only for small test scenes. Plain torch on any
device, differentiable by autograd; the tile blenders are validated against
it, both for images and for gradients.

The JAX package's ``ops/rasterize_ref.py`` function for function: the same
stable depth argsorts, the exclusive running transmittance by a shifted
cumprod (never a division), and its einsums and matmuls as explicit f32
sums of products, so no TF32 setting reaches them.
"""

from __future__ import annotations

import torch

from vk_gaussian_splatting_tpu_torch.config import RasterConfig
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu_torch.ops.response import kernel_response
from vk_gaussian_splatting_tpu_torch.scene.splat_set import quat_to_rotmat


def _exclusive_transmittance(q: torch.Tensor) -> torch.Tensor:
    """(P,N) transmittance in front of each splat: shift, don't divide (q
    can be tiny)."""
    return torch.cat([torch.ones_like(q[:, :1]), torch.cumprod(q, dim=1)[:, :-1]], dim=1)


def _weighted_colors(w: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """(P,3) = w (P,N) @ color (N,3) as one f32 sum per channel."""
    return torch.stack([(w * color[:, c]).sum(1) for c in range(3)], dim=-1)


def _background(background, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(background, dtype=torch.float32, device=like.device)


def _depth_order(proj: ProjectedSplats) -> torch.Tensor:
    depth_sorted = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, float("inf")))
    return torch.argsort(depth_sorted, stable=True)


def rasterize_naive(
    proj: ProjectedSplats,
    width: int,
    height: int,
    rc: RasterConfig = RasterConfig(),
    background=(0.0, 0.0, 0.0),
):
    """Returns (img (H,W,3), transmittance (H,W)). Front-to-back over depth order."""
    order = _depth_order(proj)
    xy = proj.xy[order]
    conic = proj.conic[order]
    color = proj.color[order]
    alpha = proj.alpha[order]
    valid = proj.valid[order]

    dev = xy.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    px = xs.reshape(-1, 1)  # (P,1)
    py = ys.reshape(-1, 1)

    dx = px - xy[None, :, 0]  # (P,N)
    dy = py - xy[None, :, 1]
    d = (conic[None, :, 0] * dx * dx
         + 2.0 * conic[None, :, 1] * dx * dy
         + conic[None, :, 2] * dy * dy)
    g = torch.exp(-0.5 * d)
    a_raw = alpha[None, :] * g
    mask = (d <= rc.alpha_cull_qmax) & (a_raw >= rc.alpha_min) & valid[None, :]
    a = torch.where(mask, torch.clamp(a_raw, max=rc.alpha_clamp), torch.zeros_like(a_raw))

    q = 1.0 - a
    w = a * _exclusive_transmittance(q)  # (P,N)
    rgb = _weighted_colors(w, color)  # (P,3)
    t_final = torch.prod(q, dim=1)  # (P,)

    img = rgb + t_final[:, None] * _background(background, rgb)
    return img.reshape(height, width, 3), t_final.reshape(height, width)


def blend_ftb(alpha: torch.Tensor, color_sorted: torch.Tensor, background):
    """Shared front-to-back compositing: alpha (P,N) in sorted order,
    color_sorted (N,3). Returns (rgb (P,3), transmittance (P,))."""
    q = 1.0 - alpha
    w = alpha * _exclusive_transmittance(q)
    rgb = _weighted_colors(w, color_sorted)
    t_final = torch.prod(q, dim=1)
    return rgb + t_final[:, None] * _background(background, rgb), t_final


def _rotate_rows(v: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """einsum("pni,nij->pnj", v, rot) as f32 sums of three products."""
    return (v[..., 0:1] * rot[None, :, 0] + v[..., 1:2] * rot[None, :, 1]
            + v[..., 2:3] * rot[None, :, 2])


def _canonical_rays(pos, scl, rot, dirs, origins):
    """Each pixel ray in each splat's canonical frame: (origin (P,N,3),
    unnormalised direction (P,N,3))."""
    d = dirs.reshape(-1, 1, 3)                         # (P,1,3)
    o = origins.reshape(-1, 1, 3)
    rel = o - pos[None]                                # (P,N,3)
    s = torch.clamp(scl[None], min=1e-12)
    oc = _rotate_rows(rel, rot) / s
    dcu = _rotate_rows(d.expand(rel.shape), rot) / s
    return oc, dcu


def _response_alpha(oc, dc, op, valid, rc, kernel_degree, kernel_min_response):
    cr = torch.linalg.cross(dc, oc, dim=-1)
    dist_sq = torch.sum(cr * cr, dim=-1)               # (P,N)
    resp = kernel_response(dist_sq, kernel_degree)
    a_raw = op[None] * resp
    mask = (a_raw > rc.alpha_min) & (resp > kernel_min_response) & valid[None]
    return torch.where(mask, torch.clamp(a_raw, max=rc.alpha_clamp), torch.zeros_like(a_raw)), mask


def rasterize_naive_gut(
    prepared,
    proj: ProjectedSplats,
    dirs: torch.Tensor,      # (H,W,3) unit ray directions (world/model space)
    origins: torch.Tensor,   # (H,W,3) ray origins
    rc: RasterConfig = RasterConfig(),
    kernel_degree: int = 2,
    kernel_min_response: float = 0.0113,
    splat_scale: float = 1.0,
    background=(0.0, 0.0, 0.0),
):
    """Oracle for the gut3d response: per-pixel exact 3D ray evaluation over
    all splats in depth order (particleProcessHitGut, threedgrt.h.slang:238-278
    + the FTB blend of threedgut_raster.frag.slang)."""
    h, w = dirs.shape[:2]
    order = _depth_order(proj)
    pos = prepared.means[order]                        # (N,3)
    scl = torch.exp(prepared.scales_log[order]) * splat_scale
    rot = quat_to_rotmat(prepared.quats[order])        # (N,3,3)
    oc, dc = _canonical_rays(pos, scl, rot, dirs, origins)
    dc = dc / torch.clamp(torch.linalg.norm(dc, dim=-1, keepdim=True), min=1e-15)
    alpha, _ = _response_alpha(oc, dc, proj.alpha[order], proj.valid[order], rc,
                               kernel_degree, kernel_min_response)
    rgb, t_final = blend_ftb(alpha, proj.color[order], background)
    return rgb.reshape(h, w, 3), t_final.reshape(h, w)


def raytrace_naive_exact(
    prepared,
    proj: ProjectedSplats,
    dirs: torch.Tensor,
    origins: torch.Tensor,
    rc: RasterConfig = RasterConfig(),
    kernel_degree: int = 2,
    kernel_min_response: float = 0.0113,
    splat_scale: float = 1.0,
    background=(0.0, 0.0, 0.0),
):
    """Gold-standard ray tracer: *exact per-ray* front-to-back ordering by the
    canonical hit parameter t = -(o_c . d_c) (threedgrt_raytrace.rint:159-172),
    i.e. what the reference's k-buffer marching converges to with unlimited
    passes. O(P * N log N) — tiny scenes only; used to quantify how close the
    production sort orders (radial / view-z) get."""
    h, w = dirs.shape[:2]
    scl = torch.exp(prepared.scales_log) * splat_scale
    rot = quat_to_rotmat(prepared.quats)
    oc, dcu = _canonical_rays(prepared.means, scl, rot, dirs, origins)
    dc = dcu / torch.clamp(torch.linalg.norm(dcu, dim=-1, keepdim=True), min=1e-15)
    alpha, mask = _response_alpha(oc, dc, proj.alpha, proj.valid, rc, kernel_degree,
                                  kernel_min_response)
    # world-units hit parameter (rint:159-172): canonical t divided by the
    # canonical direction scale so values compare across splats
    t_hit = -torch.sum(oc * dcu, dim=-1) / torch.clamp(torch.sum(dcu * dcu, dim=-1), min=1e-20)

    order = torch.argsort(torch.where(mask, t_hit, torch.full_like(t_hit, float("inf"))),
                          dim=1, stable=True)          # per ray
    alpha_s = torch.take_along_dim(alpha, order, dim=1)
    col_s = proj.color[order]                          # (P,N,3)

    q = 1.0 - alpha_s
    wgt = alpha_s * _exclusive_transmittance(q)
    rgb = (wgt[..., None] * col_s).sum(1)              # einsum("pn,pnc->pc")
    t_final = torch.prod(q, dim=1)
    img = rgb + t_final[:, None] * _background(background, rgb)
    return img.reshape(h, w, 3), t_final.reshape(h, w)
