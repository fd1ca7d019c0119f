"""Surface info and deferred shading (counterpart of
``vk_gaussian_splatting_tpu/render/deferred.py``; S11,
deferred_shading.comp.slang; the NEED_SURFACE_INFO paths of the raster
shaders).

- per-splat normals by the max-density-plane approximation
  (computeEllipsoidNormalMaxDensityPlane, threedgrt.h.slang:358-418) with
  the thin-particle fallbacks, over all splats at once;
- the opacity-weighted normal image (the fragment's outNormal = n * opacity
  composited front to back): one more pass of the tile blender with the
  normals in the colour rows;
- the picked depth and splat id come from the blender's aux outputs.

Deferred shading is a full-screen tensor pass: the world position from the
picked depth along the camera ray, the material of the pixel's instance,
and the Phong lights accumulated (deferred_shading.comp.slang:39-160; a
headlight where the scene has no lights). Each operation is the JAX
module's, in its order; its 3x3 products at ``Precision.HIGHEST`` are
written as sums of products here, so no TF32 setting can reach them.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch.config import RenderConfig
from vk_gaussian_splatting_tpu_torch.ops.rasterize import RasterStatics, assemble_image, rasterize_bins
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera
from vk_gaussian_splatting_tpu_torch.scene.lights import (
    LightSource,
    compute_light,
    compute_specular,
    headlight,
    light_direction_to,
)
from vk_gaussian_splatting_tpu_torch.scene.splat_set import PreparedSplats, quat_to_rotmat


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(v, dim=-1, keepdim=True)


def compute_splat_normals(prepared: PreparedSplats, cam_position: torch.Tensor,
                          thin_threshold: float = 1e-3,
                          splat_scale: float = 1.0) -> torch.Tensor:
    """(N,3) world-space outward normals (threedgrt.h.slang:358-418): the
    density gradient R diag(1/s^2) R^T (cam - mu) where no axis is thinner
    than ``thin_threshold``; the thin axis where one is; towards the camera
    where two or three are; each flipped towards the camera."""
    pos = prepared.means
    scl = torch.exp(prepared.scales_log) * splat_scale       # (N,3)
    rot = quat_to_rotmat(prepared.quats)                     # (N,3,3)
    local = cam_position - pos                               # toward camera

    is_small = scl < thin_threshold
    small_count = is_small.sum(dim=-1)

    # gradient normal: canon_j = sum_i local_i R_ij, grad_i = sum_j scaled_j R_ij
    canon = (local[:, 0:1] * rot[:, 0] + local[:, 1:2] * rot[:, 1]
             + local[:, 2:3] * rot[:, 2])
    scaled = canon / torch.clamp(scl * scl, min=1e-20)
    grad = (scaled[:, 0:1] * rot[:, :, 0] + scaled[:, 1:2] * rot[:, :, 1]
            + scaled[:, 2:3] * rot[:, :, 2])
    n_grad = grad / torch.clamp(_norm(grad), min=1e-12)

    # flat particle: the normal along the (first) small axis, a column of R
    axis_idx = torch.argmax(is_small.to(torch.int32), dim=-1)  # the first maximum, as jnp.argmax
    n_flat = torch.gather(rot, 2, axis_idx[:, None, None].expand(-1, 3, 1))[..., 0]
    n_flat = n_flat / torch.clamp(_norm(n_flat), min=1e-12)

    # degenerate: face the camera
    n_view = local / torch.clamp(_norm(local), min=1e-12)

    n = torch.where((small_count == 0)[:, None], n_grad,
                    torch.where((small_count == 1)[:, None], n_flat, n_view))
    # outward: flip toward the camera (sign 0 keeps the normal)
    flip = torch.sign(torch.sum(n * local, dim=-1, keepdim=True))
    return n * torch.where(flip == 0, 1.0, flip)


def normal_bins(prepared: PreparedSplats, proj, cam: Camera, cfg: RenderConfig,
                st: RasterStatics, max_pairs: int = 0, use_gut_rows: bool = False):
    """The normal pass's bins: the splats' rows (gs2d, or gut3d for
    ``use_gut_rows``) with ``compute_splat_normals`` in the colour rows,
    binned as pairs whatever ``raster.method`` says."""
    from vk_gaussian_splatting_tpu_torch.render.pipelines import (
        bin_for_cfg,
        gs_attr_rows,
        gut_attr_rows,
        pairs_cfg,
    )

    normals = compute_splat_normals(prepared, cam.position, splat_scale=cfg.splat_scale)
    proj_n = dataclasses.replace(proj, color=normals)
    rows, ids = (gut_attr_rows(prepared, proj_n, cfg) if use_gut_rows
                 else gs_attr_rows(proj_n))
    return bin_for_cfg(proj_n, rows, ids, pairs_cfg(cfg), max_pairs, st)


def normals_from_blend(out: torch.Tensor, out_id: torch.Tensor, st: RasterStatics,
                       cfg: RenderConfig) -> torch.Tensor:
    """(H,W,3) normal image from the normal pass's blend: assembled over
    black, divided by the coverage 1 - T (at least 1e-6) and normalised (at
    least 1e-6). Where 1 - T is near 0 the direction is ill-conditioned."""
    nrm, trans = assemble_image(out, out_id, st.tiles_x, st.tiles_y, cfg.width, cfg.height)[:2]
    w = torch.clamp(1.0 - trans, min=1e-6)[..., None]
    nrm = nrm / w
    return nrm / torch.clamp(_norm(nrm), min=1e-6)


def render_normal_buffer(prepared: PreparedSplats, proj, cam: Camera, cfg: RenderConfig,
                         st: RasterStatics, max_pairs: int = 0,
                         pix_ctx: torch.Tensor | None = None,
                         use_gut_rows: bool = False) -> torch.Tensor:
    """Opacity-weighted blended normal image (H,W,3): one more blend pass
    with the normals in the colour rows (frag.slang:320-349, the outNormal
    target; ``normal_bins``), blended with ``st`` (seed 0), then
    ``normals_from_blend``. ``use_gut_rows``: the gut3d rows and
    ``pix_ctx``'s rays (HYBRID_3DGUT)."""
    bins = normal_bins(prepared, proj, cam, cfg, st, max_pairs, use_gut_rows)
    out, out_id = rasterize_bins(bins, st, pix_ctx, 0)
    return normals_from_blend(out, out_id, st, cfg)


@dataclasses.dataclass(frozen=True)
class DeferredMaterial:
    """Per-set shading material (SplatSetDesc.material analog)."""

    diffuse: tuple = (1.0, 1.0, 1.0)
    ambient: tuple = (0.1, 0.1, 0.1)
    specular: tuple = (0.0, 0.0, 0.0)
    shininess: float = 32.0
    emission: tuple = (0.0, 0.0, 0.0)


def instance_index_image(splat_id_img: torch.Tensor, instance_base) -> torch.Tensor:
    """(H,W) int32 instance index of each pixel from its picked global
    splat id and the global index table's instance bases (the material
    lookup of deferred_shading.comp.slang:107-124). Pixels with no pick get
    0 (``covered`` masks them downstream)."""
    bases = torch.as_tensor(instance_base, dtype=torch.int32, device=splat_id_img.device)
    sid = torch.clamp(splat_id_img.to(torch.int32), min=0).contiguous()
    idx = torch.searchsorted(bases, sid, right=True) - 1
    return torch.clamp(idx, 0, bases.shape[0] - 2).to(torch.int32)


def _material_fields(material, set_index_img, device):
    """(diffuse, ambient, specular, shininess, emission): constants for one
    DeferredMaterial, or per-pixel gathers from a tuple of them by
    ``set_index_img``."""
    def f32(v):
        # copied behind the stream's work: the shade does not wait for the card
        return torch.as_tensor(v, dtype=torch.float32).to(device, non_blocking=True)

    if isinstance(material, DeferredMaterial):
        return (f32(material.diffuse), f32(material.ambient), f32(material.specular),
                material.shininess, f32(material.emission))
    mats = tuple(material)
    if set_index_img is None:
        raise ValueError("per-set materials need set_index_img "
                         "(instance_index_image of the splat_id pick)")
    idx = torch.clamp(set_index_img.long(), 0, len(mats) - 1)

    def stack(field):
        return f32([getattr(m, field) for m in mats])[idx]

    return (stack("diffuse"), stack("ambient"), stack("specular"), stack("shininess"),
            stack("emission"))


def surface_points(depth_img: torch.Tensor, cam: Camera) -> torch.Tensor:
    """(H,W,3) world positions along the pixel rays at the picked view-space
    depth: camera position + (the pinhole ray scaled by depth) R."""
    h, w = depth_img.shape
    dev = depth_img.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    d_cam = torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                         torch.ones_like(xs)], -1)
    p = d_cam * depth_img[..., None]
    r = cam.viewmat[:3, :3]
    return cam.position + (p[..., 0:1] * r[0] + p[..., 1:2] * r[1] + p[..., 2:3] * r[2])


def deferred_shade(image: torch.Tensor, transmittance: torch.Tensor,
                   normal_img: torch.Tensor, depth_img: torch.Tensor, cam: Camera,
                   cfg: RenderConfig, lights: list[LightSource] | None = None,
                   material: DeferredMaterial | tuple = DeferredMaterial(),
                   shadow_fn=None, set_index_img: torch.Tensor | None = None) -> torch.Tensor:
    """Full-screen lighting pass (deferred_shading.comp.slang:53-160) over
    the (H,W,3) radiance ``image`` at the pixels with a normal and a picked
    depth; the others keep ``image``.

    material: one DeferredMaterial, or a tuple of them (one per instance)
    with ``set_index_img`` (H,W) int32 (``instance_index_image`` of the
    splat-id pick). shadow_fn: optional callable (world_pos (H,W,3), light)
    -> (H,W) or (H,W,3) transmittance toward the light (1 = unshadowed;
    render/shadows.make_shadow_fn)."""
    world_pos = surface_points(depth_img, cam)

    covered = (torch.linalg.norm(normal_img, dim=-1) > 1e-3) & (depth_img > 0)
    normal = normal_img / torch.clamp(_norm(normal_img), min=1e-6)
    view_dir = world_pos - cam.position
    view_dir = view_dir / torch.clamp(_norm(view_dir), min=1e-12)

    base = image
    m_diffuse, m_ambient, m_specular, m_shininess, m_emission = _material_fields(
        material, set_index_img, image.device)
    mat_diffuse = base * m_diffuse
    mat_ambient = base * m_ambient
    emission = base * m_emission

    if not lights:
        lights = [headlight(cam.position)]

    color = emission + mat_ambient
    for light in lights:
        shadow_t = (shadow_fn(world_pos, light) if shadow_fn is not None
                    else torch.ones_like(depth_img))
        # scalar (H, W) shadows or (H, W, 3) coloured transmittance
        if shadow_t.dim() == world_pos.dim() - 1:
            shadow_t = shadow_t[..., None]
        diffuse = mat_diffuse * compute_light(light, world_pos, normal)
        l_vec, _ = light_direction_to(light, world_pos)
        spec = compute_specular(m_specular, m_shininess, view_dir, l_vec, normal)
        color = color + shadow_t * (diffuse + spec * light.color * light.intensity)

    return torch.where(covered[..., None], color, image)
