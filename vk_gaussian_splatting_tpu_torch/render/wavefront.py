"""Wavefront secondary bounces: mesh reflections and refractions through the
splats (counterpart of ``vk_gaussian_splatting_tpu/render/wavefront.py``).

The reference's bounce loop (threedgrt_raytrace.rgen.slang:244-337 and
evaluateLightingAndShadingForBounce :1037-1258) continues a pixel's ray
where the closest mesh hit is reflective (illum 1) or refractive (illum
>= 2), scales the carried transmittance by the material's specular or
transmittance, and traces meshes (closest hit) and particles along the new
ray. Here, as in the JAX module, the secondary rays are one dense batch:
spawned at every raster pixel (or every ``stride``-th) whose mesh face is
reflective or refractive, then a bounce loop of ``max_bounces`` steps, each
one ``trace_mesh`` and one ``trace_splats`` over the whole batch
(ops/raytrace.py), with masks in place of per-ray termination. Spans:
``bounce`` per step, ``trace`` per trace, ``shade`` per mesh shading.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.config import RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu_torch.ops.raytrace import (
    reflect,
    refract_or_reflect,
    trace_mesh,
    trace_splats,
)
from vk_gaussian_splatting_tpu_torch.ops.response import PIX_ROWS, TILE
from vk_gaussian_splatting_tpu_torch.render.mesh_raster import MeshBuffers
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera
from vk_gaussian_splatting_tpu_torch.scene.lights import (
    compute_light,
    compute_specular,
    headlight,
    light_direction_to,
)

EPS_T = 1e-3  # self-hit bias (rgen tMin = 0.001)


def tile_ctx_to_image(ctx: torch.Tensor, cfg: RenderConfig):
    """The (T, 8, 256) pixel context of ``render/rays.build_tile_rays`` back
    in image layout: (dirs (H,W,3), origins (H,W,3))."""
    tx, ty = tiles_x(cfg), tiles_y(cfg)
    blocks = ctx.reshape(ty, tx, PIX_ROWS, TILE, TILE)
    full = blocks.permute(0, 3, 1, 4, 2).reshape(ty * TILE, tx * TILE, PIX_ROWS)
    full = full[:cfg.height, :cfg.width]
    return full[..., 0:3], full[..., 3:6]


def _face_geometric_normals(mesh: MeshBuffers) -> torch.Tensor:
    idx = mesh.indices.long()
    v0 = mesh.positions[idx[:, 0]]
    e1 = mesh.positions[idx[:, 1]] - v0
    e2 = mesh.positions[idx[:, 2]] - v0
    n = torch.linalg.cross(e1, e2)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)


def _shade_mesh_hit(pos, nrm, view_dir, mesh: MeshBuffers, face, lights, cam: Camera,
                    shadow_fn=None):
    """Direct shading at secondary mesh hits: emission, ambient and each
    light's diffuse and specular (wavefrontComputeShadingDirectOnly,
    wavefront.h.slang). pos, nrm, view_dir (R,3); face (R,) (clamped to a
    valid id). shadow_fn must answer scalar (R,) transmittance: a
    per-channel (R, 3) one raises ValueError, as the JAX module's broadcast
    does (ROADMAP.md queue 3)."""
    diffuse = mesh.face_colors[face]
    ambient = mesh.face_ambient[face]
    specular = mesh.face_specular[face]
    shininess = mesh.face_shininess[face]
    radiance = mesh.face_emission[face] + ambient

    lights = list(lights) if lights else [headlight(cam.position)]
    for light in lights:
        l_vec, _ = light_direction_to(light, pos)
        term = diffuse * compute_light(light, pos, nrm)
        spec = compute_specular(specular, shininess, view_dir, l_vec, nrm) \
            * (light.color * light.intensity)
        vis = shadow_fn(pos, light) if shadow_fn is not None else 1.0
        vis = torch.as_tensor(vis, dtype=torch.float32, device=pos.device)
        if vis.dim() > 1:
            raise ValueError(
                f"the bounce shading takes a scalar shadow transmittance per point, got "
                f"{tuple(vis.shape)}: a per-channel (coloured or mesh-occluded) shadow_fn "
                f"does not broadcast here, as in the JAX package")
        radiance = radiance + vis[..., None] * (term + spec)
    return radiance


def _bounce_dispatch(d, nrm, mesh: MeshBuffers, face):
    """New direction, throughput factor and alive mask from the hit face's
    illum model (wavefront.h.slang:336-375)."""
    illum = mesh.face_illum[face]
    spec = mesh.face_specular[face]
    tint = mesh.face_transmittance[face]
    ior = mesh.face_ior[face]

    d_refl = reflect(d, nrm)
    d_refr = refract_or_reflect(d, nrm, ior)
    refractive = (illum >= 2)[:, None]
    new_d = torch.where(refractive, d_refr, d_refl)
    factor = torch.where(refractive, tint, spec)
    alive = illum >= 1
    return new_d, torch.where(alive[:, None], factor, 0.0), alive


def trace_secondary(prepared, cam: Camera, cfg: RenderConfig, mesh: MeshBuffers,
                    origins: torch.Tensor, dirs: torch.Tensor, throughput: torch.Tensor,
                    lights=(), shadow_fn=None, max_bounces: int | None = None) -> torch.Tensor:
    """The bounce loop from spawn points ``origins`` (R,3) along unit
    ``dirs`` (R,3) with carried ``throughput`` (R,3); returns the (R,3)
    radiance to add (already under the throughput)."""
    if max_bounces is None:
        max_bounces = cfg.rt.max_bounces
    face_nrm = _face_geometric_normals(mesh)
    radiance = torch.zeros_like(throughput)
    o, d, thr = origins, dirs, throughput
    r = o.shape[0]

    for _ in range(max_bounces):
        with timing.span("bounce"):
            eps = o.new_full((r,), EPS_T)
            mh = trace_mesh(mesh.positions, mesh.indices, o, d, eps)
            ts = trace_splats(prepared, o, d, eps, mh.t, cfg)
            radiance = radiance + thr * ts.radiance
            thr = thr * ts.transmittance[:, None]

            face = torch.clamp(mh.face, min=0).long()
            hit_pos = o + d * torch.where(mh.hit, mh.t, 0.0)[:, None]
            nrm = face_nrm[face]
            with timing.span("shade"):
                shade = _shade_mesh_hit(hit_pos, nrm, d, mesh, face, lights, cam, shadow_fn)
            radiance = radiance + torch.where(mh.hit[:, None], thr * shade, 0.0)

            new_d, factor, alive = _bounce_dispatch(d, nrm, mesh, face)
            cont = mh.hit & alive
            thr = torch.where(cont[:, None], thr * factor, 0.0)
            live = torch.amax(thr, dim=-1) > cfg.rt.min_transmittance
            thr = torch.where(live[:, None], thr, 0.0)
            o = hit_pos
            d = torch.where(cont[:, None], new_d, d)
    return radiance


def secondary_spawn(cam: Camera, cfg: RenderConfig, mesh: MeshBuffers, face_id: torch.Tensor,
                    splat_trans: torch.Tensor, stride: int = 1):
    """The secondary batch from the raster primary pass: pixels whose mesh
    face (``face_id`` (H,W), -1 = none) is reflective or refractive get a
    ray at the exact ray / face-plane intersection, with the splats'
    transmittance in front of the mesh (``splat_trans`` (H,W)) times the
    face's factor as throughput. Returns (origins, dirs, throughput,
    mask_lr, shape_lr), R = ceil(H / stride) * ceil(W / stride)."""
    dirs_img, orig_img = tile_ctx_to_image(build_tile_rays(cam, cfg), cfg)
    fid = face_id[::stride, ::stride]
    d = dirs_img[::stride, ::stride].reshape(-1, 3)
    o = orig_img[::stride, ::stride].reshape(-1, 3)
    tr = splat_trans[::stride, ::stride].reshape(-1)
    shape_lr = tuple(fid.shape)
    fid = fid.reshape(-1)

    face = torch.clamp(fid, min=0).long()
    illum = mesh.face_illum[face]
    mask = (fid >= 0) & (illum >= 1)

    # exact ray / face-plane intersection (flat faces): t = ((v0 - o).n) / (d.n)
    face_nrm = _face_geometric_normals(mesh)[face]
    v0 = mesh.positions[mesh.indices[face, 0].long()]
    denom = torch.sum(d * face_nrm, dim=-1)
    t = torch.sum((v0 - o) * face_nrm, dim=-1) / torch.where(denom.abs() < 1e-12, 1.0, denom)
    t = torch.where((denom.abs() >= 1e-12) & (t > 0), t, 0.0)
    hit_pos = o + d * t[:, None]

    new_d, factor, _ = _bounce_dispatch(d, face_nrm, mesh, face)
    throughput = torch.where(mask[:, None], tr[:, None] * factor, 0.0)
    return hit_pos, new_d, throughput, mask.reshape(shape_lr), shape_lr


def add_secondary_radiance(image: torch.Tensor, radiance_lr: torch.Tensor, shape_lr,
                           cfg: RenderConfig) -> torch.Tensor:
    """The (R,3) bounce radiance of the ``shape_lr`` grid brought to
    (H,W,3) by nearest-neighbour upsampling with half-pixel centres (the
    JAX ``jax.image.resize(..., "nearest")``) and added to ``image``."""
    h_lr, w_lr = shape_lr
    rad = radiance_lr.reshape(h_lr, w_lr, 3)
    if (h_lr, w_lr) != (cfg.height, cfg.width):
        rad = F.interpolate(rad.permute(2, 0, 1)[None], size=(cfg.height, cfg.width),
                            mode="nearest-exact")[0].permute(1, 2, 0)
    return image + rad
