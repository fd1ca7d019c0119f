"""Mesh rasterization for the mesh-composited frame (counterpart of
``vk_gaussian_splatting_tpu/render/mesh_raster.py``: H9 MeshManagerVk, S16
threedmesh_raster and the FTB mesh prepass of gaussian_splatting.cpp:705-850).

Triangles reuse the splat machinery: they project, bin into tiles through
the pair expansion (each face's 2D bounding box as its rect, one
``max(slots_k, 64)``-slot window per face: no rank ladder), sort by centroid
view depth and blend front to back with an opaque response, so the first
covering face of each pixel wins: a z-buffer as sorted compositing. Two
response models (ops/response.py, ``cfg.raster.mesh_shading``):

- ``"smooth"`` (the default), tri2d_smooth: each vertex lit with its own
  normal (Gouraud, the vertex stage of threedmesh_raster), the colour and
  view depth interpolated perspective-correctly per pixel; forward only;
- ``"flat"``, tri2d: each face lit at its centre, its centroid depth
  picked; its face colours take gradients (K2's tri2d form).

Lighting is the scene's lights (scene/lights.py), a headlight at the camera
where none is given. ``depth_limit_pix_ctx`` turns the mesh depth into the
pixel context of the gs2d_clip splat pass (render/pipelines.py
``render_3dgs_composed``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.config import RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.io.obj import ObjMesh
from vk_gaussian_splatting_tpu_torch.ops.binning import bin_splats
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu_torch.ops.rasterize import (
    PIX,
    TILE,
    RasterStatics,
    assemble_image,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu_torch.ops.response import PIX_DEPTH_LIMIT, PIX_ROWS, MODELS
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera, view_transform_points
from vk_gaussian_splatting_tpu_torch.scene.lights import compute_light, headlight

MESH_SLOTS_K = 64  # the least slot window of a face: triangles often span many tiles
MESH_DEPTH_ISO = 0.999  # opaque faces: the pick records the first covering face


@dataclasses.dataclass
class MeshBuffers:
    """A triangle soup on one device (MeshVk vertex, index and material
    buffers) with the per-face ObjMaterial fields the wavefront bounce
    dispatch reads (wavefront.h:28-50)."""

    positions: torch.Tensor           # (V, 3)
    normals: torch.Tensor             # (V, 3)
    indices: torch.Tensor             # (F, 3) int32
    face_colors: torch.Tensor         # (F, 3) material diffuse per face
    face_emission: torch.Tensor       # (F, 3)
    face_ambient: torch.Tensor        # (F, 3)
    face_specular: torch.Tensor       # (F, 3)
    face_shininess: torch.Tensor      # (F,)
    face_transmittance: torch.Tensor  # (F, 3) refractive filter (illum >= 2)
    face_ior: torch.Tensor            # (F,)
    face_illum: torch.Tensor          # (F,) int32: 0 opaque, 1 mirror, >= 2 glass


def mesh_buffers_from_obj(mesh: ObjMesh, transform: np.ndarray | None = None,
                          device: torch.device | str | None = None) -> MeshBuffers:
    """The mesh's buffers on ``device`` (default: the card). ``transform``,
    a (4, 4) world matrix, moves positions and normals in float64 (normals
    by the inverse transpose, renormalised) before the f32 cast, as the JAX
    function does. An index outside the vertices raises ValueError here,
    on the host (a gather on the card would trip a device-side assertion;
    the JAX gather clamps it)."""
    device = resolve_device(device)
    pos = np.asarray(mesh.positions, np.float32)
    idx = np.asarray(mesh.indices)
    if idx.size and (idx.min() < 0 or idx.max() >= pos.shape[0]):
        raise ValueError(f"face indices span [{idx.min()}, {idx.max()}]; the mesh has "
                         f"{pos.shape[0]} vertices")
    nrm = np.asarray(mesh.normals, np.float32)
    if transform is not None:
        t = np.asarray(transform, np.float64)
        pos = (pos @ t[:3, :3].T + t[:3, 3]).astype(np.float32)
        rinv = np.linalg.inv(t[:3, :3]).T
        nrm = (nrm @ rinv.T).astype(np.float32)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    mats, mi = mesh.materials, mesh.mat_indices

    def per_face(attr, width):
        return torch.as_tensor(np.asarray([getattr(mats[i], attr) for i in mi], np.float32)
                               .reshape(-1, width), device=device)

    def t32(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return MeshBuffers(
        positions=t32(pos), normals=t32(nrm), indices=t32(mesh.indices, np.int32).reshape(-1, 3),
        face_colors=per_face("diffuse", 3), face_emission=per_face("emission", 3),
        face_ambient=per_face("ambient", 3), face_specular=per_face("specular", 3),
        face_shininess=per_face("shininess", 1)[:, 0],
        face_transmittance=per_face("transmittance", 3), face_ior=per_face("ior", 1)[:, 0],
        face_illum=t32([mats[i].illum for i in mi], np.int32))


def _unit_rows(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)


def _project_triangles(mesh: MeshBuffers, cam: Camera, cfg: RenderConfig, lights):
    """Project and shade the faces: (a ProjectedSplats for the binning, xy
    the box centre and radius its half size plus 1 px, colour the flat
    radiance; per-vertex pixel xy (F, 3, 2); per-vertex view z (F, 3);
    per-vertex Gouraud colours (F, 3, 3))."""
    p_view = view_transform_points(cam.viewmat, mesh.positions)      # (V, 3)
    z = p_view[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * p_view[:, 0] / zs + cam.cx
    v = cam.fy * p_view[:, 1] / zs + cam.cy
    uv = torch.stack([u, v], -1)                                      # (V, 2)

    idx = mesh.indices.long()
    tri_uv = uv[idx]                                                  # (F, 3, 2)
    tri_z = z[idx]                                                    # (F, 3)
    depth = tri_z.mean(dim=1)
    valid = (tri_z > cam.near).all(dim=1) & (tri_z < cam.far).all(dim=1)

    lo = tri_uv.amin(dim=1)
    hi = tri_uv.amax(dim=1)
    center = 0.5 * (lo + hi)
    radius = torch.ceil(0.5 * (hi - lo)) + 1.0                        # (F, 2)

    lights = list(lights) if lights else [headlight(cam.position)]

    # per-vertex Gouraud shading (threedmesh_raster.vert.slang): each corner
    # lit with its own normal
    vpos = mesh.positions[idx]                                        # (F, 3, 3)
    vnrm = _unit_rows(mesh.normals[idx])
    base = (mesh.face_emission + 0.1 * mesh.face_colors)[:, None, :]
    vcol = base.expand(vpos.shape)
    for light in lights:
        lit = compute_light(light, vpos.reshape(-1, 3), vnrm.reshape(-1, 3)).reshape(vpos.shape)
        vcol = vcol + mesh.face_colors[:, None, :] * lit

    # flat shading at the face centres
    fnrm = _unit_rows(vnrm.mean(dim=1))
    fpos = vpos.mean(dim=1)
    radiance = mesh.face_emission + 0.1 * mesh.face_colors
    for light in lights:
        radiance = radiance + mesh.face_colors * compute_light(light, fpos, fnrm)

    proj = ProjectedSplats(
        xy=center, conic=center.new_zeros((center.shape[0], 3)), depth=depth,
        radius=torch.where(valid[:, None], radius, 0.0), color=radiance,
        alpha=torch.ones_like(depth), valid=valid)
    return proj, tri_uv, tri_z, vcol


def _tri_attr_rows(tri_uv: torch.Tensor, proj: ProjectedSplats) -> torch.Tensor:
    """(10, F) tri2d rows: absolute vertex xy (the kernels recentre them on
    each tile), the flat radiance, the centroid depth."""
    return torch.stack([tri_uv[:, 0, 0], tri_uv[:, 0, 1], tri_uv[:, 1, 0], tri_uv[:, 1, 1],
                        tri_uv[:, 2, 0], tri_uv[:, 2, 1],
                        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2], proj.depth])


def _tri_smooth_attr_rows(tri_uv: torch.Tensor, tri_z: torch.Tensor,
                          vcol: torch.Tensor) -> torch.Tensor:
    """(18, F) tri2d_smooth rows: absolute vertex xy; the vertices' colours,
    clamped at 0 and rounded to bf16 (to nearest even, the values the JAX
    layout's pack2bf16 words hold), as f32; the vertices' view z."""
    c = torch.clamp(vcol, min=0.0).to(torch.bfloat16).to(torch.float32)
    return torch.stack([tri_uv[:, 0, 0], tri_uv[:, 0, 1], tri_uv[:, 1, 0], tri_uv[:, 1, 1],
                        tri_uv[:, 2, 0], tri_uv[:, 2, 1],
                        *(c[:, k, ch] for k in range(3) for ch in range(3)),
                        tri_z[:, 0], tri_z[:, 1], tri_z[:, 2]])


def mesh_statics(cfg: RenderConfig) -> RasterStatics:
    """The mesh blend's statics: tri2d_smooth or tri2d by
    ``cfg.raster.mesh_shading``, the pick at T < 0.999 (the first covering
    face); never stochastic."""
    smooth = cfg.raster.mesh_shading == "smooth"
    return RasterStatics(tiles_x=tiles_x(cfg), tiles_y=tiles_y(cfg), chunk=cfg.raster.chunk,
                         model="tri2d_smooth" if smooth else "tri2d",
                         depth_iso=MESH_DEPTH_ISO)


def mesh_bins(mesh: MeshBuffers, cam: Camera, cfg: RenderConfig, max_pairs: int = 0,
              lights=()):
    """render_mesh's project and bin stages: (TileBins of the faces, their
    statics)."""
    if cfg.raster.tile_size != TILE:
        raise ValueError("the tile blender requires tile_size == 16")
    st = mesh_statics(cfg)
    with timing.span("project"):
        proj, tri_uv, tri_z, vcol = _project_triangles(mesh, cam, cfg, lights)
    with timing.span("bin"):
        rows = (_tri_smooth_attr_rows(tri_uv, tri_z, vcol) if st.model == "tri2d_smooth"
                else _tri_attr_rows(tri_uv, proj))
        ids = torch.arange(rows.shape[1], dtype=torch.int32, device=rows.device)
        exact = cfg.raster.expansion == "exact"
        bins = bin_splats(proj, rows, ids, tile_size=TILE, tiles_x=st.tiles_x,
                          tiles_y=st.tiles_y, chunk=cfg.raster.chunk,
                          slots_k=max(cfg.raster.slots_k, MESH_SLOTS_K),
                          max_pairs=max_pairs if exact else 0, expansion=cfg.raster.expansion,
                          grad_rows=MODELS[st.model].grad_rows, classes=False)
    return bins, st


def render_mesh(mesh: MeshBuffers, cam: Camera, cfg: RenderConfig, max_pairs: int = 0,
                lights=()):
    """Rasterize a triangle mesh: (colour (H, W, 3) over ``cfg.background``,
    transmittance (H, W), exactly 0 where a face covers the pixel and 1
    elsewhere, depth (H, W) (0 where none), face id (H, W) int32 (-1 where
    none)). Spans project, bin, blend, assemble. Differentiable in the face
    colours through the flat model (K2's tri2d form on a card); the smooth
    model is forward only. max_pairs: the budget of
    ``raster.expansion="exact"``."""
    bins, st = mesh_bins(mesh, cam, cfg, max_pairs, lights)
    with timing.span("blend"):
        out, out_id = rasterize_bins(bins, st)
    with timing.span("assemble"):
        return assemble_image(out, out_id, st.tiles_x, st.tiles_y, cfg.width, cfg.height,
                              cfg.background)


def depth_limit_pix_ctx(depth: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """A (H, W) depth-limit image as the (T, 8, 256) pixel context of the
    gs2d_clip model: row ``PIX_DEPTH_LIMIT`` holds each tile's pixels
    row-major (as csrc/response.cuh loads a pixel), the padding and the
    other rows 0 (no limit). No gradient reaches the depth."""
    tx, ty = tiles_x(cfg), tiles_y(cfg)
    full = depth.new_zeros((ty * TILE, tx * TILE))
    full[:depth.shape[0], :depth.shape[1]] = depth.detach()
    ctx = depth.new_zeros((ty * tx, PIX_ROWS, PIX))
    ctx[:, PIX_DEPTH_LIMIT] = full.reshape(ty, TILE, tx, TILE).permute(0, 2, 1, 3).reshape(
        ty * tx, PIX)
    return ctx
