"""Splat shadows: per-light deep shadow maps (counterpart of
``vk_gaussian_splatting_tpu/render/shadows.py``).

The reference traces per-pixel shadow rays through the particle BVH
(rgen:1261-1464: any-hit transmittance toward each light with
``particleShadowOffset`` self-shadow bias). The raster form renders, per
light, a *deep shadow map*: one gs2d pass from the light's viewpoint by the
tile blender's multi-iso form (ops/rasterize.py; K1's ``rasterize_fwd_iso``
on a card), which records per texel the depths at which transmittance
crosses ISO_LEVELS = (0.75, 0.5, 0.25, 0.05): a staircase T(depth). The
deferred pass projects each shade point into the light's frustum and reads
off its level.

- Coloured shadows: ``shadow_tint`` is the reference's per-channel tinting
  after the shadow loop (rgen:1446-1460), fed by the map's normalised
  radiance (its rows 0-2).
- Enclosed point lights: a point light inside the scene's bounding sphere
  gets a six-face cube map (``render_cube_shadow_map``) in place of the
  fitted cone; ``make_shadow_fn`` chooses, reading every light's type and
  distance on the host at once (one synchronisation per frame, where the
  JAX package reads each light's outside jit). The maps' cameras are made
  without waiting for the device (``_const``), so the host stays ahead of
  the card through the maps.
- Budgets and counters: every map bins into one pair budget
  (``max_pairs``, by default ``max(4 N, 2^18)``) and keeps its live pairs
  and its ``overflow`` (``DeepShadowMap.num_pairs``, ``.overflow``);
  ``ShadowMaps`` sums and ors them over a frame's maps. Each map opens the
  child spans ``shadow_map.project``, ``shadow_map.bin`` and
  ``shadow_map.blend``.

Every map bins pairs, blends deterministic gs2d rows at the RasterStatics
defaults (alpha_min, alpha_clamp, qmax, min_transmittance: not the
config's) and projects EWA whatever the pipeline, as the JAX module does.
The sampling functions take ``shadow_offset=0.05`` by default and
``make_shadow_fn`` never passes another, as in the JAX module (it does not
read ``cfg.rt.shadow_offset``).

The per-ray shadows (``make_ray_shadow_fn``, ``rt.shadows="ray"``) trace one
ray per shade point toward each light through the splats
(ops/raytrace.trace_splats) and, given meshes, through their faces
(``trace_mesh``): continuous transmittance, at a trace's cost.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.config import RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.ops.rasterize import (
    ISO_OUT_ROWS,
    RasterStatics,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu_torch.ops.raytrace import trace_mesh, trace_splats
from vk_gaussian_splatting_tpu_torch.ops.response import TILE
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera
from vk_gaussian_splatting_tpu_torch.scene.lights import LightSource, LightType
from vk_gaussian_splatting_tpu_torch.scene.splat_set import PreparedSplats

ISO_LEVELS = (0.75, 0.5, 0.25, 0.05)


def shadow_tint(t, radiance, threshold: float, strength: float):
    """The reference's coloured-shadow post-process (rgen:1446-1460).

    t (...): scalar shadow transmittance; radiance (..., 3): the shadow
    ray's radiance. T in [0, threshold] -> black; (threshold, 1) -> tinted
    by the normalised radiance with ``strength``, fading to no tint at
    scaled T = 1. Returns (..., 3)."""
    t = torch.clamp(t, 0.0, 1.0)
    scaled = torch.clamp((t - threshold) / (1.0 - threshold), 0.0, 1.0)
    max_rad = torch.amax(radiance, dim=-1, keepdim=True)
    norm_color = torch.where(max_rad > 1e-3, radiance / torch.clamp(max_rad, min=1e-3), 1.0)
    s = scaled[..., None]
    mix = 1.0 + (norm_color - 1.0) * (strength * (1.0 - s))
    return torch.clamp(s * mix, 0.0, 1.0)


def scene_bounds(prepared: PreparedSplats):
    """(centre (3,), radius ()) of the splat means' bounding box's sphere."""
    lo = prepared.means.amin(dim=0)
    hi = prepared.means.amax(dim=0)
    center = 0.5 * (lo + hi)
    radius = torch.clamp(torch.linalg.norm(hi - lo) * 0.5, min=1e-3)
    return center, radius


def _matvec(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """r @ v for a (3,3) r and (3,) v as a sum of products (no TF32)."""
    return r[:, 0] * v[0] + r[:, 1] * v[1] + r[:, 2] * v[2]


def _const(values, dev) -> torch.Tensor:
    """float32 ``values`` on ``dev``, copied behind the stream's work: a
    copy from pageable host memory is staged at once and does not wait for
    the device, as a blocking copy would."""
    return torch.tensor(values, dtype=torch.float32).to(dev, non_blocking=True)


def _light_view(r: torch.Tensor, pos: torch.Tensor, f, res: int, near, far) -> Camera:
    """A pinhole camera of rotation rows ``r`` at ``pos``, focal ``f``, centred
    on a res x res map (the JAX ``make_camera``'s other defaults)."""
    dev = r.device
    top = torch.cat([r, (-_matvec(r, pos))[:, None]], dim=1)
    viewmat = torch.cat([top, _const([[0.0, 0.0, 0.0, 1.0]], dev)], dim=0)

    def f32(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32)
        return torch.full((), v, dtype=torch.float32, device=dev)

    return Camera(viewmat=viewmat, fx=f32(f), fy=f32(f), cx=f32(res * 0.5), cy=f32(res * 0.5),
                  near=f32(near), far=f32(far), focus_dist=f32(1.0), aperture=f32(0.0),
                  distortion=torch.zeros((18,), dtype=torch.float32, device=dev),
                  viewmat_end=viewmat)


def light_camera(light: LightSource, center, radius, res: int) -> Camera:
    """Perspective frustum from the light covering the scene bounding
    sphere (a directional light stands 20 radii back along its direction)."""
    is_dir = light.type == LightType.DIRECTIONAL
    dirn = light.direction / torch.clamp(torch.linalg.norm(light.direction), min=1e-9)
    pos = torch.where(is_dir, center - dirn * (20.0 * radius), light.position)

    fwd = center - pos
    dist = torch.clamp(torch.linalg.norm(fwd), min=1e-6)
    fwd = fwd / dist
    dev = fwd.device
    upw = torch.where(torch.abs(fwd[1]) > 0.95, _const([1.0, 0.0, 0.0], dev),
                      _const([0.0, 1.0, 0.0], dev))
    right = torch.linalg.cross(fwd, upw)
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-9)
    down = torch.linalg.cross(fwd, right)
    r = torch.stack([right, down, fwd], dim=0)

    # focal so the bounding sphere fits with margin (tan fov/2 = r*1.1/dist)
    tan_half = torch.clamp(radius * 1.1 / dist, 0.05, 3.0)
    f = 0.5 * res / tan_half
    near = torch.clamp(dist - radius * 1.2, min=1e-3)
    far = dist + radius * 1.2
    return _light_view(r, pos, f, res, near, far)


@dataclasses.dataclass
class DeepShadowMap:
    cam: Camera
    breakpoints: torch.Tensor         # (res, res, 4) depth at T crossing ISO_LEVELS (0 = none)
    tint: torch.Tensor | None = None  # (res, res, 3) normalised radiance (the coloured tint)
    num_pairs: torch.Tensor | None = None  # () live pairs of the map's bins
    overflow: torch.Tensor | None = None   # () bool: the pair budget truncated the map


def shadow_map_bins(prepared: PreparedSplats, cam: Camera, light_cfg: RenderConfig,
                    max_pairs: int):
    """(TileBins, statics) of one map: the EWA projection from ``cam`` at
    ``light_cfg``'s size (span ``shadow_map.project``), gs2d rows binned as
    pairs (``shadow_map.bin``); the statics
    (shadows.py:145-148) gs2d, multi-iso at ISO_LEVELS, the config's chunk
    and the RasterStatics defaults for the rest, never stochastic."""
    from vk_gaussian_splatting_tpu_torch.render.pipelines import (
        bin_for_cfg,
        gs_attr_rows,
        pairs_cfg,
    )

    st = RasterStatics(tiles_x=tiles_x(light_cfg), tiles_y=tiles_y(light_cfg),
                       chunk=light_cfg.raster.chunk, model="gs2d", multi_iso=True,
                       iso_thresholds=ISO_LEVELS)
    with timing.span("shadow_map.project"):
        proj = project_splats(prepared, cam, light_cfg)
    with timing.span("shadow_map.bin"):
        rows, ids = gs_attr_rows(proj)
        return bin_for_cfg(proj, rows, ids, pairs_cfg(light_cfg), max_pairs, st), st


def render_deep_shadow_map(prepared: PreparedSplats, light: LightSource, cfg: RenderConfig,
                           res: int = 512, max_pairs: int | None = None) -> DeepShadowMap:
    """The light's cone map over the scene's bounding sphere, res x res."""
    center, radius = scene_bounds(prepared)
    return _render_dsm_for_camera(prepared, light_camera(light, center, radius, res), cfg, res,
                                  max_pairs)


def _render_dsm_for_camera(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig, res: int,
                           max_pairs: int | None = None) -> DeepShadowMap:
    light_cfg = cfg.replace(width=res, height=res)
    if max_pairs is None:
        max_pairs = max(4 * prepared.means.shape[0], 1 << 18)
    bins, st = shadow_map_bins(prepared, cam, light_cfg, max_pairs)
    with timing.span("shadow_map.blend"):
        out, _ = rasterize_bins(bins, st)
    # every tile is written (an empty one as rgb 0, T 1, depths 0)
    ty, tx = st.tiles_y, st.tiles_x
    full = out.reshape(ty, tx, ISO_OUT_ROWS, TILE, TILE).permute(0, 3, 1, 4, 2)
    full = full.reshape(ty * TILE, tx * TILE, ISO_OUT_ROWS)[:res, :res]
    # rows 0-2: the radiance blended from the light's viewpoint, the
    # coloured-shadow tint source (shadowRadiance, rgen:1409-1441), normalised
    rad = full[..., 0:3]
    max_rad = torch.amax(rad, dim=-1, keepdim=True)
    tint = torch.where(max_rad > 1e-3, rad / torch.clamp(max_rad, min=1e-3), 1.0)
    return DeepShadowMap(cam=cam, breakpoints=full[..., 4:8], tint=tint,
                         num_pairs=bins.num_pairs, overflow=bins.overflow)


def _texels(world_pos: torch.Tensor, dsm: DeepShadowMap):
    """(view z, u, v, texel row, texel column) of world points in the map.
    The texel indices are u and v truncated and clipped to the map, as the
    JAX ``astype(int32)`` then ``clip``; the clamp comes first here, so no
    float outside int32's range is cast (a point behind the light; the
    caller masks those)."""
    cam = dsm.cam
    r, t = cam.viewmat[:3, :3], cam.viewmat[:3, 3]
    p_view = (world_pos[..., 0:1] * r[:, 0] + world_pos[..., 1:2] * r[:, 1]
              + world_pos[..., 2:3] * r[:, 2]) + t
    z = p_view[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = cam.fx * p_view[..., 0] / zs + cam.cx
    v = cam.fy * p_view[..., 1] / zs + cam.cy
    res_y, res_x = dsm.breakpoints.shape[:2]

    def texel(x, n):
        return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, n - 1).to(torch.int64)

    return z, u, v, texel(v, res_y), texel(u, res_x)


def sample_shadow(world_pos: torch.Tensor, dsm: DeepShadowMap,
                  shadow_offset: float = 0.05) -> torch.Tensor:
    """(..., 3) world points -> (...) transmittance toward the light: the
    staircase level of the point's depth less ``shadow_offset`` (the
    particleShadowOffset self-shadow bias); 1 outside the map's frustum."""
    z, u, v, vi, ui = _texels(world_pos, dsm)
    res_y, res_x = dsm.breakpoints.shape[:2]
    bp = dsm.breakpoints[vi, ui]                        # (..., 4)

    zb = z - shadow_offset
    t = torch.ones_like(z)
    for i, level in enumerate(ISO_LEVELS):
        crossed = (bp[..., i] > 0) & (zb > bp[..., i])
        t = torch.where(crossed, level, t)
    # behind the deepest breakpoint: opaque
    deep = (bp[..., 3] > 0) & (zb > bp[..., 3])
    t = torch.where(deep, 0.0, t)
    # outside the frustum (behind the light or off the map): unshadowed
    inside = (z > 0) & (u >= 0) & (u < res_x) & (v >= 0) & (v < res_y)
    return torch.where(inside, t, 1.0)


def sample_shadow_colored(world_pos: torch.Tensor, dsm: DeepShadowMap, threshold: float,
                          strength: float, shadow_offset: float = 0.05) -> torch.Tensor:
    """(..., 3) per-channel transmittance: the staircase T through
    ``shadow_tint`` with the map's normalised-radiance tint."""
    t = sample_shadow(world_pos, dsm, shadow_offset)
    _, _, _, vi, ui = _texels(world_pos, dsm)
    rad = (dsm.tint[vi, ui] if dsm.tint is not None
           else torch.ones(t.shape + (3,), dtype=torch.float32, device=t.device))
    # the tint is stored normalised; shadow_tint only uses the normalised colour
    return shadow_tint(t, rad, threshold, strength)


# face basis (right, down, forward) per +x, -x, +y, -y, +z, -z
_CUBE_AXES = (
    ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
    ((0, 0, 1), (0, 1, 0), (-1, 0, 0)),
    ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
    ((1, 0, 0), (0, 0, 1), (0, -1, 0)),
    ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
)


@dataclasses.dataclass
class CubeShadowMap:
    faces: list  # 6 DeepShadowMaps (+x, -x, +y, -y, +z, -z)


def render_cube_shadow_map(prepared: PreparedSplats, light: LightSource, cfg: RenderConfig,
                           res: int = 256, max_pairs: int | None = None) -> CubeShadowMap:
    """Six deep-shadow-map faces from the light's position, each a little
    wider than 90 degrees (tan(fov/2) = 1.05) so the seams stay covered:
    the enclosed point light a single cone cannot cover."""
    return _cube_map(prepared, light, cfg, res, max_pairs, scene_bounds(prepared)[1])


def _cube_map(prepared, light, cfg, res, max_pairs, radius) -> CubeShadowMap:
    return CubeShadowMap(faces=[_render_dsm_for_camera(prepared, cam, cfg, res, max_pairs)
                                for cam in cube_cameras(light, radius, res)])


def cube_cameras(light: LightSource, radius, res: int) -> list[Camera]:
    """The six face cameras of a cube map at the light's position (+x, -x,
    +y, -y, +z, -z), tan(fov/2) = 1.05, depth range [1e-3, 4 radius]."""
    f = 0.5 * res / 1.05
    return [_light_view(_const(axes, light.position.device), light.position, f, res, 1e-3,
                        4.0 * radius) for axes in _CUBE_AXES]


def sample_shadow_cube(world_pos: torch.Tensor, csm: CubeShadowMap,
                       shadow_offset: float = 0.05) -> torch.Tensor:
    """(..., 3) world points -> (...) transmittance toward the enclosed
    light: each face answers 1 outside its frustum, so the minimum over
    the faces is the covering face's (the seam overlap sees the same
    blockers)."""
    t = torch.ones(world_pos.shape[:-1], dtype=torch.float32, device=world_pos.device)
    for face in csm.faces:
        t = torch.minimum(t, sample_shadow(world_pos, face, shadow_offset))
    return t


@dataclasses.dataclass
class ShadowMaps:
    """``deferred_shade``'s shadow_fn over one map per light
    (``make_shadow_fn``): called as ``shadow_fn(world_pos, light)`` with the
    light objects it was made with (maps are keyed by ``id(light)``)."""

    maps: dict        # id(light) -> DeepShadowMap or CubeShadowMap, in the lights' order
    strength: float   # rt.shadow_color_strength
    threshold: float  # rt.shadow_transmittance_threshold

    def faces(self) -> list:
        """Every map face in the lights' order: a cone map, a cube's six."""
        return [f for m in self.maps.values()
                for f in (m.faces if isinstance(m, CubeShadowMap) else [m])]

    @property
    def num_pairs(self) -> torch.Tensor:
        """() the live pairs of every face, summed."""
        return torch.stack([f.num_pairs for f in self.faces()]).sum()

    @property
    def overflow(self) -> torch.Tensor:
        """() bool: some face's pair budget truncated it."""
        return torch.stack([f.overflow for f in self.faces()]).any()

    def __call__(self, world_pos, light):
        m = self.maps[id(light)]
        if isinstance(m, CubeShadowMap):
            return sample_shadow_cube(world_pos, m)
        if self.strength > 0.0 or self.threshold > 0.0:
            return sample_shadow_colored(world_pos, m, self.threshold, self.strength)
        return sample_shadow(world_pos, m)


def make_shadow_fn(prepared: PreparedSplats, lights, cfg: RenderConfig, res: int = 512,
                   max_pairs: int | None = None) -> ShadowMaps:
    """``deferred_shade``'s shadow_fn: one deep shadow map per light, each
    rendered here under a ``shadow_map`` profiler span, into a pair budget
    of ``max_pairs`` (max(4 N, 2^18) if None) each.

    A POINT light inside the scene's bounding sphere gets a six-face cube
    map of min(res, 256) (the choice reads every light's type and distance
    on the host in one read); the others the fitted cone of res. With
    ``rt.shadow_color_strength`` or ``rt.shadow_transmittance_threshold``
    above 0, a cone map answers (..., 3) coloured transmittance
    (``shadow_tint``)."""
    center, radius = scene_bounds(prepared)
    enclosed = ((torch.stack([light.type for light in lights]) == int(LightType.POINT))
                & (torch.stack([torch.linalg.norm(light.position - center) for light in lights])
                   < radius)).tolist() if lights else []
    maps = {}
    for light, inside in zip(lights, enclosed):
        with timing.span("shadow_map"):
            if inside:
                maps[id(light)] = _cube_map(prepared, light, cfg, min(res, 256), max_pairs,
                                            radius)
            else:
                maps[id(light)] = _render_dsm_for_camera(
                    prepared, light_camera(light, center, radius, res), cfg, res, max_pairs)
    return ShadowMaps(maps, cfg.rt.shadow_color_strength, cfg.rt.shadow_transmittance_threshold)


def make_ray_shadow_fn(prepared: PreparedSplats, cfg: RenderConfig, shadow_offset: float = 0.05,
                       chunk: int = 256, ray_block: int = 2048, meshes=None):
    """Per-ray shadow transmittance (the reference's per-pixel shadow trace,
    rgen:1261-1464; ``rt.shadows="ray"``): one ray per shade point toward
    the light, from ``shadow_offset`` to the light (a directional light:
    unbounded), integrating splat opacity with ``ops/raytrace.trace_splats``
    in radial order. Continuous transmittance (no staircase), and right for
    enclosed point lights.

    With ``rt.shadow_color_strength`` or ``rt.shadow_transmittance_threshold``
    above 0 it answers (..., 3): the scalar T remapped and tinted by the
    ray's splat radiance (``shadow_tint``, rgen:1446-1460). ``meshes`` (a
    MeshBuffers) adds mesh occluders: the closest face hit before the light
    multiplies in its material transmittance (glass casts coloured shadows,
    opaque faces black ones; traceShadowRayMesh, rgen:1295-1340), and the
    answer is (..., 3). Otherwise it answers (...) scalar T."""
    strength = cfg.rt.shadow_color_strength
    threshold = cfg.rt.shadow_transmittance_threshold
    colored = strength > 0.0 or threshold > 0.0

    def shadow_fn(world_pos, light):
        shape = world_pos.shape[:-1]
        p = world_pos.reshape(-1, 3)
        is_dir = light.type == LightType.DIRECTIONAL
        dirn = light.direction / torch.clamp(torch.linalg.norm(light.direction), min=1e-9)
        to_light = torch.where(is_dir, -dirn[None, :], light.position - p)
        dist = torch.linalg.norm(to_light, dim=-1)
        d = to_light / torch.clamp(dist[:, None], min=1e-9)
        t_max = torch.where(is_dir, float("inf"), dist)
        res = trace_splats(prepared, p, d, p.new_full((p.shape[0],), shadow_offset), t_max, cfg,
                           chunk=chunk, ray_block=ray_block, order="radial")
        t = res.transmittance
        if colored:
            out = shadow_tint(t, res.radiance, threshold, strength)
        else:
            out = t[:, None] * torch.ones((1, 3), dtype=torch.float32, device=t.device)
        if meshes is not None:
            hit = trace_mesh(meshes.positions, meshes.indices, p, d,
                             p.new_full((p.shape[0],), 1e-3))
            occluded = hit.hit & (hit.t < t_max - 1e-3)
            mesh_t = torch.where(occluded[:, None],
                                 meshes.face_transmittance[torch.clamp(hit.face, min=0).long()],
                                 1.0)
            out = out * mesh_t
        if not colored and meshes is None:
            return t.reshape(shape)
        return out.reshape(shape + (3,))

    return shadow_fn
