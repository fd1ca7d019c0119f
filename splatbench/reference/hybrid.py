"""The hybrid lit frame (PIPELINE_HYBRID with deep shadow maps) in plain
PyTorch float32.

The frame of the reference viewer's hybrid pipeline as the program under
test renders it with ``rt.shadows="map"``: the 3DGS raster frame
(reference/gs3d.py), its opacity-weighted normal buffer, one deep shadow
map per light and the deferred Phong shade:

- normals: each splat's outward normal by the max-density plane
  (computeEllipsoidNormalMaxDensityPlane, threedgrt.h.slang:358-418): the
  density gradient R diag(1/s^2) R^T (eye - mu); the thin axis where one
  scale is under 1e-3; towards the eye where two or three are; flipped
  towards the eye. The normal buffer is the gs3d blend of the primary's
  lists with the normals as the colour, over black, divided by the
  coverage 1 - T (at least 1e-6) and normalised (at least 1e-6);
- a deep shadow map per light: the gs3d blend from the light's camera,
  recording per texel the depths of the splats after which T first falls
  below 0.75, 0.5, 0.25 and 0.05 (0 where it never does). A spot light, or
  a point light outside the splat means' bounding sphere, gets one square
  map of ``shadow_res`` whose frustum fits that sphere from the light
  (tan(fov/2) = 1.1 radius / distance, depths the distance -+ 1.2 radius);
  a point light inside it gets six cube faces of min(shadow_res, 256),
  tan(fov/2) = 1.05, depths [1e-3, 4 radius];
- the shadow T of a shade point: its depth in a map less the 0.05 shadow
  offset, read against the texel's four depths as a staircase 1, 0.75,
  0.5, 0.25, 0 (past the 0.05 depth, opaque); 1 outside the map; a cube
  light's the least over its faces;
- the shade (deferred_shading.comp.slang:53-160 with computeLight of
  wavefront.h.slang:122-232): at each pixel with a picked depth, the
  world point along its ray at that view depth; colour = 0.1 base + the
  sum over lights of T (base * light colour * intensity * max(n.l, 0) *
  the spot's smoothstep between its outer and inner cones); elsewhere the
  primary image.

Departures from the reference viewer, as in the program: the shadows are
deep shadow maps in place of its any-hit shadow rays through the particle
BVH (rgen:1261-1464), so a shade point's transmittance is a staircase of
four levels and not a continuous one; the shadow offset is 0.05, not the
viewer's configured particleShadowOffset; the material is the port's
default (diffuse 1, ambient 0.1, specular 0, emission 0), so the Phong
specular term, 0, is left out; the lights have no attenuation (mode NONE)
and no range, so only the spot's cone falloff applies. ``count`` returns
the blends' work (gs3d.blend's evaluations, hits, splats hit, pixels) of
the primary, the normal buffer and every map face, and the lights' count.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from splatbench.cameras import Pose
from splatbench.reference import gs3d

ISO_LEVELS = (0.75, 0.5, 0.25, 0.05)
SHADOW_OFFSET = 0.05
AMBIENT = 0.1
THIN = 1e-3
CUBE_TAN = 1.05
CUBE_RES = 256
# face basis (right, down, forward) per +x, -x, +y, -y, +z, -z
CUBE_AXES = (
    ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
    ((0, 0, 1), (0, 1, 0), (-1, 0, 0)),
    ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
    ((1, 0, 0), (0, 0, 1), (0, -1, 0)),
    ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
)


@dataclasses.dataclass(frozen=True)
class Light:
    """A light as plain numbers: ``kind`` "spot" or "point"."""

    kind: str
    position: tuple
    direction: tuple
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    inner_cone_deg: float = 20.0
    outer_cone_deg: float = 30.0


@dataclasses.dataclass
class Face:
    """One square map: its camera (a Pose) and (res, res, 4) depths."""

    pose: Pose
    breakpoints: torch.Tensor


@dataclasses.dataclass
class HybridFrame:
    primary: gs3d.Frame           # the raster frame (image, T, picked depth and splat)
    normals: torch.Tensor         # (H, W, 3) the normal buffer
    shaded: torch.Tensor          # (H, W, 3) the shaded image
    points: torch.Tensor          # (H, W, 3) the shade points' world positions
    covered: torch.Tensor         # (H, W) bool: shaded pixels
    maps: list                    # per light, its faces (one, or a cube's six)
    shadow_t: torch.Tensor        # (lights, H, W) each light's shadow T at the points
    counts: dict | None           # the blends' work with ``count``


def scene_bounds(means: torch.Tensor):
    """(centre (3,), radius ()) of the means' bounding box's sphere."""
    lo, hi = means.amin(dim=0), means.amax(dim=0)
    return 0.5 * (lo + hi), torch.clamp(torch.linalg.norm(hi - lo) * 0.5, min=1e-3)


def _pose(rot: torch.Tensor, pos: torch.Tensor, f, res: int, near, far) -> Pose:
    """A res x res pinhole pose of rotation rows ``rot`` at ``pos``."""
    t = -(rot[:, 0] * pos[0] + rot[:, 1] * pos[1] + rot[:, 2] * pos[2])
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = rot.cpu().numpy()
    viewmat[:3, 3] = t.cpu().numpy()
    return Pose(viewmat, float(f), float(f), res * 0.5, res * 0.5, float(near), float(far),
                res, res)


def cone_pose(light: Light, center, radius, res: int) -> Pose:
    """The map's camera at the light, looking at the sphere's centre and
    fitting it."""
    dev = center.device
    pos = torch.tensor(light.position, dtype=torch.float32, device=dev)
    fwd = center - pos
    dist = torch.clamp(torch.linalg.norm(fwd), min=1e-6)
    fwd = fwd / dist
    up = (1.0, 0.0, 0.0) if abs(float(fwd[1])) > 0.95 else (0.0, 1.0, 0.0)
    right = torch.linalg.cross(fwd, torch.tensor(up, device=dev))
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-9)
    down = torch.linalg.cross(fwd, right)
    tan_half = torch.clamp(radius * 1.1 / dist, 0.05, 3.0)
    return _pose(torch.stack([right, down, fwd]), pos, 0.5 * res / tan_half, res,
                 torch.clamp(dist - radius * 1.2, min=1e-3), dist + radius * 1.2)


def cube_poses(light: Light, radius, res: int) -> list:
    dev = radius.device
    pos = torch.tensor(light.position, dtype=torch.float32, device=dev)
    return [_pose(torch.tensor(axes, dtype=torch.float32, device=dev), pos, 0.5 * res / CUBE_TAN,
                  res, 1e-3, 4.0 * radius) for axes in CUBE_AXES]


def iso_blend(proj, lists: gs3d.Lists, width: int, height: int, count: bool = False,
              lanes: int = 128):
    """((H, W, 4) depths where T first falls below each of ISO_LEVELS, 0
    where it never does; counts or None): gs3d's front-to-back blend of
    every tile's list with four picks in place of its one."""
    dev = proj.depth.device
    ntiles = lists.tiles_x * lists.tiles_y
    tcol = torch.ones((ntiles, gs3d.PIX, 1), device=dev)
    picks = torch.zeros((ntiles, gs3d.PIX, len(ISO_LEVELS)), device=dev)
    picked = torch.zeros((ntiles, gs3d.PIX, len(ISO_LEVELS)), dtype=torch.bool, device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    cols = proj.columns()
    touched = torch.zeros(cols[0].shape[0], dtype=torch.bool, device=dev)
    active = torch.nonzero(lists.count > 0).flatten()
    lane = torch.arange(lanes, device=dev)
    last = max(lists.splat.shape[0] - 1, 0)
    k = 0
    with torch.no_grad():
        while active.numel():
            rel = k * lanes + lane
            lane_ok = rel[None, :] < lists.count[active][:, None]
            sid = lists.splat[(lists.start[active][:, None] + rel).clamp(max=last)]
            _, t_after, a, evaluated, t_before = gs3d._chunk(
                proj.alpha, tcol[active], active, lists.tiles_x, lane_ok,
                *(col[sid] for col in cols))
            tcol.index_copy_(0, active, t_after)
            t_lane = t_before * (1.0 - a)
            got, done = picks[active], picked[active]
            for i, level in enumerate(ISO_LEVELS):
                first = torch.where((t_lane < level) & (a > 0), lane, lanes).amin(dim=-1)
                take = (first < lanes) & ~done[..., i]
                sel = torch.gather(sid, 1, first.clamp(max=lanes - 1))
                got[..., i] = torch.where(take, proj.depth[sel], got[..., i])
                done[..., i] |= take
            picks[active], picked[active] = got, done
            if count:
                evals += evaluated.sum()
                hit = a > 0
                hits += hit.sum()
                touched[sid[hit.any(dim=1)]] = True
            k += 1
            open_ = (tcol[active] > gs3d.MIN_TRANSMITTANCE).any(dim=1)[:, 0]
            active = active[(lists.count[active] > k * lanes) & open_]
    depths = picks.reshape(lists.tiles_y, lists.tiles_x, gs3d.TILE, gs3d.TILE, -1)
    depths = depths.permute(0, 2, 1, 3, 4).reshape(lists.tiles_y * gs3d.TILE,
                                                    lists.tiles_x * gs3d.TILE, -1)
    counts = None
    if count:
        counts = dict(evals=int(evals), hits=int(hits), splats_hit=int(touched.sum()),
                      pixels=width * height)
    return depths[:height, :width], counts


def shadow_map(p: dict, pose: Pose, precision: str = "f32", count: bool = False):
    """(Face, counts) of one map from ``pose``."""
    proj = gs3d.project(p, pose, precision)
    lists = gs3d.tile_lists(proj, pose.width, pose.height)
    depths, counts = iso_blend(proj, lists, pose.width, pose.height, count)
    return Face(pose, depths), counts


def light_maps(p: dict, lights, shadow_res: int, precision: str = "f32",
               count: bool = False):
    """(per light its faces, the faces' counts)."""
    center, radius = scene_bounds(gs3d.rounded(p["means"], precision))
    maps, counts = [], []
    for light in lights:
        inside = light.kind == "point" and float(torch.linalg.norm(
            torch.tensor(light.position, dtype=torch.float32, device=center.device) - center)
        ) < float(radius)
        poses = (cube_poses(light, radius, min(shadow_res, CUBE_RES)) if inside
                 else [cone_pose(light, center, radius, shadow_res)])
        faces = []
        for pose in poses:
            face, c = shadow_map(p, pose, precision, count)
            faces.append(face)
            counts.append(c)
        maps.append(faces)
    return maps, counts


def face_shadow_t(points: torch.Tensor, face: Face) -> torch.Tensor:
    """(...) shadow T of (..., 3) world points in one map: the staircase
    at the point's view depth less SHADOW_OFFSET; 1 outside the map."""
    vm = torch.as_tensor(face.pose.viewmat, device=points.device)
    r, t = vm[:3, :3], vm[:3, 3]
    pv = points[..., 0:1] * r[:, 0] + points[..., 1:2] * r[:, 1] + points[..., 2:3] * r[:, 2] + t
    z = pv[..., 2]
    zs = torch.clamp(z, min=1e-6)
    u = face.pose.fx * pv[..., 0] / zs + face.pose.cx
    v = face.pose.fy * pv[..., 1] / zs + face.pose.cy
    res_y, res_x = face.breakpoints.shape[:2]

    def texel(x, n):
        return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, n - 1).to(torch.int64)

    bp = face.breakpoints[texel(v, res_y), texel(u, res_x)]
    zb = z - SHADOW_OFFSET
    out = torch.ones_like(z)
    for i, level in enumerate(ISO_LEVELS[:-1]):
        out = torch.where((bp[..., i] > 0) & (zb > bp[..., i]), level, out)
    out = torch.where((bp[..., -1] > 0) & (zb > bp[..., -1]), 0.0, out)
    inside = (z > 0) & (u >= 0) & (u < res_x) & (v >= 0) & (v < res_y)
    return torch.where(inside, out, 1.0)


def light_shadow_t(points: torch.Tensor, faces: list) -> torch.Tensor:
    """A light's shadow T: its one map's, or the least over a cube's faces."""
    out = face_shadow_t(points, faces[0])
    for face in faces[1:]:
        out = torch.minimum(out, face_shadow_t(points, face))
    return out


def splat_normals(p: dict, eye: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(N, 3) outward normals by the max-density plane (module docstring)."""
    means = gs3d.rounded(p["means"], precision)
    scl = torch.exp(gs3d.rounded(p["scales"], precision))
    rot = gs3d.rotation(gs3d.rounded(p["quats"], precision))
    local = eye - means
    small = scl < THIN
    n_small = small.sum(dim=-1)
    canon = torch.einsum("ni,nij->nj", local, rot)
    grad = torch.einsum("nj,nij->ni", canon / torch.clamp(scl * scl, min=1e-20), rot)
    n_grad = grad / torch.clamp(torch.linalg.norm(grad, dim=-1, keepdim=True), min=1e-12)
    axis = torch.argmax(small.to(torch.int32), dim=-1)
    n_flat = torch.gather(rot, 2, axis[:, None, None].expand(-1, 3, 1))[..., 0]
    n_flat = n_flat / torch.clamp(torch.linalg.norm(n_flat, dim=-1, keepdim=True), min=1e-12)
    n_view = local / torch.clamp(torch.linalg.norm(local, dim=-1, keepdim=True), min=1e-12)
    n = torch.where((n_small == 0)[:, None], n_grad,
                    torch.where((n_small == 1)[:, None], n_flat, n_view))
    flip = torch.sign((n * local).sum(dim=-1, keepdim=True))
    return n * torch.where(flip == 0, 1.0, flip)


def eye_of(pose: Pose, device) -> torch.Tensor:
    vm = torch.as_tensor(pose.viewmat, device=device)
    r, t = vm[:3, :3], vm[:3, 3]
    return -(r[0] * t[0] + r[1] * t[1] + r[2] * t[2])


def surface_points(depth: torch.Tensor, pose: Pose) -> torch.Tensor:
    """(H, W, 3) world points along the pixel rays at the view depth."""
    h, w = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    ray = torch.stack([(xs - pose.cx) / pose.fx, (ys - pose.cy) / pose.fy,
                       torch.ones_like(xs)], -1) * depth[..., None]
    r = torch.as_tensor(pose.viewmat, device=dev)[:3, :3]
    return eye_of(pose, dev) + ray[..., 0:1] * r[0] + ray[..., 1:2] * r[1] + ray[..., 2:3] * r[2]


def light_term(light: Light, points: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """(..., 3) colour * intensity * max(n.l, 0) * the spot's falloff."""
    dev = points.device
    to_light = torch.tensor(light.position, dtype=torch.float32, device=dev) - points
    dist = torch.linalg.norm(to_light, dim=-1)
    l_vec = to_light / torch.clamp(dist, min=1e-12)[..., None]
    ndotl = torch.clamp((normals * l_vec).sum(dim=-1), min=0.0)
    if light.kind == "spot":
        axis = torch.tensor(light.direction, dtype=torch.float32, device=dev)
        axis = axis / torch.clamp(torch.linalg.norm(axis), min=1e-12)
        cos_theta = (l_vec * -axis).sum(dim=-1)
        inner = math.cos(math.radians(light.inner_cone_deg))
        outer = math.cos(math.radians(light.outer_cone_deg))
        s = torch.clamp((cos_theta - outer) / max(inner - outer, 1e-6), 0.0, 1.0)
        ndotl = ndotl * (s * s * (3.0 - 2.0 * s))
    colour = torch.tensor(light.color, dtype=torch.float32, device=dev) * light.intensity
    return colour * ndotl[..., None]


def render(p: dict, pose: Pose, lights=(), shadow_res: int = 512, precision: str = "f32",
           count: bool = False, background=(0.0, 0.0, 0.0)) -> HybridFrame:
    """The hybrid frame of the raw splat fields ``p`` through ``pose`` lit by
    ``lights`` (``Light``s)."""
    with torch.no_grad():
        proj = gs3d.project(p, pose, precision)
        lists = gs3d.tile_lists(proj, pose.width, pose.height)
        primary = gs3d.blend(proj, lists, pose.width, pose.height, background, count=count)
        dev = proj.depth.device
        proj_n = dataclasses.replace(proj, rgb=splat_normals(p, eye_of(pose, dev), precision))
        nrm = gs3d.blend(proj_n, lists, pose.width, pose.height, count=count)
        del proj, proj_n, lists
        normals = nrm.image / torch.clamp(1.0 - nrm.transmittance, min=1e-6)[..., None]
        normals = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True),
                                        min=1e-6)
        maps, map_counts = light_maps(p, lights, shadow_res, precision, count)
        points = surface_points(primary.depth, pose)
        covered = (torch.linalg.norm(normals, dim=-1) > 1e-3) & (primary.depth > 0)
        base = primary.image
        colour = AMBIENT * base
        shadow_t = []
        for light, faces in zip(lights, maps):
            t = light_shadow_t(points, faces)
            shadow_t.append(t)
            colour = colour + t[..., None] * (base * light_term(light, points, normals))
        shaded = torch.where(covered[..., None], colour, base)
        counts = None
        if count:
            counts = dict(primary=primary.counts, normals=nrm.counts, maps=map_counts,
                          lights=len(lights))
        return HybridFrame(primary, normals, shaded, points, covered, maps,
                           torch.stack(shadow_t) if shadow_t else torch.ones((0,) + covered.shape,
                                                                             device=dev),
                           counts)
