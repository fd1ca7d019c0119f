"""3DGUT raster frame in plain PyTorch float32.

The method of Wu et al. 2025 (3DGUT, arXiv 2412.12507) as the reference
viewer's 3DGUT shaders state it (threedgut.h.slang, threedgut_camera_
projections.h.slang, threedgrt.h.slang, threedgut_raster.frag.slang), for
a pinhole camera with a global shutter:

- projection by the unscented transform: seven sigma points, the mean and
  mean +- sqrt(3) s_i R[:, i], through the camera; the 2D mean is the mean
  of the six outer points (the centre's weight 0, the others' 1/6), the
  covariance weights the centre 2 and the others 1/6; a 0.3 px dilation.
  A point is in view where z > 0 and it lies inside the image widened by
  10 % of its size on each side; a splat is kept where any point is in
  view, the determinant is not 0 and the opacity is at least 0.01. Its
  extent per axis is min(f sqrt(a), f sqrt(lambda_max)) (a the axis's
  variance), f = min(sqrt(2 ln(o / 0.01)), 3.33), rounded up to whole
  pixels; its tiles those its centre +- the extent reaches;
- colour: as ``gs3d.colour``;
- each tile's splats in ascending view depth of the mean, ties by index;
- blend: each pixel's camera ray (from the camera centre through the pixel
  centre) in the splat's canonical frame, o_c = R^T (o - mu) / s and
  d_c = R^T d / s; the response exp(-|d_c / |d_c| x o_c|^2 / 2) at the
  ray's closest approach; alpha = min(0.999, o resp) where o resp > 1/255
  and resp > 0.0113, else the splat is skipped; termination, colour and
  picks as ``gs3d.blend``.

``count`` counts an evaluation where the response passes its 0.0113
cutoff before the pixel stops: the pixels of the splat's support.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from splatbench.reference import gs3d
from splatbench.reference.gs3d import TILE, rounded

SQRT3 = math.sqrt(3.0)
W_CENTRE_COV = 2.0          # the centre's covariance weight (alpha 1, beta 2, kappa 0)
W_POINT = 1.0 / 6.0         # each outer point's weight
DILATION = 0.3
OPACITY_MIN = 0.01          # the projection's opacity cull and the extent's floor
IN_IMAGE_MARGIN = 0.1
EXTENT_MAX = 3.33
KERNEL_MIN_RESPONSE = 0.0113
ALPHA_MIN = gs3d.ALPHA_MIN
ALPHA_CLAMP = gs3d.ALPHA_CLAMP


@dataclasses.dataclass
class Projected:
    """Per-splat 3D attributes the ray response reads, the tile rectangle,
    and the camera's rays."""

    means: torch.Tensor    # (N, 3)
    scales: torch.Tensor   # (N, 3) linear
    quats: torch.Tensor    # (N, 4) unit (w, x, y, z)
    opacity: torch.Tensor  # (N,)
    rgb: torch.Tensor      # (N, 3)
    depth: torch.Tensor    # (N,) view z of the mean
    rect: torch.Tensor     # (4, N) int64 tiles x0, y0, x1, y1
    dirs: torch.Tensor     # (Hp * Wp, 3) each padded pixel's unit ray direction (world)
    origin: torch.Tensor   # (3,) the camera centre

    def columns(self) -> tuple:
        return (self.means[:, 0], self.means[:, 1], self.means[:, 2], self.scales[:, 0],
                self.scales[:, 1], self.scales[:, 2], self.quats[:, 0], self.quats[:, 1],
                self.quats[:, 2], self.quats[:, 3], self.opacity, self.rgb[:, 0],
                self.rgb[:, 1], self.rgb[:, 2])

    def alpha(self, tiles, tiles_x, lane_ok, mx, my, mz, sx, sy, sz, qw, qx, qy, qz, op):
        """(alpha (n, 256, c) with the cutoffs applied, the support mask)."""
        pix = torch.arange(gs3d.PIX, device=tiles.device)
        row = (tiles // tiles_x)[:, None] * TILE + pix // TILE
        col = (tiles % tiles_x)[:, None] * TILE + pix % TILE
        d = self.dirs[row * (tiles_x * TILE) + col]                      # (n, 256, 3)
        d = [d[..., i, None] for i in range(3)]                          # (n, 256, 1)
        e = [(self.origin[i] - m)[:, None, :] for i, m in enumerate((mx, my, mz))]  # (n, 1, c)
        r = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
             [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
             [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]]
        r = [[x[:, None, :] for x in line] for line in r]
        inv_s = [1.0 / s.clamp(min=1e-12)[:, None, :] for s in (sx, sy, sz)]
        oc = [(r[0][j] * e[0] + r[1][j] * e[1] + r[2][j] * e[2]) * inv_s[j] for j in range(3)]
        dc = [(r[0][j] * d[0] + r[1][j] * d[1] + r[2][j] * d[2]) * inv_s[j] for j in range(3)]
        norm = torch.rsqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2] + 1e-30)
        dh = [x * norm for x in dc]
        cx = dh[1] * oc[2] - dh[2] * oc[1]
        cy = dh[2] * oc[0] - dh[0] * oc[2]
        cz = dh[0] * oc[1] - dh[1] * oc[0]
        resp = torch.exp(-0.5 * (cx * cx + cy * cy + cz * cz))
        a_raw = op[:, None, :] * resp
        support = (resp > KERNEL_MIN_RESPONSE) & lane_ok[:, None, :]
        a = torch.where(support & (a_raw > ALPHA_MIN), torch.clamp(a_raw, max=ALPHA_CLAMP), 0.0)
        return a, support


def rays(pose, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(directions (Hp * Wp, 3), origin (3,)) of the padded pixel grid: the
    pinhole ray through each pixel centre, in world axes."""
    vm = torch.as_tensor(pose.viewmat, device=dev)
    rot, trans = vm[:3, :3], vm[:3, 3]
    wp = -(-pose.width // TILE) * TILE
    hp = -(-pose.height // TILE) * TILE
    ys, xs = torch.meshgrid(torch.arange(hp, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(wp, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    d = torch.stack([(xs - pose.cx) / pose.fx, (ys - pose.cy) / pose.fy, torch.ones_like(xs)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.matmul(d, rot).reshape(-1, 3), -torch.matmul(rot.T, trans)


def project(p: dict, pose, precision: str = "f32") -> Projected:
    """Project the raw splat fields ``p`` (as ``gs3d.project``) by the
    unscented transform. Differentiable in ``p`` through the blend's
    columns; the rectangle and the depth order are not."""
    dev = p["means"].device
    f = {k: rounded(v, precision) for k, v in p.items()}
    vm = torch.as_tensor(pose.viewmat, device=dev)
    rot, trans = vm[:3, :3], vm[:3, 3]
    quats = f["quats"] / torch.linalg.norm(f["quats"], dim=-1, keepdim=True).clamp_min(1e-12)
    scales = torch.exp(f["scales"])
    opacity = torch.sigmoid(f["opacities"])
    with torch.no_grad():
        axes = gs3d.rotation(quats) * (SQRT3 * scales)[:, None, :]    # columns: s_i R[:, i]
        mu = f["means"]
        pts = torch.stack([mu] + [mu + sgn * axes[:, :, i] for i in range(3) for sgn in (1, -1)])
        pc = torch.matmul(pts, rot.T) + trans                          # (7, N, 3)
        x, y, z = pc.unbind(-1)
        zs = torch.where(z <= 1e-8, 1e-8, z)
        u = pose.fx * (x / zs) + pose.cx
        v = pose.fy * (y / zs) + pose.cy
        mw, mh = pose.width * IN_IMAGE_MARGIN, pose.height * IN_IMAGE_MARGIN
        seen = ((z > 0) & (u > -mw) & (v > -mh) & (u < pose.width + mw)
                & (v < pose.height + mh)).any(dim=0)
        cu, cv = u[1:].mean(dim=0), v[1:].mean(dim=0)
        w = torch.tensor([W_CENTRE_COV] + [W_POINT] * 6, device=dev)[:, None]
        du, dv = u - cu, v - cv
        a = (w * du * du).sum(0) + DILATION
        b = (w * du * dv).sum(0)
        c = (w * dv * dv).sum(0) + DILATION
        det = a * c - b * b
        ext = torch.sqrt(2.0 * torch.log(opacity.clamp(min=OPACITY_MIN) / OPACITY_MIN))
        ext = ext.clamp(max=EXTENT_MAX)
        mid = 0.5 * (a + c)
        radius = ext * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01)))
        rx = torch.ceil(torch.minimum(ext * torch.sqrt(a.clamp(min=0.0)), radius))
        ry = torch.ceil(torch.minimum(ext * torch.sqrt(c.clamp(min=0.0)), radius))
        tiles_x, tiles_y = -(-pose.width // TILE), -(-pose.height // TILE)

        def cell(val):
            return torch.floor(val / TILE).to(torch.int64)

        rect = torch.stack([cell(cu - rx).clamp(0, tiles_x), cell(cv - ry).clamp(0, tiles_y),
                            (cell(cu + rx) + 1).clamp(0, tiles_x),
                            (cell(cv + ry) + 1).clamp(0, tiles_y)])
        valid = (seen & (det != 0) & (opacity >= OPACITY_MIN) & (radius > 0)
                 & (torch.maximum(rx, ry) > 0))
        rect = torch.where(valid, rect, 0)
        dirs, origin = rays(pose, dev)
    return Projected(f["means"], rounded(scales, precision), rounded(quats, precision),
                     rounded(opacity, precision), rounded(gs3d.colour(f, rot, trans), precision),
                     z[0], rect, dirs, origin)


def render(p: dict, pose, precision: str = "f32", grad: bool = False, count: bool = False,
           background=(0.0, 0.0, 0.0)) -> gs3d.Frame:
    """The frame of the raw splat fields ``p`` through ``pose``."""
    with torch.set_grad_enabled(grad):
        proj = project(p, pose, precision)
        lists = gs3d.tile_lists(proj, pose.width, pose.height)
        return gs3d.blend(proj, lists, pose.width, pose.height, background, grad=grad,
                          count=count)
