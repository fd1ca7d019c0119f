"""3DGS raster frame in plain PyTorch float32.

The method of Kerbl et al. 2023 (3D Gaussian Splatting) as the reference
viewer's raster shaders state it (threedgs.h.slang, dist.comp.slang,
threedgs_raster.frag.slang):

- projection: world to camera, the EWA covariance J W S W^T J^T with the
  Jacobian's x/z, y/z clamped to 1.3 tan(fov), a 0.3 px low-pass
  dilation, the conic its inverse; the centre culled outside the near and
  far planes and outside the NDC square dilated by 0.2, and where the
  dilated covariance is degenerate or the opacity is under 1/255;
- colour: the base colour 0.5 + C0 * f_dc clamped to [0, 1], plus the SH
  radiance of degrees 1-3 along the camera-to-splat direction, clamped at 0;
- binning: every 16x16 tile that the support's bounding box touches, the
  support being the ellipse where the Gaussian's exponent d <= 8 (sqrt(8)
  standard deviations), its half-extent clamped to 2048 px; each tile's
  splats in ascending view depth, ties by splat index;
- blend: per pixel, front to back, alpha = min(0.999, o exp(-d / 2)) where
  d <= 8 and o exp(-d / 2) >= 1/255, else the splat is skipped; a pixel
  stops at the first splat met with transmittance T <= 1e-4; the colour is
  sum(alpha T_before rgb) + T background; the picked depth and splat id are
  those of the first splat after which T < 0.7.

The blend walks every tile's list in chunks of lanes, vectorized over the
tiles that still have work. With ``grad`` each chunk is checkpointed, so
autograd keeps only each chunk's inputs. ``count`` also returns the work a
blend with per-pixel termination needs: the (pixel, splat) evaluations
inside supports before termination, the hits (those that blend) and the
splats with a hit.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

TILE = 16
PIX = TILE * TILE
DILATION = 0.3
FRUSTUM_DILATION = 0.2
JACOBIAN_LIMIT = 1.3
QMAX = 8.0
MAX_BASIS_PX = 2048.0
ALPHA_MIN = 1.0 / 255.0
ALPHA_CLAMP = 0.999
MIN_TRANSMITTANCE = 1e-4
DEPTH_ISO = 0.7
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as stored at ``precision``: itself for "f32", rounded through
    bfloat16 for "bf16" (the control's storage; arithmetic stays f32)."""
    if precision == "f32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """(N, 15) real SH basis of degrees 1-3 at unit directions (N, 3), in
    the reference viewer's coefficient order and signs."""
    x, y, z = d.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy),
    ], dim=-1)


def rotation(quats: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of (w, x, y, z) quaternions, normalized first."""
    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def colour(f: dict, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(N, 3): the base colour 0.5 + C0 f_dc clamped to [0, 1] plus the SH
    radiance of degrees 1-3 along the camera-to-splat direction, clamped at
    0 (the camera's rotation and translation given)."""
    eye = -torch.matmul(rot.T, trans)
    dirs = f["means"] - eye
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
    base = torch.clamp(0.5 + SH_C0 * f["sh_dc"], 0.0, 1.0)
    rest = (sh_basis(dirs)[:, :, None] * f["sh_rest"]).sum(dim=1)
    return torch.clamp(base + rest, min=0.0)


@dataclasses.dataclass
class Projected:
    """Per-splat screen attributes and support rectangle (tiles [x0, x1) x [y0, y1))."""

    xy: torch.Tensor       # (N, 2)
    conic: torch.Tensor    # (N, 3) a, b, c of the inverse dilated covariance
    opacity: torch.Tensor  # (N,)
    rgb: torch.Tensor      # (N, 3)
    depth: torch.Tensor    # (N,) view z
    rect: torch.Tensor     # (4, N) int64 x0, y0, x1, y1

    def columns(self) -> tuple:
        """The per-splat columns the blend gathers per lane: the response's
        (``alpha``'s arguments), then r, g, b."""
        return (self.xy[:, 0], self.xy[:, 1], self.conic[:, 0], self.conic[:, 1],
                self.conic[:, 2], self.opacity, self.rgb[:, 0], self.rgb[:, 1], self.rgb[:, 2])

    @staticmethod
    def alpha(tiles, tiles_x, lane_ok, xs, ys, ca, cb, cc, op):
        """(alpha (n, 256, c) with the cutoffs applied, the support mask):
        the 2D conic Gaussian, d <= 8 and o exp(-d / 2) >= 1/255."""
        px, py = pixel_centres(tiles, tiles_x)
        dx = px - xs[:, None, :]
        dy = py - ys[:, None, :]
        d = ca[:, None, :] * dx * dx + 2.0 * cb[:, None, :] * dx * dy + cc[:, None, :] * dy * dy
        a_raw = op[:, None, :] * torch.exp(-0.5 * d)
        support = (d <= QMAX) & lane_ok[:, None, :]
        a = torch.where(support & (a_raw >= ALPHA_MIN), torch.clamp(a_raw, max=ALPHA_CLAMP), 0.0)
        return a, support


def project(p: dict, pose, precision: str = "f32") -> Projected:
    """Project the raw splat fields ``p`` (means, log scales, quaternions,
    logit opacities, f_dc, f_rest (N, 15, 3)) through ``pose``
    (splatbench.cameras.Pose). Differentiable in ``p``."""
    dev = p["means"].device
    f = {k: rounded(v, precision) for k, v in p.items()}
    vm = torch.as_tensor(pose.viewmat, device=dev)
    rot, trans = vm[:3, :3], vm[:3, 3]
    pv = torch.matmul(f["means"], rot.T) + trans
    x, y, z = pv.unbind(-1)
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = pose.fx * x / zs + pose.cx
    v = pose.fy * y / zs + pose.cy

    # EWA: J (W S W^T) J^T, S = M M^T with M = R diag(scale)
    m = rotation(f["quats"]) * torch.exp(f["scales"])[:, None, :]
    cov3 = torch.matmul(m, m.transpose(1, 2))
    lim_x = JACOBIAN_LIMIT * 0.5 * pose.width / pose.fx
    lim_y = JACOBIAN_LIMIT * 0.5 * pose.height / pose.fy
    tx = torch.clamp(x / zs, -lim_x, lim_x) * zs
    ty = torch.clamp(y / zs, -lim_y, lim_y) * zs
    zero = torch.zeros_like(zs)
    jac = torch.stack([pose.fx / zs, zero, -pose.fx * tx / (zs * zs),
                       zero, pose.fy / zs, -pose.fy * ty / (zs * zs)], -1).reshape(-1, 2, 3)
    t = torch.matmul(jac, rot)
    cov2 = torch.matmul(torch.matmul(t, cov3), t.transpose(1, 2))
    a = cov2[:, 0, 0] + DILATION
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATION
    det = a * c - b * b
    det_safe = torch.where(det <= 0, 1.0, det)
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)
    mid = 0.5 * (a + c)
    lam2 = mid - torch.sqrt(torch.clamp(mid * mid - det, min=0.1))

    opacity = torch.sigmoid(f["opacities"])
    ndc_x = (u - pose.cx) / (0.5 * pose.width)
    ndc_y = (v - pose.cy) / (0.5 * pose.height)
    clip = 1.0 + FRUSTUM_DILATION
    valid = ((z > pose.near) & (z < pose.far) & (torch.abs(ndc_x) <= clip)
             & (torch.abs(ndc_y) <= clip) & (det > 0) & (lam2 > 0) & (opacity >= ALPHA_MIN))

    rgb = colour(f, rot, trans)

    # the support's bounding box, with a pixel of margin, in tiles
    with torch.no_grad():
        hx = torch.sqrt(torch.where(valid, QMAX * a, 0.0)).clamp(max=MAX_BASIS_PX)
        hy = torch.sqrt(torch.where(valid, QMAX * c, 0.0)).clamp(max=MAX_BASIS_PX)
        uu = torch.where(valid, u, 0.0)
        vv = torch.where(valid, v, 0.0)
        tiles_x = -(-pose.width // TILE)
        tiles_y = -(-pose.height // TILE)

        def cell(val, hi):
            return torch.floor(val / TILE).to(torch.int64).clamp(0, hi)

        rect = torch.stack([cell(uu - hx - 1.5, tiles_x), cell(vv - hy - 1.5, tiles_y),
                            cell(uu + hx + 0.5, tiles_x - 1) + 1,
                            cell(vv + hy + 0.5, tiles_y - 1) + 1])
        rect = torch.where(valid, rect, 0)
    return Projected(torch.stack([u, v], -1), rounded(conic, precision),
                     rounded(opacity, precision), rounded(rgb, precision), z, rect)


@dataclasses.dataclass
class Lists:
    """Each tile's splats in depth order: ``splat[start[t]:start[t] + count[t]]``."""

    splat: torch.Tensor   # (P,) int64
    start: torch.Tensor   # (T,) int64
    count: torch.Tensor   # (T,) int64
    tiles_x: int
    tiles_y: int


def tile_lists(proj, width: int, height: int) -> Lists:
    """Expand every splat into the tiles of its rectangle and order each
    tile's list by depth (ties by splat index: a stable sort of pairs made
    in splat order)."""
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    x0, y0, x1, y1 = proj.rect
    w = (x1 - x0).clamp(min=0)
    counts = w * (y1 - y0).clamp(min=0)
    n = counts.shape[0]
    splat = torch.repeat_interleave(torch.arange(n, device=counts.device), counts)
    starts = torch.cumsum(counts, 0) - counts
    r = torch.arange(splat.shape[0], device=counts.device) - starts[splat]
    ws = w[splat]
    tile = (y0[splat] + r // ws) * tiles_x + x0[splat] + r % ws
    by_depth = torch.sort(proj.depth.detach()[splat], stable=True).indices
    order = by_depth[torch.sort(tile[by_depth], stable=True).indices]
    tile = tile[order]
    ntiles = tiles_x * tiles_y
    count = torch.bincount(tile, minlength=ntiles)
    start = torch.cumsum(count, 0) - count
    return Lists(splat[order], start, count, tiles_x, tiles_y)


def _chunk(alpha, tcol, tiles, tiles_x, lane_ok, *cols):
    """One chunk of lanes over a set of tiles: (rgb contribution (n, 256, 3),
    T after it (n, 256, 1), the masked alpha (n, 256, c), the support mask
    where the pixel was still blending, the transmittance before each lane).
    ``cols``: the lanes' response columns, then r, g, b."""
    a, support = alpha(tiles, tiles_x, lane_ok, *cols[:-3])
    cr, cg, cbl = cols[-3:]
    q = 1.0 - a
    excl = torch.cat([torch.ones_like(q[..., :1]), torch.cumprod(q, dim=-1)[..., :-1]], -1)
    t_before = tcol * excl
    alive = t_before > MIN_TRANSMITTANCE
    a = torch.where(alive, a, 0.0)
    w = a * t_before
    rgb = torch.stack([(w * cr[:, None, :]).sum(-1), (w * cg[:, None, :]).sum(-1),
                       (w * cbl[:, None, :]).sum(-1)], -1)
    t_after = tcol * torch.prod(1.0 - a, dim=-1, keepdim=True)
    return rgb, t_after, a, support & alive, t_before


def _chunk_grad(*args):
    rgb, t_after, *_ = _chunk(*args)
    return rgb, t_after


def pixel_centres(tiles: torch.Tensor, tiles_x: int):
    pix = torch.arange(PIX, device=tiles.device)
    px = ((tiles % tiles_x)[:, None] * TILE + pix % TILE).float() + 0.5
    py = ((tiles // tiles_x)[:, None] * TILE + pix // TILE).float() + 0.5
    return px[..., None], py[..., None]


@dataclasses.dataclass
class Frame:
    image: torch.Tensor          # (H, W, 3)
    transmittance: torch.Tensor  # (H, W)
    depth: torch.Tensor | None   # (H, W) picked depth, 0 where none
    splat_id: torch.Tensor | None  # (H, W) int64 picked splat, -1 where none
    counts: dict | None


def blend(proj, lists: Lists, width: int, height: int, background=(0.0, 0.0, 0.0),
          grad: bool = False, count: bool = False, lanes: int = 32) -> Frame:
    """Front-to-back blend of every tile's list (module docstring) with the
    response of ``proj`` (``Projected`` here, ``gut3d.Projected``): its
    ``columns()``, ``alpha`` and ``depth``. With ``grad`` the image and T
    are differentiable in the columns, and no picks are made."""
    dev = proj.depth.device
    ntiles = lists.tiles_x * lists.tiles_y
    acc = torch.zeros((ntiles, PIX, 3), device=dev)
    tcol = torch.ones((ntiles, PIX, 1), device=dev)
    pick_d = torch.zeros((ntiles, PIX), device=dev)
    pick_id = torch.full((ntiles, PIX), -1, dtype=torch.int64, device=dev)
    picked = torch.zeros((ntiles, PIX), dtype=torch.bool, device=dev)
    evals = torch.zeros((), dtype=torch.int64, device=dev)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    cols = proj.columns()
    touched = torch.zeros(cols[0].shape[0], dtype=torch.bool, device=dev)
    active = torch.nonzero(lists.count > 0).flatten()
    lane = torch.arange(lanes, device=dev)
    last = max(lists.splat.shape[0] - 1, 0)
    k = 0
    while active.numel():
        rel = k * lanes + lane
        lane_ok = rel[None, :] < lists.count[active][:, None]
        sid = lists.splat[(lists.start[active][:, None] + rel).clamp(max=last)]
        args = ((proj.alpha, tcol[active], active, lists.tiles_x, lane_ok)
                + tuple(col[sid] for col in cols))
        if grad:
            rgb, t_after = checkpoint(_chunk_grad, *args, use_reentrant=False)
            acc = acc.index_add(0, active, rgb)
            tcol = tcol.index_copy(0, active, t_after)
        else:
            with torch.no_grad():
                rgb, t_after, a, evaluated, t_before = _chunk(*args)
                acc.index_add_(0, active, rgb)
                tcol.index_copy_(0, active, t_after)
                cond = (t_before * (1.0 - a) < DEPTH_ISO) & (a > 0)
                first = torch.where(cond, lane, lanes).amin(dim=-1)
                take = (first < lanes) & ~picked[active]
                fl = first.clamp(max=lanes - 1)
                sel = torch.gather(sid, 1, fl)
                pick_id[active] = torch.where(take, sel, pick_id[active])
                pick_d[active] = torch.where(take, proj.depth[sel], pick_d[active])
                picked[active] |= take
                if count:
                    evals += evaluated.sum()
                    hit = a > 0
                    hits += hit.sum()
                    touched[sid[hit.any(dim=1)]] = True
        k += 1
        open_ = (tcol[active] > MIN_TRANSMITTANCE).any(dim=1)[:, 0]
        more = (lists.count[active] > k * lanes) & open_
        active = active[more]

    def image(x, ch):
        x = x.reshape(lists.tiles_y, lists.tiles_x, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
        return x.reshape(lists.tiles_y * TILE, lists.tiles_x * TILE, ch)[:height, :width]

    t_img = image(tcol, 1)
    img = image(acc, 3) + t_img * torch.as_tensor(background, dtype=torch.float32, device=dev)
    counts = None
    if count:
        counts = dict(evals=int(evals), hits=int(hits), splats_hit=int(touched.sum()),
                      pixels=width * height)
    if grad:
        return Frame(img, t_img[..., 0], None, None, None)
    return Frame(img, t_img[..., 0], image(pick_d[..., None], 1)[..., 0],
                 image(pick_id[..., None], 1)[..., 0], counts)


def render(p: dict, pose, precision: str = "f32", grad: bool = False, count: bool = False,
           background=(0.0, 0.0, 0.0)) -> Frame:
    """The frame of the raw splat fields ``p`` through ``pose``."""
    with torch.set_grad_enabled(grad):
        proj = project(p, pose, precision)
        lists = tile_lists(proj, pose.width, pose.height)
        return blend(proj, lists, pose.width, pose.height, background, grad=grad, count=count)
