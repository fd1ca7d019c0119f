"""The response models the tile blenders evaluate, gs2d and gut3d
(counterpart of ``vk_gaussian_splatting_tpu/ops/response.py:31-51,112-154,
395-445`` and ``ops/raytrace.py:135-141``).

- ``gs2d``: projected 2D conic Gaussian (threedgs_raster.frag.slang:236-255):
  d = (p-mu)' conic (p-mu), response = exp(-0.5 d), discard d > qmax, keep
  only alpha >= alpha_min, clamp at alpha_clamp.
- ``gut3d``: the exact 3D ray-particle response of 3DGUT rasterization and
  3DGRT (threedgrt.h.slang:57-127): the pixel's camera ray transforms into
  the particle's canonical frame, and the generalized-Gaussian kernel of
  ``kernel_degree`` evaluates at the ray's minimum squared distance; keep
  only alpha > alpha_min and response > kernel_min_response.

This module is the plain reference of the math that the CUDA tile blenders
(csrc/response.cuh, used by csrc/rasterize_{fwd,bwd}.cu and
csrc/raster_bucket_{fwd,bwd}.cu) evaluate, with the hand-derived VJPs their
backwards need, and of the per-tile cull K2, K3 and K4 share
(``tile_bound``, ``may_hit``) and K1 asks per warp (``warp_bound``,
``WARP_PIXELS``). The JAX kernels take those VJPs with in-kernel
``jax.vjp``.
The packed models gs2dp and gut3dp (``RasterConfig.pair_format="packed"``,
the JAX ``response.py:60-109,201-264``) are the same two responses on
fewer rows, forward only. The mesh-composited frame adds three more (the
JAX ``response.py:157-169,267-393``): gs2d_clip, gs2d behind a per-pixel
depth limit, and the opaque triangles tri2d (flat colour) and tri2d_smooth
(a perspective-correct Gouraud colour and view depth per pixel; forward
only).

Attribute rows, shape (rows, P) f32:
  gs2d : 0 x, 1 y, 2-4 conic (a, b, c), 5 opacity, 6-8 rgb, 9 depth
  gut3d: 0-2 position, 3-5 scale (linear), 6-8 rgb, 9-12 quat (w, x, y, z,
         unit), 13 opacity, 14 depth
  gs2d_clip: gs2d's rows; its alpha is gs2d's, zeroed where the pixel's
         depth limit (pixel-context row 6, ``PIX_DEPTH_LIMIT``) is > 0 and
         the splat's depth is not below it
  tri2d: 0-5 vertex xy (absolute pixels), 6-8 flat rgb, 9 centroid depth
  tri2d_smooth: 0-5 vertex xy, 6-14 the three vertices' rgb (vertex-major,
         each value rounded to bf16 as the JAX layout's packed words round
         it, kept as an f32), 15-17 the vertices' view z
Color rows are 6-8 in gs2d, gut3d and tri2d (the blender contracts them);
tri2d_smooth's colour and picked depth are per pixel (``pixel_attrs``). The
depth row is the aux pick and the bucket merge key, and gets no gradient. Where
``RasterStatics.key_is_row`` is set (the host-sorted bucket frame), gs2d
rows carry one row more, the key row 10 (``GS_KEY``, the JAX ``KEY_ROW``):
the host sorter's rank, on which the bucket kernels merge in place of the
depth row; it lies past ``grad_rows`` and gets no gradient. The splat id
does not ride as a float row (the JAX layouts' f32 id rows): it travels
beside the rows as its own int32 array, exact for every id.

Packed rows (the reference's fp16 SH-format tier): most attributes ride as
two bf16 halves of one word (``pack2bf16``), opacity as 16-bit fixed point
beside bf16 blue (``pack_bf16_u16``); positions and the sort depth stay
exact f32, and the sort depth is the model's depth row (``pack_rows``
makes them from the parent's f32 rows):
  gs2dp : 0 x, 1 y, 2 (a, b), 3 (c, depth), 4 (r, g), 5 (b, opacity),
          6 sort depth
  gut3dp: 0-2 position, 3 (sx, sy), 4 (sz, qw), 5 (qx, qy), 6 (qz, depth),
          7 (r, g), 8 (b, opacity), 9 sort depth
A packed word is a bit pattern: binning and the twins only move it (a word
whose high half is +-0 is an f32 subnormal, and any arithmetic could flush
it). ``unpack_rows`` turns packed rows into the parent model's f32 rows
(the quaternion renormalised as the JAX ``gut3dp_alpha`` does), and every
twin of a packed model is ``unpack_rows`` followed by the parent's twin.

The gut3d model reads a per-tile pixel context (T, 8, 256): rows 0-2 the
unit ray direction, 3-5 the ray origin (render/rays.py); gs2d_clip reads
row 6, the depth limit (<= 0: none; render/mesh_raster.depth_limit_pix_ctx).

The triangles are opaque: alpha is exactly 1 inside (the edge functions on
tile-recentred coordinates, either winding, each edge pushed out by 0.05
of its L1 length) and 0 outside, never clamped at alpha_clamp, so the
first covering face of a depth-sorted list takes T to exactly 0: a
z-buffer as front-to-back blending. Their coverage has no gradient.
"""

from __future__ import annotations

import dataclasses

import torch

GS_X, GS_Y, GS_CA, GS_CB, GS_CC, GS_OPACITY = 0, 1, 2, 3, 4, 5
ATTR_R, ATTR_G, ATTR_B = 6, 7, 8
GS_DEPTH = 9
GS_ROWS = 10
GS_KEY = GS_ROWS  # the host order's rank row (key_is_row): one row after the model's

GUT_PX, GUT_PY, GUT_PZ = 0, 1, 2
GUT_SX, GUT_SY, GUT_SZ = 3, 4, 5
GUT_QW, GUT_QX, GUT_QY, GUT_QZ = 9, 10, 11, 12
GUT_OPACITY, GUT_DEPTH = 13, 14
GUT_ROWS = 15

# pixel-context rows, in the (8, 256) per-tile block
RAY_DX, RAY_DY, RAY_DZ, RAY_OX, RAY_OY, RAY_OZ = 0, 1, 2, 3, 4, 5
PIX_DEPTH_LIMIT = 6  # gs2d_clip: the mesh depth; <= 0 means no limit
PIX_ROWS = 8
TILE = 16
PIX = TILE * TILE  # 256 pixels per tile

KERNEL_DEGREES = (0, 1, 2, 3, 4, 5, 8)


GSP_X, GSP_Y, GSP_AB, GSP_CD, GSP_RG, GSP_BO, GSP_SORTD = 0, 1, 2, 3, 4, 5, 6
GSP_ROWS = 7

GUTP_PX, GUTP_PY, GUTP_PZ = 0, 1, 2
GUTP_SXY, GUTP_SZW, GUTP_QXY, GUTP_QZD, GUTP_RG, GUTP_BO, GUTP_SORTD = 3, 4, 5, 6, 7, 8, 9
GUTP_ROWS = 10

TRI_X0, TRI_Y0, TRI_X1, TRI_Y1, TRI_X2, TRI_Y2 = 0, 1, 2, 3, 4, 5
TRI_DEPTH = 9
TRI_ROWS = 10
TRIS_RGB = 6  # vertex k's channel ch at row TRIS_RGB + 3 k + ch
TRIS_Z0 = 15  # vertex k's view z at row TRIS_Z0 + k
TRIS_ROWS = 18


@dataclasses.dataclass(frozen=True)
class Model:
    """A response model's row layout."""

    rows: int              # f32 attribute rows
    depth_row: int         # aux depth pick and bucket merge key
    geo_rows: tuple        # rows the model's VJP fills, in its output order
    uses_pix: bool         # reads the per-tile pixel context
    cull_pairs: bool       # K2 culls its pair lists (csrc/response.cuh CULL_PAIRS)
    parent: str | None = None  # a packed model: the f32 model its rows unpack into
    trained: bool = True   # has a backward (the packed models and tri2d_smooth do not)
    stochastic: bool = True  # has a stochastic form (the triangles have none)

    @property
    def grad_rows(self) -> int:
        """Rows 0 .. grad_rows-1 get gradients: all before the depth row,
        none of a forward-only model's."""
        return self.depth_row if self.trained else 0


MODELS = {
    "gs2d": Model(GS_ROWS, GS_DEPTH, (0, 1, 2, 3, 4, 5), False, True),
    "gut3d": Model(GUT_ROWS, GUT_DEPTH, (0, 1, 2, 3, 4, 5, 9, 10, 11, 12, 13), True, False),
    "gs2dp": Model(GSP_ROWS, GSP_SORTD, (), False, False, parent="gs2d", trained=False),
    "gut3dp": Model(GUTP_ROWS, GUTP_SORTD, (), True, False, parent="gut3d", trained=False),
    "gs2d_clip": Model(GS_ROWS, GS_DEPTH, (0, 1, 2, 3, 4, 5), True, True),
    "tri2d": Model(TRI_ROWS, TRI_DEPTH, (0, 1, 2, 3, 4, 5), False, False, stochastic=False),
    "tri2d_smooth": Model(TRIS_ROWS, TRIS_Z0, (), False, False, trained=False,
                          stochastic=False),
}
# the geometry (bounds and reach) each model's cull shares
_GEOMETRY = {"gs2d_clip": "gs2d", "tri2d_smooth": "tri2d"}


def model_of(st) -> Model:
    if st.model not in MODELS:
        raise NotImplementedError(f"response model {st.model!r} is not ported yet "
                                  "(ROADMAP.md queue 2)")
    model = MODELS[st.model]
    if st.stochastic and not model.stochastic:
        raise ValueError(f"the {st.model} model has no stochastic form")
    return model


def _f32_name(st) -> str:
    """The model whose f32 rows the twins compute on (``f32_model``), by name."""
    return model_of(st).parent or st.model


def geometry(st) -> str:
    """gs2d, gut3d or tri2d: whose bounds and reach ``st``'s cull uses."""
    name = _f32_name(st)
    return _GEOMETRY.get(name, name)


def f32_model(st) -> Model:
    """The model whose f32 rows the twins compute on: the parent of a
    packed model (``unpack_rows``), else the model itself."""
    model = model_of(st)
    return MODELS[model.parent] if model.parent else model


def merge_row(st) -> int:
    """The row the bucket kernels merge a tile's spans on: the key row
    ``GS_KEY`` where ``st.key_is_row`` is set (gs2d alone has that form),
    else the model's depth row."""
    model = model_of(st)
    if not st.key_is_row:
        return model.depth_row
    if st.model != "gs2d":
        raise NotImplementedError(f"key_is_row is ported for gs2d, not {st.model!r}")
    return GS_KEY


def attr_rows(st) -> int:
    """The attribute rows a blend of ``st`` reads: the model's, and the key
    row where ``st.key_is_row`` is set."""
    merge_row(st)  # raises for a model without the key-row form
    return model_of(st).rows + int(st.key_is_row)


def refuse_backward(st) -> None:
    """Raise for a forward-only model (rasterize_pallas.py:600-606)."""
    if not model_of(st).trained:
        raise NotImplementedError("this response model is forward-only; use "
                                  "pair_format='f32' splat models for training")


# ---- the packed tier: bf16 halves and 16-bit fixed point in f32 words ------

U16_SCALE = float(torch.tensor(1.0 / 65535.0, dtype=torch.float32))  # f32(1/65535), as a double

def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """bf16(x), rounded to nearest even, as its 16 bits in an int32."""
    return x.detach().to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def pack2bf16(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two f32 -> one f32 word holding bf16(hi) << 16 | bf16(lo) (the JAX
    ``pack2bf16``). The high half is bf16(hi) as an f32 bit pattern, so a
    mask unpacks it. No gradient: the word is a bit pattern."""
    return ((_bf16_bits(hi) << 16) | _bf16_bits(lo)).view(torch.float32)


def unpack2bf16(word: torch.Tensor):
    """(hi, lo) f32 from a ``pack2bf16`` word, by mask, shift and bitcast."""
    iw = word.view(torch.int32)
    return (iw & -65536).view(torch.float32), (iw << 16).view(torch.float32)


def pack_bf16_u16(hi: torch.Tensor, unit_lo: torch.Tensor) -> torch.Tensor:
    """bf16(hi) << 16 | clamp(round(unit_lo * 65535), 0, 65535), the round
    half to even (the JAX ``pack_bf16_u16``)."""
    lb = torch.clamp(torch.round(unit_lo.detach() * 65535.0), 0, 65535).to(torch.int32)
    return ((_bf16_bits(hi) << 16) | lb).view(torch.float32)


def unpack_bf16_u16(word: torch.Tensor):
    """(hi, lo) f32 from a ``pack_bf16_u16`` word: lo = u16 * f32(1/65535)."""
    iw = word.view(torch.int32)
    return (iw & -65536).view(torch.float32), (iw & 0xFFFF).to(torch.float32) * U16_SCALE



def pack_rows(model: str, rows: torch.Tensor) -> torch.Tensor:
    """A packed model's (rows, N) words from its parent's (rows, N) f32
    rows, in the JAX ``gs_attr_rows_packed`` / ``gut_attr_rows_packed``
    layouts without their id rows. The exact rows (position, sort depth)
    are the f32 rows themselves and keep their graph; the packed words
    carry none."""
    def row(r):
        return rows[r]

    if model == "gs2dp":
        return torch.stack([
            row(GS_X), row(GS_Y),
            pack2bf16(row(GS_CA), row(GS_CB)), pack2bf16(row(GS_CC), row(GS_DEPTH)),
            pack2bf16(row(ATTR_R), row(ATTR_G)), pack_bf16_u16(row(ATTR_B), row(GS_OPACITY)),
            row(GS_DEPTH)])
    return torch.stack([
        row(GUT_PX), row(GUT_PY), row(GUT_PZ),
        pack2bf16(row(GUT_SX), row(GUT_SY)), pack2bf16(row(GUT_SZ), row(GUT_QW)),
        pack2bf16(row(GUT_QX), row(GUT_QY)), pack2bf16(row(GUT_QZ), row(GUT_DEPTH)),
        pack2bf16(row(ATTR_R), row(ATTR_G)), pack_bf16_u16(row(ATTR_B), row(GUT_OPACITY)),
        row(GUT_DEPTH)])


def unpack_rows(model: str, block: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A block of ``model``'s rows, the rows on axis ``dim``, in the f32
    layout of its parent model (gs2d, gut3d); the block itself for an
    unpacked model. The depth row is the exact sort-depth row. gut3dp's
    quaternion is renormalised as the JAX ``gut3dp_alpha`` renormalises it,
    q * rsqrt(qw^2 + qx^2 + qy^2 + qz^2 + 1e-30), so R(q) stays a rotation."""
    if not MODELS[model].parent:
        return block

    def row(r):
        return block.select(dim, r)

    if model == "gs2dp":
        ca, cb = unpack2bf16(row(GSP_AB))
        cc, _ = unpack2bf16(row(GSP_CD))
        r, g = unpack2bf16(row(GSP_RG))
        b, op = unpack_bf16_u16(row(GSP_BO))
        rows = [row(GSP_X), row(GSP_Y), ca, cb, cc, op, r, g, b, row(GSP_SORTD)]
    else:
        sx, sy = unpack2bf16(row(GUTP_SXY))
        sz, qw = unpack2bf16(row(GUTP_SZW))
        qx, qy = unpack2bf16(row(GUTP_QXY))
        qz, _ = unpack2bf16(row(GUTP_QZD))
        r, g = unpack2bf16(row(GUTP_RG))
        b, op = unpack_bf16_u16(row(GUTP_BO))
        qn = torch.rsqrt(qw * qw + qx * qx + qy * qy + qz * qz + 1e-30)
        rows = [row(GUTP_PX), row(GUTP_PY), row(GUTP_PZ), sx, sy, sz, r, g, b,
                qw * qn, qx * qn, qy * qn, qz * qn, op, row(GUTP_SORTD)]
    return torch.stack(rows, dim=dim)


def _row(block: torch.Tensor, r: int) -> torch.Tensor:
    return block[..., r:r + 1, :]


def gs2d_alpha(block: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
               live: torch.Tensor, st) -> torch.Tensor:
    """(..., 256, C) alpha from a (..., GS_ROWS, C) attribute block.

    px, py: (..., 256, 1) pixel centers; live: a mask broadcastable to
    (..., 256, C), the lane mask (..., 1, C) or lane and pixel together;
    st: the RasterStatics cutoffs (qmax, alpha_min, alpha_clamp). The
    operations and their order are the JAX model's, term for term.
    """
    dx = px - _row(block, GS_X)
    dy = py - _row(block, GS_Y)
    d = (_row(block, GS_CA) * dx * dx + 2.0 * _row(block, GS_CB) * dx * dy
         + _row(block, GS_CC) * dy * dy)
    g = torch.exp(-0.5 * d)
    a_raw = _row(block, GS_OPACITY) * g
    mask = (d <= st.qmax) & (a_raw >= st.alpha_min) & live
    return torch.where(mask, torch.clamp(a_raw, max=st.alpha_clamp), 0.0)


def gs2d_alpha_vjp(block: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                   live: torch.Tensor, st, d_alpha: torch.Tensor) -> torch.Tensor:
    """Hand-derived VJP of :func:`gs2d_alpha`, summed over the pixel axis.

    d_alpha: (..., 256, C) cotangent of the alpha block. Returns (..., 6, C):
    the gradients of rows x, y, conic a, b, c and opacity. A pair-pixel the
    cutoffs drop (d > qmax, a < alpha_min, not live) gets none, and neither
    does one where the clamp at alpha_clamp binds. With g = exp(-0.5 d) and
    a = opacity * g: da/dopacity = g, da/dd = -0.5 a, and d is the conic's
    quadratic form in (dx, dy) = (px - x, py - y).
    """
    dx = px - _row(block, GS_X)
    dy = py - _row(block, GS_Y)
    ca, cb, cc = _row(block, GS_CA), _row(block, GS_CB), _row(block, GS_CC)
    d = ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy
    g = torch.exp(-0.5 * d)
    a_raw = _row(block, GS_OPACITY) * g
    mask = (d <= st.qmax) & (a_raw >= st.alpha_min) & live & (a_raw <= st.alpha_clamp)
    da = torch.where(mask, d_alpha, 0.0)
    dd = -0.5 * da * a_raw
    rows = (
        -(dd * (2.0 * ca * dx + 2.0 * cb * dy)),   # x
        -(dd * (2.0 * cb * dx + 2.0 * cc * dy)),   # y
        dd * dx * dx,                              # conic a
        2.0 * dd * dx * dy,                        # conic b
        dd * dy * dy,                              # conic c
        da * g,                                    # opacity
    )
    return torch.stack([r.sum(dim=-2) for r in rows], dim=-2)


# ---- gs2d_clip: gs2d behind the mesh depth ----------------------------------

def depth_keep(block: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """(..., 256, C) where the (..., 8, 256) pixel context's depth limit
    lets a gs2d lane through: no limit (<= 0) or the lane's depth below it
    (the JAX ``_depth_clip``, the FTB mesh depth prepass)."""
    limit = _pix(pix, PIX_DEPTH_LIMIT)
    return (limit <= 0.0) | (_row(block, GS_DEPTH) < limit)


def gs2d_clip_alpha(block, px, py, pix, live, st) -> torch.Tensor:
    """gs2d's alpha where ``depth_keep`` holds, else 0."""
    return torch.where(depth_keep(block, pix), gs2d_alpha(block, px, py, live, st), 0.0)


def gs2d_clip_alpha_vjp(block, px, py, pix, live, st, d_alpha) -> torch.Tensor:
    """gs2d's VJP where ``depth_keep`` holds; the depth row and the limit
    get none (the keep is a comparison)."""
    return gs2d_alpha_vjp(block, px, py, live & depth_keep(block, pix), st, d_alpha)


# ---- tri2d, tri2d_smooth: opaque triangles --------------------------------------

def _tri_edges(block: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """((e0, e1, e2), (t0, t1, t2)): the edge functions and their
    tolerances, (..., 256, C), on vertices recentred on the tile origin,
    the JAX ``_tri_edges`` and ``tri2d_alpha`` term for term (px - 16
    floor(px / 16) is exact, so is the origin; each x_k - origin rounds)."""
    lx = px - 16.0 * torch.floor(px / 16.0)
    ly = py - 16.0 * torch.floor(py / 16.0)
    ox, oy = px - lx, py - ly
    x = [_row(block, TRI_X0 + 2 * k) - ox for k in range(3)]
    y = [_row(block, TRI_Y0 + 2 * k) - oy for k in range(3)]
    e, t = [], []
    for a, b in ((0, 1), (1, 2), (2, 0)):
        e.append((x[b] - x[a]) * (ly - y[a]) - (y[b] - y[a]) * (lx - x[a]))
        t.append(0.05 * (torch.abs(x[b] - x[a]) + torch.abs(y[b] - y[a])))
    return e, t


def tri2d_alpha(block, px, py, live) -> torch.Tensor:
    """Exactly 1 where the pixel centre is inside the triangle (either
    winding, within the tolerances), else 0; no clamp."""
    (e0, e1, e2), (t0, t1, t2) = _tri_edges(block, px, py)
    inside = (((e0 >= -t0) & (e1 >= -t1) & (e2 >= -t2))
              | ((e0 <= t0) & (e1 <= t1) & (e2 <= t2)))
    return torch.where(inside & live, 1.0, 0.0)


def tri2d_smooth_pixel(block, px, py):
    """([r, g, b], depth), each (..., 256, C): the perspective-correct
    barycentric colour and view depth of every (pixel, face), the JAX
    ``tri2d_smooth_pixel_colors`` and ``tri2d_smooth_pixel_depth`` term
    for term (their depth is the colours' 1 / sum w_k / z_k)."""
    e0, e1, e2 = _tri_edges(block, px, py)[0]
    area = e0 + e1 + e2
    inv = 1.0 / torch.where(torch.abs(area) < 1e-12, 1.0, area)
    w = (e1 * inv, e2 * inv, e0 * inv)
    a = [w[k] / torch.clamp(_row(block, TRIS_Z0 + k), min=1e-6) for k in range(3)]
    zp = 1.0 / torch.clamp(a[0] + a[1] + a[2], min=1e-12)
    rgb = [(a[0] * _row(block, TRIS_RGB + ch) + a[1] * _row(block, TRIS_RGB + 3 + ch)
            + a[2] * _row(block, TRIS_RGB + 6 + ch)) * zp for ch in range(3)]
    return rgb, zp


# ---- gut3d ------------------------------------------------------------------

def kernel_response(ray_dist_sq: torch.Tensor, degree: int) -> torch.Tensor:
    """Generalized Gaussian of degree n, scale s = -4.5/3^n
    (threedgrt.h.slang:83-127). ray_dist_sq is the squared canonical distance."""
    d = ray_dist_sq
    if degree == 8:
        return torch.exp(-0.000685871056241 * (d * d) * (d * d))
    if degree == 5:
        return torch.exp(-0.0185185185185 * d * d * torch.sqrt(d))
    if degree == 4:
        return torch.exp(-0.0555555555556 * d * d)
    if degree == 3:
        return torch.exp(-0.166666666667 * d * torch.sqrt(d))
    if degree == 1:
        return torch.exp(-1.5 * torch.sqrt(d))
    if degree == 0:
        return torch.clamp(1.0 - 0.329630334487 * torch.sqrt(d), min=0.0)
    return torch.exp(-0.5 * d)  # degree 2 (default quadratic)


def kernel_response_slope(d: torch.Tensor, resp: torch.Tensor, degree: int) -> torch.Tensor:
    """d kernel_response / d ray_dist_sq at d, given resp = kernel_response(d)
    (where the degree-0 kernel is above its floor, which the cutoff
    resp > kernel_min_response >= 0 ensures wherever it is used)."""
    if degree == 8:
        return resp * (-0.000685871056241 * 4.0 * (d * d) * d)
    if degree == 5:
        return resp * (-0.0185185185185 * 2.5 * d * torch.sqrt(d))
    if degree == 4:
        return resp * (-0.0555555555556 * 2.0 * d)
    if degree == 3:
        return resp * (-0.166666666667 * 1.5 * torch.sqrt(d))
    if degree == 1:
        return resp * (-0.75 / torch.sqrt(d))
    if degree == 0:
        return -0.1648151672435 / torch.sqrt(d)
    return -0.5 * resp


def deg0_min_response(rt) -> float:
    """Degree-0 support cull from the proxy scale (splat_set_vk.cpp
    kernelScale): the linear kernel 1 - 0.3296*sqrt(d) is culled beyond
    sqrt(d) = rt.kernel_scale_deg0 (a copy of the JAX package's
    ``ops/raytrace._deg0_min_response``)."""
    if rt.kernel_degree == 0:
        return max(0.0, 1.0 - 0.329630334487 * rt.kernel_scale_deg0)
    return 0.0


def _pix(pix: torch.Tensor, r: int) -> torch.Tensor:
    """Row r of a (..., 8, 256) pixel context as a (..., 256, 1) column."""
    return pix[..., r, :, None]


@dataclasses.dataclass
class _GutEval:
    """The gut3d forward's intermediates, which its VJP reads."""

    r: list          # R[i][j], (..., 1, C) rows
    inv_s: list      # 1 / max(s_j, 1e-12)
    e: list          # o_i - p_i, (..., 256, C)
    d: list          # ray direction columns, (..., 256, 1)
    u: list          # u_j = R[:, j] . (o - p)
    v: list          # v_j = R[:, j] . d
    oc: list         # canonical origin u_j * inv_s_j
    dc: list         # canonical direction v_j * inv_s_j
    dn: torch.Tensor  # rsqrt(|dc|^2 + 1e-30)
    dh: list         # unit canonical direction
    cr: list         # dh x oc
    dist: torch.Tensor  # |dh x oc|^2
    resp: torch.Tensor
    a_raw: torch.Tensor
    mask: torch.Tensor  # the cutoffs and ``live``


def _gut3d_eval(block: torch.Tensor, pix: torch.Tensor, live: torch.Tensor, st) -> _GutEval:
    """The JAX model's operations, term for term, in its order."""
    pos = [_row(block, i) for i in (GUT_PX, GUT_PY, GUT_PZ)]
    scl = [_row(block, i) for i in (GUT_SX, GUT_SY, GUT_SZ)]
    qw, qx, qy, qz = (_row(block, i) for i in (GUT_QW, GUT_QX, GUT_QY, GUT_QZ))
    # rotation matrix entries (world-from-canonical R); R^T transforms into
    # the canonical frame (quatToMat3Transpose, threedgrt.h.slang:48-49)
    r = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    inv_s = [1.0 / torch.clamp(s, min=1e-12) for s in scl]
    d_pix = [_pix(pix, i) for i in (RAY_DX, RAY_DY, RAY_DZ)]
    e = [_pix(pix, o) - p for o, p in zip((RAY_OX, RAY_OY, RAY_OZ), pos)]
    # canonical ray (threedgrt.h.slang:57-75): v_c = (R^T v) / s
    u = [r[0][j] * e[0] + r[1][j] * e[1] + r[2][j] * e[2] for j in range(3)]
    v = [r[0][j] * d_pix[0] + r[1][j] * d_pix[1] + r[2][j] * d_pix[2] for j in range(3)]
    oc = [u[j] * inv_s[j] for j in range(3)]
    dc = [v[j] * inv_s[j] for j in range(3)]
    dn = torch.rsqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2] + 1e-30)
    dh = [x * dn for x in dc]
    # min squared distance = |d x o|^2 (threedgrt.h.slang:77-81)
    cr = [dh[1] * oc[2] - dh[2] * oc[1], dh[2] * oc[0] - dh[0] * oc[2],
          dh[0] * oc[1] - dh[1] * oc[0]]
    dist = cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2]
    resp = kernel_response(dist, st.kernel_degree)
    a_raw = _row(block, GUT_OPACITY) * resp
    mask = (a_raw > st.alpha_min) & (resp > st.kernel_min_response) & live
    return _GutEval(r, inv_s, e, d_pix, u, v, oc, dc, dn, dh, cr, dist, resp, a_raw, mask)


def gut3d_alpha(block: torch.Tensor, pix: torch.Tensor, live: torch.Tensor, st) -> torch.Tensor:
    """(..., 256, C) alpha from a (..., GUT_ROWS, C) attribute block and the
    (..., 8, 256) pixel context of its tile: each pixel's ray (unit
    direction, origin; already in the splat set's frame) against each
    splat's canonical frame. live as in :func:`gs2d_alpha`; st: the cutoffs
    (alpha_min, alpha_clamp, kernel_min_response) and kernel_degree."""
    f = _gut3d_eval(block, pix, live, st)
    return torch.where(f.mask, torch.clamp(f.a_raw, max=st.alpha_clamp), 0.0)


def gut3d_alpha_vjp(block: torch.Tensor, pix: torch.Tensor, live: torch.Tensor, st,
                    d_alpha: torch.Tensor) -> torch.Tensor:
    """Hand-derived VJP of :func:`gut3d_alpha`, summed over the pixel axis.

    Returns (..., 11, C): the gradients of rows position x, y, z, scale x,
    y, z, quat w, x, y, z and opacity (``MODELS["gut3d"].geo_rows``). None
    where the cutoffs drop a pair-pixel or the clamp binds, and none through
    max(s, 1e-12) below the floor. With resp = K(D), D = |dh x oc|^2:

      d opacity = da resp,  dD = da opacity K'(D),  d cr = 2 cr dD,
      d dh = oc x d cr,  d oc = d cr x dh,
      d dc = dn d dh - dn^3 (d dh . dc) dc        (the rsqrt normalisation),
      oc_j = u_j inv_s_j, dc_j = v_j inv_s_j,  u = R^T (o - p), v = R^T d:
      d inv_s_j = d oc_j u_j + d dc_j v_j,  d s_j = -inv_s_j^2 d inv_s_j,
      d R[i][j] = d oc_j inv_s_j (o_i - p_i) + d dc_j inv_s_j d_i,
      d p_i = -sum_j d oc_j inv_s_j R[i][j],
    and the quaternion's from d R through R(q). Per pixel, then summed.
    """
    f = _gut3d_eval(block, pix, live, st)
    da = torch.where(f.mask & (f.a_raw <= st.alpha_clamp), d_alpha, 0.0)
    d_op = da * f.resp
    d_dist = da * _row(block, GUT_OPACITY) * kernel_response_slope(f.dist, f.resp,
                                                                  st.kernel_degree)
    g = [2.0 * c * d_dist for c in f.cr]
    oc, dh, dc = f.oc, f.dh, f.dc
    d_dh = [oc[1] * g[2] - oc[2] * g[1], oc[2] * g[0] - oc[0] * g[2],
            oc[0] * g[1] - oc[1] * g[0]]
    d_oc = [g[1] * dh[2] - g[2] * dh[1], g[2] * dh[0] - g[0] * dh[2],
            g[0] * dh[1] - g[1] * dh[0]]
    proj = d_dh[0] * dc[0] + d_dh[1] * dc[1] + d_dh[2] * dc[2]
    dn3 = f.dn * f.dn * f.dn
    d_dc = [f.dn * d_dh[j] - dn3 * proj * dc[j] for j in range(3)]
    d_inv_s = [d_oc[j] * f.u[j] + d_dc[j] * f.v[j] for j in range(3)]
    d_u = [d_oc[j] * f.inv_s[j] for j in range(3)]
    d_v = [d_dc[j] * f.inv_s[j] for j in range(3)]
    gr = [[d_u[j] * f.e[i] + d_v[j] * f.d[i] for j in range(3)] for i in range(3)]
    d_p = [-(d_u[0] * f.r[i][0] + d_u[1] * f.r[i][1] + d_u[2] * f.r[i][2]) for i in range(3)]
    d_s = []
    for j, s in enumerate(_row(block, i) for i in (GUT_SX, GUT_SY, GUT_SZ)):
        d_s.append(d_inv_s[j] * torch.where(s > 1e-12, -(f.inv_s[j] * f.inv_s[j]), 0.0))
    qw, qx, qy, qz = (_row(block, i) for i in (GUT_QW, GUT_QX, GUT_QY, GUT_QZ))
    d_qw = 2.0 * (-qz * gr[0][1] + qy * gr[0][2] + qz * gr[1][0] - qx * gr[1][2]
                  - qy * gr[2][0] + qx * gr[2][1])
    d_qx = 2.0 * (qy * gr[0][1] + qz * gr[0][2] + qy * gr[1][0] - 2.0 * qx * gr[1][1]
                  - qw * gr[1][2] + qz * gr[2][0] + qw * gr[2][1] - 2.0 * qx * gr[2][2])
    d_qy = 2.0 * (-2.0 * qy * gr[0][0] + qx * gr[0][1] + qw * gr[0][2] + qx * gr[1][0]
                  + qz * gr[1][2] - qw * gr[2][0] + qz * gr[2][1] - 2.0 * qy * gr[2][2])
    d_qz = 2.0 * (-2.0 * qz * gr[0][0] - qw * gr[0][1] + qx * gr[0][2] + qw * gr[1][0]
                  - 2.0 * qz * gr[1][1] + qy * gr[1][2] + qx * gr[2][0] + qy * gr[2][1])
    rows = (*d_p, *d_s, d_qw, d_qx, d_qy, d_qz, d_op)
    return torch.stack([x.sum(dim=-2) for x in rows], dim=-2)


# ---- dispatch on the model --------------------------------------------------
#
# Each takes blocks in the f32 layout of ``f32_model(st)``: a packed model's
# rows pass through ``unpack_rows`` first.

def alpha(block, px, py, pix, live, st) -> torch.Tensor:
    """The alpha block of ``st.model``; gs2d and the triangles read px, py,
    gut3d the pixel context ``pix``, gs2d_clip both."""
    name = _f32_name(st)
    if name == "gut3d":
        return gut3d_alpha(block, pix, live, st)
    if name == "gs2d_clip":
        return gs2d_clip_alpha(block, px, py, pix, live, st)
    if geometry(st) == "tri2d":
        return tri2d_alpha(block, px, py, live)
    return gs2d_alpha(block, px, py, live, st)


def alpha_vjp(block, px, py, pix, live, st, d_alpha) -> torch.Tensor:
    """The VJP of :func:`alpha`: (..., len(geo_rows), C); tri2d's coverage
    gives its vertex rows exact zeros."""
    name = _f32_name(st)
    if name == "gut3d":
        return gut3d_alpha_vjp(block, pix, live, st, d_alpha)
    if name == "gs2d_clip":
        return gs2d_clip_alpha_vjp(block, px, py, pix, live, st, d_alpha)
    if name == "tri2d":
        return d_alpha.new_zeros(d_alpha.shape[:-2] + (len(MODELS[name].geo_rows),
                                                        d_alpha.shape[-1]))
    return gs2d_alpha_vjp(block, px, py, live, st, d_alpha)


def pixel_attrs(block, px, py, st):
    """([r, g, b], depth) the blend of ``st.model`` weights and picks: the
    colour rows and the depth row, (..., 1, C) each, or tri2d_smooth's
    per-pixel colour and depth (..., 256, C)."""
    if _f32_name(st) == "tri2d_smooth":
        return tri2d_smooth_pixel(block, px, py)
    depth_row = f32_model(st).depth_row
    return ([_row(block, ch) for ch in (ATTR_R, ATTR_G, ATTR_B)],
            _row(block, depth_row))


# ---- stochastic transparency (RasterStatics.stochastic) --------------------
#
# The JAX kernels' binary accept (rasterize_pallas._alpha_closure, :180-194;
# threedgs_raster.frag.slang:265-290): a pair whose alpha passes the cutoffs
# becomes opaque with probability alpha, by a uniform that is a pure
# function of (key, pixel, lane); csrc/response.cuh has the same two
# functions, bit for bit.

_U32 = 0xFFFFFFFF


def hash_uniform(key: torch.Tensor, pix: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) from broadcastable int64 (key, pixel, lane), the
    JAX ``_hash_uniform`` (rasterize_pallas.py:161-177) bit for bit: its
    xxhash32-flavoured uint32 mix in int64, each product masked to 32 bits,
    then the top 24 bits times 2^-24 in f32. ``pix`` is the tile's
    row-major pixel (0-255), ``lane`` the pair's lane in its blend chunk."""
    h = (((pix * 0x9E3779B1) & _U32) ^ ((lane * 0x85EBCA77) & _U32)
         ^ (((key & _U32) * 0xC2B2AE3D) & _U32))
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _U32
    h = h ^ (h >> 12)
    h = (h * 0x297A2D39) & _U32
    h = h ^ (h >> 15)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def stochastic_accept(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The accepted alpha: exactly 1 where u < a and a > 0, else 0 (``a``
    after the alpha_clamp, so an accepted splat takes T to exactly 0). It
    has no gradient, as ``jax.vjp`` of the JAX ``where`` has none."""
    return torch.where((u < a) & (a > 0.0), 1.0, 0.0).to(a.dtype)


# ---- the per-tile cull (csrc/response.cuh tile_bound, may_hit), plainly ----
#
# K2 culls the pairs of each tile's list, K3 and K4 the lanes of each tile's
# bucket window, by one predicate per model: false only where the model's
# alpha provably fails its cutoffs at every pixel of the tile. K1 asks the
# same predicate of each of its eight warps' pixels (``warp_bound``). Term
# for term as the CUDA source spells it, in double, with the same margins:
# ``pair_reach`` is the lane's part (csrc/response.cuh ``reach``),
# ``reach_may_hit`` the test against one bound (``reach_hits``).

CULL_REL = 1e-3  # relative growth of every cull radius
WARPS = PIX // 32
WARP_W, WARP_H = 8, 4  # K1's warps: 8x4 pixel blocks (csrc/response.cuh warp_pixel)


def _warp_pixels() -> torch.Tensor:
    """(WARPS, 32): the pixel, row-major in its tile, of each lane of each
    of K1's warps: warp w covers the 8x4 block at x = 8 (w % 2), y = 4 (w //
    2), lane l its pixel (l % 8, l // 8)."""
    w, lane = torch.arange(WARPS)[:, None], torch.arange(32)[None, :]
    across = TILE // WARP_W
    return ((WARP_H * (w // across) + lane // WARP_W) * TILE
            + WARP_W * (w % across) + lane % WARP_W)


WARP_PIXELS = _warp_pixels()
WARP_OF_PIXEL = torch.empty(PIX, dtype=torch.long)  # (256,): the warp of each pixel
WARP_OF_PIXEL[WARP_PIXELS.flatten()] = torch.arange(WARPS).repeat_interleave(32)


def _f32(x: float) -> float:
    """A statics value as the C entry points get it (an f32 argument)."""
    return float(torch.tensor(x, dtype=torch.float32))


def tile_bound(st, tiles: torch.Tensor, pix_ctx: torch.Tensor | None = None) -> tuple:
    """The model's TileBound of each tile of ``tiles`` (n,), in double, as
    (n, 1) columns: gs2d the box of the tile's pixel centres (x0, y0, x1,
    y1); gut3d the cone of its rays from the (T, 8, 256) ``pix_ctx``
    (``gut3d_tile_bound``). gs2d_clip and the triangles take gs2d's."""
    if geometry(st) == "gut3d":
        return tuple(x[:, None] if x.dim() == 1 else x[:, :, None]
                     for x in gut3d_tile_bound(pix_ctx[tiles]))
    x0 = ((tiles % st.tiles_x) * TILE).double()[:, None] + 0.5
    y0 = ((tiles // st.tiles_x) * TILE).double()[:, None] + 0.5
    return x0, y0, x0 + (TILE - 1), y0 + (TILE - 1)


def warp_bound(st, tiles: torch.Tensor, pix_ctx: torch.Tensor | None = None) -> tuple:
    """The model's bound over each of K1's warps (csrc/response.cuh
    ``warp_bound``) for each tile of ``tiles`` (n,), in double, the warp on
    the last axis: gs2d the box of the warp's 32 pixel centres, (n, WARPS)
    each; gut3d the cone of its 32 rays (``gut3d_warp_bound``). Warp w's
    bound, shaped as ``tile_bound``'s: ``bound_of_warp``."""
    if geometry(st) == "gut3d":
        return gut3d_warp_bound(pix_ctx[tiles])
    w = torch.arange(WARPS, device=tiles.device)
    across = TILE // WARP_W
    x0 = ((tiles % st.tiles_x)[:, None] * TILE + WARP_W * (w % across)).double() + 0.5
    y0 = ((tiles // st.tiles_x)[:, None] * TILE + WARP_H * (w // across)).double() + 0.5
    return x0, y0, x0 + (WARP_W - 1), y0 + (WARP_H - 1)


def bound_of_warp(bound: tuple, w: int) -> tuple:
    """Warp w's bound from ``warp_bound``'s, shaped as ``tile_bound``'s."""
    return tuple(x[..., w:w + 1] for x in bound)


def pair_reach(blk: torch.Tensor, st) -> tuple:
    """The model's reach (the lane's part of may_hit) over (rows, n, L) f32
    lane rows (``f32_model``'s layout)."""
    kind = geometry(st)
    if kind == "gut3d":
        return gut3d_reach(blk, st)
    if kind == "tri2d":
        return tri2d_reach(blk)
    return gs2d_reach(blk, st)


def reach_may_hit(reach: tuple, bound: tuple, st) -> torch.Tensor:
    """(n, L) bool: ``pair_reach``'s lanes tested against one bound per row
    (``tile_bound``'s shape), as csrc/response.cuh reach_hits."""
    kind = geometry(st)
    if kind == "gut3d":
        return gut3d_reach_may_hit(reach, bound)
    if kind == "tri2d":
        return tri2d_reach_may_hit(reach, bound)
    return gs2d_reach_may_hit(reach, bound)


def may_hit(blk: torch.Tensor, bound: tuple, st) -> torch.Tensor:
    """The model's may_hit over (rows, n, L) f32 lane rows, lane k of row b
    belonging to the tile whose ``tile_bound`` is row b of ``bound``:
    (n, L) bool, True wherever the alpha can pass its cutoffs at some pixel
    of the tile (and for NaN, inf or degenerate rows)."""
    return reach_may_hit(pair_reach(blk, st), bound, st)


def gs2d_reach(blk: torch.Tensor, st) -> tuple:
    """Gs2d::reach: (x, y, rx, ry, sure, never): the centre, the half-widths
    of the inflated box of d <= tau, whether the conic is positive definite
    and its box testable, and whether opacity < alpha_min culls it
    anywhere."""
    v = blk[:6].double()
    x, y, ca, cb, cc, op = v
    amin = _f32(st.alpha_min)
    det = ca * cc - cb * cb
    total = ca + cb.abs() + cc
    err = 1e-6 * (total * total / det)
    sure = torch.isfinite(v).all(dim=0) & (amin > 0) & (ca > 0) & (det > 0) & (err <= 0.25)
    tau = torch.fmin(torch.tensor(_f32(st.qmax), dtype=torch.float64),
                     2.0 * torch.log(op / amin)) + 1e-3
    grow = 1.0 + CULL_REL + err
    rx = torch.sqrt(tau * cc / det) * grow + 1e-2
    ry = torch.sqrt(tau * ca / det) * grow + 1e-2
    return x, y, rx, ry, sure, op < amin


def gs2d_reach_may_hit(reach: tuple, bound: tuple) -> torch.Tensor:
    """Gs2d::reach_hits: False only where the conic is positive definite and
    either opacity < alpha_min or the box misses the bound's pixel
    centres."""
    x, y, rx, ry, sure, never = reach
    x0, y0, x1, y1 = bound
    miss = (x + rx < x0) | (x - rx > x1) | (y + ry < y0) | (y - ry > y1)
    return ~(sure & (never | miss))


TRI_ERR = 1e-5  # the triangle reach's rounding term, per squared pixel of extent


def tri2d_reach(blk: torch.Tensor) -> tuple:
    """Tri2d::reach over (rows, n, L) lane rows: per edge k -> k + 1 (rows
    (n, L) stacked on a first axis of 3) the exact edge function's affine
    coefficients a = dx, b = dy, c = b x_k - a y_k (E(px, py) = a py - b px
    + c, the edge function in absolute pixels) and its tolerance t = 0.05
    (|dx| + |dy|); the vertices' box (x0, x1, y0, y1); whether the rows are
    finite. In double from the f32 rows."""
    v = blk[:6].double()
    x, y = v[0::2], v[1::2]
    nxt = [1, 2, 0]
    a = x[nxt] - x
    b = y[nxt] - y
    c = b * x - a * y
    t = 0.05 * (torch.abs(a) + torch.abs(b))
    return (a, b, c, t, torch.fmin(torch.fmin(x[0], x[1]), x[2]),
            torch.fmax(torch.fmax(x[0], x[1]), x[2]), torch.fmin(torch.fmin(y[0], y[1]), y[2]),
            torch.fmax(torch.fmax(y[0], y[1]), y[2]), torch.isfinite(v).all(dim=0))


def tri2d_reach_may_hit(reach: tuple, bound: tuple) -> torch.Tensor:
    """Tri2d::reach_hits: False only where some edge function is below minus
    its tolerance and some edge function above its tolerance all over the
    bound's rectangle of pixel centres (then neither winding's test passes
    at any of them), each by more than a bound of the f32 evaluation's
    rounding, TRI_ERR S^2 with S the largest distance from a vertex to the
    rectangle plus 16 (csrc/response.cuh derives it)."""
    a, b, c, t, vx0, vx1, vy0, vy1, finite = reach
    x0, y0, x1, y1 = bound
    s = torch.fmax(torch.fmax(torch.fmax(vx1 - x0, x1 - vx0), vy1 - y0), y1 - vy0) + 16.0
    err = TRI_ERR * s * s
    hi = c + torch.fmax(a * y0, a * y1) + torch.fmax(-b * x0, -b * x1)
    lo = c + torch.fmin(a * y0, a * y1) + torch.fmin(-b * x0, -b * x1)
    slack = t * (1.0 + 1e-6) + err
    below = (hi < -slack).any(dim=0)
    above = (lo > slack).any(dim=0)
    return ~(finite & below & above)


def gut3d_tile_bound(pix: torch.Tensor):
    """Gut3d::tile_bound of (n, 8, 256) pixel contexts: (valid (n,), mean
    origin c (n, 3), axis a (n, 3), rho, cos_t, sin_t (n,)), in double."""
    d, o = pix[:, 0:3].double(), pix[:, 3:6].double()
    dd = (d * d).sum(dim=1)                                          # (n, 256)
    valid = (torch.isfinite(d).all(dim=1) & torch.isfinite(o).all(dim=1) & (dd > 0)).all(dim=1)
    c = o.sum(dim=2) / PIX
    ds = d.sum(dim=2)
    a = ds / torch.sqrt((ds * ds).sum(dim=1, keepdim=True))
    rho = torch.sqrt(((o - c[..., None]) ** 2).sum(dim=1).amax(dim=1))
    cos_t = ((d * a[..., None]).sum(dim=1) / torch.sqrt(dd)).amin(dim=1)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return valid, c, a, rho, cos_t, sin_t


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """(...,) sums of (..., 32) values over the last axis, added as
    csrc/response.cuh warp_sum_d adds them (v += shfl_xor(v, h) for h = 16,
    8, 4, 2, 1; lane 0's sum), so the same bits."""
    lanes = torch.arange(32, device=x.device)
    for h in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ h]
    return x[..., 0]


def _dot3(u, v):
    """u0 v0 + u1 v1 + u2 v2 over the first axis, in that order."""
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def gut3d_warp_bound(pix: torch.Tensor):
    """Gut3d::warp_bound of (n, 8, 256) pixel contexts, per warp: (valid
    (n, WARPS), c (n, 3, WARPS), a (n, 3, WARPS), rho, cos_t, sin_t (n,
    WARPS)), in double: the tile bound over the warp's 32 rays, the mean
    over 32, each operation as the CUDA source orders it (the sums as the
    butterfly adds them)."""
    ctx = pix[:, 0:6][:, :, WARP_PIXELS].double().permute(1, 0, 2, 3)  # (6, n, WARPS, 32)
    d, o = ctx[0:3], ctx[3:6]
    dd = _dot3(d, d)
    valid = (torch.isfinite(ctx).all(dim=0) & (dd > 0)).all(dim=-1)
    sum_o, sum_d = _warp_sum(o), _warp_sum(d)                         # (3, n, WARPS)
    c, a = sum_o / 32, sum_d / torch.sqrt(_dot3(sum_d, sum_d))
    e = o - c[..., None]
    rho = torch.sqrt(_dot3(e, e).amax(dim=-1))
    cos_t = (_dot3(d, a[..., None]) / torch.sqrt(dd)).amin(dim=-1)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return valid, c.permute(1, 0, 2), a.permute(1, 0, 2), rho, cos_t, sin_t


def _cut_distance(thr: torch.Tensor, degree: int) -> torch.Tensor:
    """Gut3d::cut_distance: sqrt(D) below which K_degree(D) > thr."""
    g = -torch.log(thr) * (1.0 + 1e-5) + 1e-5
    power = {8: (0.000685871056241, 0.125), 5: (0.0185185185185, 0.2),
             4: (0.0555555555556, 0.25), 3: (0.166666666667, 1.0 / 3.0)}
    if degree in power:
        k, e = power[degree]
        return torch.pow(g / k, e)
    if degree == 1:
        return g / 1.5
    if degree == 0:
        return (1.0 - thr + 1e-5) / 0.329630334487
    return torch.sqrt(2.0 * g)


def gut3d_reach(blk: torch.Tensor, st) -> tuple:
    """Gut3d::reach: the staged slots (1/max(s, 1e-12) and R(q) in f32, as
    Gut3d::stage_common), then in double (p, kappa, inv_max, cut, shrink,
    sure, never, testable): the position, the rounding term's factor 4e-6
    (max(1/s) / min(1/s) + 1), max(1/s), the cut distance with its margin,
    min(1/s) sigma_min; whether the rows are finite, whether they cull
    anywhere (opacity <= alpha_min, thr >= 1), and whether the distance test
    applies (sigma_min >= 0.5, shrink >= 1e-10)."""
    p = blk[0:3]
    inv = 1.0 / torch.clamp(blk[3:6], min=1e-12)
    qw, qx, qy, qz = blk[9:13]
    rot = torch.stack([
        1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz), 2.0 * (qx * qz + qw * qy),
        2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx),
        2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy)])
    q = blk[9:13].double()
    qn = (q * q).sum(dim=0)
    v = torch.cat([p.double(), inv.double(), rot.double(), blk[13:14].double(), qn[None]])
    op = v[15]
    amin, mr = _f32(st.alpha_min), _f32(st.kernel_min_response)
    sure = torch.isfinite(v).all(dim=0) & (amin >= 0)
    thr = amin / op
    thr = torch.where(mr > thr, torch.full_like(thr, mr), thr)
    inv_d = v[3:6]
    inv_min, inv_max = inv_d.amin(dim=0), inv_d.amax(dim=0)
    sig = 1.0 - 2.0 * (v[16] - 1.0).abs() - 1e-5
    shrink = inv_min * sig
    kappa = 4e-6 * (inv_max / inv_min + 1.0)
    cut = _cut_distance(thr, st.kernel_degree) * (1.0 + 1e-5)
    return (v[0:3], kappa, inv_max, cut, shrink, sure, (op <= amin) | (thr >= 1.0),
            (sig >= 0.5) & (shrink >= 1e-10))


def gut3d_reach_may_hit(reach: tuple, bound: tuple) -> torch.Tensor:
    """Gut3d::reach_hits: the distance from the splat to the bound's cone of
    rays against the cut distance in world units."""
    p, kappa, inv_max, cut, shrink, sure, never, testable = reach
    valid, c, a, rho, cos_t, sin_t = bound
    w = p - c.permute(1, 0, 2)                                       # (3, n, L)
    ax = a.permute(1, 0, 2)
    along = _dot3(w, ax).abs()
    x = (w[1] * ax[2] - w[2] * ax[1], w[2] * ax[0] - w[0] * ax[2], w[0] * ax[1] - w[1] * ax[0])
    across = torch.sqrt(_dot3(x, x))
    extent = torch.sqrt(_dot3(w, w)) + rho
    err = kappa * extent * inv_max
    r = (cut + err) / shrink * (1.0 + CULL_REL) + 1e-7 * extent
    nearest = torch.clamp(across * cos_t - along * sin_t, min=0.0) - rho
    far = testable & (nearest > r)
    return ~(valid & sure & (never | far))
