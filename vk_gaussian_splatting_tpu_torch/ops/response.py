"""The gs2d response model (counterpart of
``vk_gaussian_splatting_tpu/ops/response.py:31-42,131-154``).

Projected 2D conic Gaussian (threedgs_raster.frag.slang:236-255):
d = (p-mu)' conic (p-mu), response = exp(-0.5 d), discard d > qmax, keep
only alpha >= alpha_min, clamp at alpha_clamp. This module is the plain
reference of the math that the CUDA tile blenders (csrc/rasterize_fwd.cu,
and its backward csrc/rasterize_bwd.cu) inline, with the hand-derived VJP
the backward needs; the other response models are not ported yet.

Attribute rows of the gs2d layout, shape (GS_ROWS, P) f32:
  0 x, 1 y, 2-4 conic (a, b, c), 5 opacity, 6-8 rgb, 9 depth
The splat id does not ride as a float row (the JAX layout's two f32 id
rows): it travels beside the rows as its own int32 array, which is exact
for every id.
"""

from __future__ import annotations

import torch

GS_X, GS_Y, GS_CA, GS_CB, GS_CC, GS_OPACITY = 0, 1, 2, 3, 4, 5
ATTR_R, ATTR_G, ATTR_B = 6, 7, 8
GS_DEPTH = 9
GS_ROWS = 10


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
