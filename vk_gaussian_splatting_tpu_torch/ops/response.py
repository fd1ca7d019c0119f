"""The gs2d response model (counterpart of
``vk_gaussian_splatting_tpu/ops/response.py:31-42,131-154``).

Projected 2D conic Gaussian (threedgs_raster.frag.slang:236-255):
d = (p-mu)' conic (p-mu), response = exp(-0.5 d), discard d > qmax, keep
only alpha >= alpha_min, clamp at alpha_clamp. This module is the plain
reference of the math that the CUDA tile blender (csrc/rasterize_fwd.cu)
inlines; the other response models are not ported yet.

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

    px, py: (..., 256, 1) pixel centers; live: (..., 1, C) lane mask;
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
