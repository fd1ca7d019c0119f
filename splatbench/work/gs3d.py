"""The work of a 3DGS frame and training step (the gs2d response), from
the reference's counts (reference/gs3d.blend(count=True)): evaluations,
hits, splats hit, pixels.

The blend's operations are frozen (the repository's smoke counted them
from the kernels' arithmetic): the alpha per evaluation (the offset 2, the
quadratic form 6, the exponent's scale 1, exp 1, the opacity 1, the
cutoffs 3, the clamp and select 3), the forward blend per hit (weight 2,
colour 6, T 2) and the backward per hit (the alpha's VJP, the colour and
transmittance terms and the reductions).
"""

from __future__ import annotations

from splatbench.counts import Work, optimizer_and_loss

OPS_ALPHA = 17
OPS_BLEND_FWD_HIT = 10
OPS_BLEND_BWD_HIT = 53

# Per-splat operations of the 3DGS projection, itemized from the
# reference (reference/gs3d.project): world to camera 18, pixel centre 6,
# quaternion normalisation 12 and rotation 27, scales 3, M = R diag(s) 9,
# M M^T 30, the Jacobian 10, J W 30, (J W) S (J W)^T 45, dilation, conic,
# eigenvalues and culls 25, sigmoid 4, the view direction 12, the SH basis
# of degrees 1-3 40, its contraction 90, the base colour and clamps 10.
OPS_PROJECT = 370
OPS_PROJECT_BWD = 2 * OPS_PROJECT

PREPARED_FLOATS = 3 + 6 + 4 + 45             # means, covariance, rgba, SH rest: 58
SPLAT_ROW_BYTES = 10 * 4                     # xy, conic, opacity, rgb, depth
SPLAT_GRAD_BYTES = 9 * 4                     # their gradients, depth excepted
PIXEL_OUT_BYTES = 5 * 4 + 4                  # rgb, T, depth, splat id
PIXEL_GRAD_IN_BYTES = 3 * 4 + 4              # dL/drgb and the final T


def blend_fwd(c: dict) -> Work:
    """The forward blend of one frame: reads the hit splats' rows, writes
    each pixel."""
    return Work(c["evals"] * OPS_ALPHA + c["hits"] * OPS_BLEND_FWD_HIT,
                c["splats_hit"] * SPLAT_ROW_BYTES + c["pixels"] * PIXEL_OUT_BYTES)


def blend_bwd(c: dict) -> Work:
    """The blend's backward of one frame: each evaluation's alpha again and
    each hit's gradient; reads the rows and each pixel's incoming gradient,
    writes each hit splat's row gradients."""
    return Work(c["evals"] * OPS_ALPHA + c["hits"] * OPS_BLEND_BWD_HIT,
                c["splats_hit"] * (SPLAT_ROW_BYTES + SPLAT_GRAD_BYTES)
                + c["pixels"] * PIXEL_GRAD_IN_BYTES)


def frame(splats: int, c: dict) -> Work:
    """A whole frame: every splat projected from its prepared form, the
    blend, the image written."""
    return Work(splats * OPS_PROJECT, splats * PREPARED_FLOATS * 4) + blend_fwd(c)


def train_step(splats: int, c: dict) -> Work:
    """A whole training step: the forward and backward of the projection
    and the blend, the loss and Adam over every field."""
    return (Work(splats * (OPS_PROJECT + OPS_PROJECT_BWD), 0.0)
            + optimizer_and_loss(splats, c["pixels"]) + blend_fwd(c) + blend_bwd(c))
