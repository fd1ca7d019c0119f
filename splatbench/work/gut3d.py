"""The work of a 3DGUT frame and training step (the gut3d response), from
the reference's counts (reference/gut3d.render(count=True)): evaluations
(a pixel whose ray response passes the 0.0113 cutoff before the pixel
stops), hits, splats hit, pixels.

The blend's operations are frozen (the repository's smoke counted them
from the kernels' arithmetic): the ray response per evaluation (the
rotation 21, the canonical origin and direction 24, the normalisation 6,
the cross product 9 and its square 5, exp 1, the opacity and the cutoffs
2: 68), the forward blend per hit (10) and the backward per hit (the
response's VJP through the canonical ray to position, scale, rotation and
opacity, with the colour and transmittance terms: 210).
"""

from __future__ import annotations

from splatbench.counts import Work, optimizer_and_loss

OPS_ALPHA = 68
OPS_BLEND_FWD_HIT = 10
OPS_BLEND_BWD_HIT = 210

# Per-splat operations of the UT projection, itemized from the reference
# (reference/gut3d.project): quaternion normalisation 12 and rotation 27,
# scales 3, the three scaled axes 12, the six outer points 18, world to
# camera 7 x 18, the pinhole projection 7 x 8, the in-view tests 7 x 6, the
# 2D mean 14, the covariance 7 x 8, dilation, determinant and extent 20,
# sigmoid 4 and the colour of gs3d (the view direction 12, the SH basis 40,
# its contraction 90, the base colour and clamps 10).
OPS_PROJECT = 542
# the backward reaches the rows (the UT decides tiles and order only): the
# colour's, the normalisation's and the exponent's backward, twice their
# forward
OPS_PROJECT_BWD = 2 * (12 + 40 + 90 + 10 + 12 + 3 + 4)
# each pixel's ray: the offsets 4, the normalisation 6, the rotation 15
OPS_RAY = 25

PREPARED_FLOATS = 3 + 3 + 4 + 4 + 45         # means, log scales, quaternions, rgba, SH rest: 59
SPLAT_ROW_BYTES = 15 * 4                     # position, scale, rgb, quaternion, opacity, depth
SPLAT_GRAD_BYTES = 14 * 4                    # their gradients, depth excepted
PIXEL_RAY_BYTES = 6 * 4                      # the ray's direction and origin
PIXEL_OUT_BYTES = 5 * 4 + 4                  # rgb, T, depth, splat id
PIXEL_GRAD_IN_BYTES = 3 * 4 + 4              # dL/drgb and the final T


def blend_fwd(c: dict) -> Work:
    """The forward blend of one frame: reads the hit splats' rows and each
    pixel's ray, writes each pixel."""
    return Work(c["evals"] * OPS_ALPHA + c["hits"] * OPS_BLEND_FWD_HIT,
                c["splats_hit"] * SPLAT_ROW_BYTES
                + c["pixels"] * (PIXEL_RAY_BYTES + PIXEL_OUT_BYTES))


def blend_bwd(c: dict) -> Work:
    """The blend's backward of one frame: each evaluation's response again
    and each hit's gradient; reads the rows, each pixel's ray and incoming
    gradient, writes each hit splat's row gradients."""
    return Work(c["evals"] * OPS_ALPHA + c["hits"] * OPS_BLEND_BWD_HIT,
                c["splats_hit"] * (SPLAT_ROW_BYTES + SPLAT_GRAD_BYTES)
                + c["pixels"] * (PIXEL_RAY_BYTES + PIXEL_GRAD_IN_BYTES))


def frame(splats: int, c: dict) -> Work:
    """A whole frame: every splat projected from its prepared form, each
    pixel's ray, the blend, the image written."""
    return (Work(splats * OPS_PROJECT + c["pixels"] * OPS_RAY, splats * PREPARED_FLOATS * 4)
            + blend_fwd(c))


def train_step(splats: int, c: dict) -> Work:
    """A whole training step: the forward and backward of the projection
    and the blend, the rays, the loss and Adam over every field."""
    return (Work(splats * (OPS_PROJECT + OPS_PROJECT_BWD) + c["pixels"] * OPS_RAY, 0.0)
            + optimizer_and_loss(splats, c["pixels"]) + blend_fwd(c) + blend_bwd(c))
