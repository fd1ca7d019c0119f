"""The work of the hybrid lit frame, from the reference's counts
(reference/hybrid.render(count=True)): the blends' evaluations, hits,
splats hit and pixels of the primary, the normal buffer and every map face.

Every pass's blend is gs2d's, at its frozen operations (work/gs3d.py); a
map face's writes rgb, T and its four iso depths per texel. Each map face
projects every splat again from its prepared form, as the primary does.
The normal buffer adds each splat's normal and the shade each pixel's
lighting, itemized below. The cell renders and trains nothing else:
``blend_bwd`` and ``train_step`` are the 3DGS frame's.
"""

from __future__ import annotations

from splatbench.counts import Work
from splatbench.work.gs3d import (  # noqa: F401  (blend_bwd, train_step: the 3DGS frame's)
    OPS_ALPHA,
    OPS_BLEND_FWD_HIT,
    OPS_PROJECT,
    PREPARED_FLOATS,
    SPLAT_ROW_BYTES,
    blend_bwd,
    train_step,
)
from splatbench.work.gs3d import blend_fwd as _gs2d_blend

ISO_PIXEL_OUT_BYTES = 8 * 4     # rgb, T and the four iso depths
# Per splat, the max-density-plane normal (reference/hybrid.splat_normals):
# the rotation 39, exp of the scales 3, eye - mean 3, R^T local 15, the
# scaled gradient 6 and R of it 15, two normalisations 14, the flip 8.
OPS_NORMAL = 103
NORMAL_BYTES = (3 + 3 + 4 + 3) * 4           # reads means, scales, quaternion; writes the normal
# Per pixel: the shade point 23, the normal's renormalisation 9, the
# ambient 3, the select 3; per light its term (direction 12, n.l 6, the
# spot's cone 16, colour 9, the sum 6); per map face the lookup (view
# transform 18, projection 6, texel 6, the staircase 12, the frustum 7).
OPS_SHADE_PIXEL = 38
OPS_SHADE_LIGHT = 49
OPS_SHADE_FACE = 49
SHADE_PIXEL_BYTES = (3 + 3 + 1 + 3) * 4      # reads image, normal, depth; writes the shade


def blend_fwd(c: dict) -> Work:
    """The primary's blend."""
    return _gs2d_blend(c["primary"])


def shadow_blend(c: dict) -> Work:
    """Every map face's multi-iso blend: the alpha per evaluation and the
    blend per hit, as gs2d's; reads the hit splats' rows, writes every
    texel's eight rows."""
    work = Work(0.0, 0.0)
    for m in c["maps"]:
        work = work + Work(m["evals"] * OPS_ALPHA + m["hits"] * OPS_BLEND_FWD_HIT,
                           m["splats_hit"] * SPLAT_ROW_BYTES + m["pixels"] * ISO_PIXEL_OUT_BYTES)
    return work


def frame(splats: int, c: dict) -> Work:
    """A whole hybrid frame: the primary's projection and blend, the normal
    buffer's normals and blend, every map face's projection and blend, and
    the shade."""
    faces = len(c["maps"])
    pixels = c["primary"]["pixels"]
    project = Work(splats * OPS_PROJECT * (1 + faces), splats * PREPARED_FLOATS * 4 * (1 + faces))
    normals = Work(splats * OPS_NORMAL, splats * NORMAL_BYTES) + _gs2d_blend(c["normals"])
    shade = Work(pixels * (OPS_SHADE_PIXEL + c["lights"] * OPS_SHADE_LIGHT
                           + faces * OPS_SHADE_FACE), pixels * SHADE_PIXEL_BYTES)
    return project + blend_fwd(c) + normals + shadow_blend(c) + shade
