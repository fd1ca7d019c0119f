"""counts.py and the reference's work counts on cases small enough to
count by hand."""

import numpy as np
import pytest
import torch

from splatbench import counts
from splatbench.cameras import Pose
from splatbench.reference import gs3d, gut3d
from splatbench.work import gs3d as work_gs3d
from splatbench.work import gut3d as work_gut3d


def one_splat(x, y, opacity, depth=2.0, n=1, conic=(1.0, 0.0, 1.0), rgb=(0.5, 0.5, 0.5)):
    """n copies of an isotropic unit-variance splat centred on (x, y),
    depth order by index, covering the tiles it touches."""
    return gs3d.Projected(
        xy=torch.tensor([[x, y]] * n), conic=torch.tensor([conic] * n),
        opacity=torch.full((n,), opacity), rgb=torch.tensor([rgb] * n),
        depth=depth + torch.arange(n, dtype=torch.float32),
        rect=torch.tensor([[0] * n, [0] * n, [2] * n, [2] * n]))


def test_one_splat_is_counted_by_hand():
    # centred on pixel (10, 10)'s centre: d = dx^2 + dy^2 <= 8 on the 25
    # pixels with |dx|, |dy| <= 2; o exp(-d/2) >= 0.9 exp(-4) > 1/255 on all
    proj = one_splat(10.5, 10.5, 0.9)
    lists = gs3d.tile_lists(proj, 32, 32)
    frame = gs3d.blend(proj, lists, 32, 32, count=True)
    assert frame.counts == dict(evals=25, hits=25, splats_hit=1, pixels=32 * 32)
    w = work_gs3d.blend_fwd(frame.counts)
    assert w.ops == 25 * 17 + 25 * 10
    assert w.bytes == 1 * 40 + 32 * 32 * 24
    assert frame.splat_id[10, 10] == 0 and frame.splat_id[0, 0] == -1


def test_cutoff_removes_hits_not_evaluations():
    # opacity 0.05: o exp(-d/2) >= 1/255 needs d <= 2 ln(0.05 * 255) = 5.09.
    # The 25 pixels of the support have d = 0 (1), 1 (4), 2 (4), 4 (4),
    # 5 (8) and 8 (4): all but the 4 corners hit
    proj = one_splat(10.5, 10.5, 0.05)
    frame = gs3d.blend(proj, gs3d.tile_lists(proj, 32, 32), 32, 32, count=True)
    assert frame.counts["evals"] == 25 and frame.counts["hits"] == 21


def test_termination_stops_evaluations():
    # 8 opaque copies at alpha 0.999 on the centre pixel: T falls to 1e-3,
    # 1e-6 after two: the third and later are not evaluated there. Pixels
    # whose alpha is lower keep blending.
    proj = one_splat(10.5, 10.5, 1.0, n=8)
    frame = gs3d.blend(proj, gs3d.tile_lists(proj, 32, 32), 32, 32, count=True)
    centre_evals = 2
    assert frame.counts["evals"] < 8 * 25
    assert frame.counts["evals"] >= 24 * 2 + centre_evals
    assert float(frame.transmittance[10, 10]) == pytest.approx(1e-6, rel=1e-3)


def test_work_and_shares():
    w = counts.Work(67e12, 0.0)
    assert w.bound_s() == pytest.approx(1.0)
    assert counts.Work(0.0, 3.35e12).bound_s() == pytest.approx(1.0)
    assert counts.share_percent(counts.Work(67e9, 0.0), 0.002) == pytest.approx(50.0)
    assert counts.share_percent(w, 0.0) is None
    c = dict(evals=10, hits=5, splats_hit=2, pixels=4)
    assert work_gs3d.blend_bwd(c).ops == 10 * 17 + 5 * 53
    assert work_gs3d.frame(3, c).bytes == 3 * 58 * 4 + work_gs3d.blend_fwd(c).bytes
    step = work_gs3d.train_step(3, c)
    assert step.bytes == (3 * 59 * 4 * 6 + 4 * 3 * 4 + work_gs3d.blend_fwd(c).bytes
                          + work_gs3d.blend_bwd(c).bytes)


def test_gut3d_one_splat_is_counted_by_hand():
    """An isotropic splat of scale 1 at depth 1000 of a focal-1000 camera,
    on pixel (16, 16)'s centre: the ray of the pixel (dx, dy) px away passes
    it at about |(dx, dy)| canonical units, so resp = exp(-r^2 / 2) > 0.0113
    (r^2 < 8.96) holds on the pixels with dx^2 + dy^2 <= 8: 25 of them (dx,
    dy in -2..2), as for gs2d's d <= 8, and opacity 0.9 keeps every one
    above 1/255. The UT extent (about 3.4 px) keeps them all in its tiles."""
    viewmat = np.eye(4, dtype=np.float32)
    pose = Pose(viewmat, 1000.0, 1000.0, 16.0, 16.0, 0.01, 1e4, 32, 32)
    p = dict(means=torch.tensor([[0.5, 0.5, 1000.0]]), scales=torch.zeros(1, 3),
             quats=torch.tensor([[1.0, 0.0, 0.0, 0.0]]), opacities=torch.tensor([2.1972246]),
             sh_dc=torch.zeros(1, 3), sh_rest=torch.zeros(1, 15, 3))
    frame = gut3d.render(p, pose, count=True)
    assert frame.counts == dict(evals=25, hits=25, splats_hit=1, pixels=32 * 32)
    assert frame.splat_id[16, 16] == 0 and frame.splat_id[0, 0] == -1
    w = work_gut3d.blend_fwd(frame.counts)
    assert w.ops == 25 * 68 + 25 * 10
    assert w.bytes == 1 * 60 + 32 * 32 * (24 + 24)
