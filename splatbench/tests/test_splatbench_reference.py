"""The plain references against the program's CPU path on a small scene,
in every cell's traffic (reference/gs3d.py, reference/gut3d.py): the frame
(image, transmittance, depth and splat picks) and one training step's loss
and gradients."""

import torch

from splatbench import checks, scene, workloads
from splatbench.kinds import train as train_kind
from splatbench.reference import train as reftrain

import vk_gaussian_splatting_tpu_torch as gt


def test_frame_matches_the_program(view_cell, cpu):
    config, traffic = view_cell["config"], view_cell["traffic"]
    inputs = workloads.make_scene(config, 11, cpu)
    pose = workloads.poses_of(config, traffic["orbit"], 11)[0]
    cfg = workloads.render_config(config, traffic)
    out = workloads.render(gt.SplatSet(**inputs).prepare(), workloads.camera(pose, cpu), cfg,
                           1 << 17)
    ref = workloads.reference(traffic).render(inputs, pose, count=True)
    assert not bool(out.overflow)
    nums = checks.frame_numbers(out.image, out.transmittance, out.depth, out.splat_id, ref)
    # the program freezes a pixel at its 128-pair chunk's end, the reference
    # at the splat: they part by at most T <= 1e-4 on the pixels that freeze
    assert nums["image_rmse"] < 3e-5 and nums["transmittance_off_share"] < 1e-3
    assert nums["pick_mismatch_share"] < 1e-3
    assert float((ref.transmittance < 0.5).float().mean()) > 0.5
    assert 0 < ref.counts["hits"] <= ref.counts["evals"]


def test_training_step_matches_the_program(train_cell, cpu):
    config, traffic = train_cell["config"], train_cell["traffic"]
    start, poses, targets, _ = train_kind.train_inputs(config, traffic, 5, cpu)
    splats = gt.SplatSet(**{f: start[f].clone() for f in scene.FIELDS})
    tc = train_kind.train_config(config)
    opt = gt.make_optimizer(splats, tc)
    cfg = workloads.render_config(config, traffic)
    loss, overflow = gt.train_step(splats, opt, workloads.camera(poses[0], cpu), targets[0], cfg,
                                   1 << 17, tc)
    grad1 = {f: float(torch.linalg.vector_norm(opt.state[getattr(splats, f)]["exp_avg"])) / 0.1
             for f in scene.FIELDS}
    change = {f: float(torch.linalg.vector_norm(getattr(splats, f).detach() - start[f]))
              for f in scene.FIELDS}
    ref = reftrain.train(start, poses[:1], targets[:1], train_kind.reference_lrs(tc),
                         tc.ssim_lambda, workloads.reference(traffic))
    nums, left_out = checks.train_numbers(
        dict(losses=[float(loss)], grad1=grad1, change=change), ref)
    assert not bool(overflow) and not left_out
    assert nums["loss_gap"] < 1e-4 and nums["grad1_gap"] < 1e-3 and nums["change_gap"] < 1e-2
