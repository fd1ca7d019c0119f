"""The timed path broken on purpose, and the control put in its place:
what the check has to refuse.

Each stands in for one of the program's entry points (a
``workloads.Program`` field). The fault tests drive a whole run with it on
the CPU; ``calibrate.py`` reads each on the card at the cell's size.
"""

from __future__ import annotations

import dataclasses

import torch

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch.render import render
from splatbench import cameras, scene
from splatbench.reference import train as reftrain


def altered_render(prepared, cam, cfg, max_pairs=0, **kw):
    """A frame whose answer is altered where it is produced: one 16x16
    block of the image 0.05 brighter."""
    out = render(prepared, cam, cfg, max_pairs, **kw)
    image = out.image.clone()
    image[:16, :16] += 0.05
    return dataclasses.replace(out, image=image)


def unchanged_step(splats, optimizer, cam, target, cfg, max_pairs, tc):
    """A training step that returns its state unchanged: the loss and its
    backward, no update."""
    optimizer.zero_grad(set_to_none=True)
    out = render(splats.prepare(cfg.sh_format), cam, cfg, max_pairs)
    loss = gt.rgb_loss(out.image, target, tc.ssim_lambda)
    loss.backward()
    return loss.detach(), out.overflow


def half_batch_step(splats, optimizer, cam, target, cfg, max_pairs, tc):
    """A training step that leaves out half of its batch: the loss is the
    mean over the image's upper half alone."""
    optimizer.zero_grad(set_to_none=True)
    out = render(splats.prepare(cfg.sh_format), cam, cfg, max_pairs)
    rows = out.image.shape[0] // 2
    loss = gt.rgb_loss(out.image[:rows], target[:rows], tc.ssim_lambda)
    loss.backward()
    optimizer.step()
    return loss.detach(), out.overflow


def reference_step(model, precision: str = "bf16"):
    """The control of a training cell: a step whose frame and loss are the
    reference's (``model``, e.g. reference/gs3d.py) computed at
    ``precision``, in the program's place; the optimizer steps on its
    gradient. The camera's numbers are the pose's, read back."""

    def step(splats, optimizer, cam, target, cfg, max_pairs, tc):
        optimizer.zero_grad(set_to_none=True)
        pose = cameras.Pose(cam.viewmat.detach().cpu().numpy(), float(cam.fx), float(cam.fy),
                            float(cam.cx), float(cam.cy), float(cam.near), float(cam.far),
                            cfg.width, cfg.height)
        p = {f: getattr(splats, f) for f in scene.FIELDS}
        frame = model.render(p, pose, precision, grad=True, background=cfg.background)
        loss = reftrain.rgb_loss(frame.image, target, tc.ssim_lambda)
        loss.backward()
        optimizer.step()
        return loss.detach(), torch.zeros((), dtype=torch.bool, device=target.device)

    return step
