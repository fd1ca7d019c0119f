"""A trainer fitting the scene: the ``train`` kind.

``views.views`` training poses around the scene; their targets are the
traffic's reference frames of the scene itself, rendered once in set-up
(their seconds are left out of ``setup_s``: the reference is the
benchmark's, not the program's). Training starts from the scene jittered
(scene.jittered_start); step i trains against view i modulo the count, one
step in flight. Set-up builds the one training object (the splats and the
program's optimizer), drives it through the first ``checked_steps`` steps
by the window's own call, and hands it to the window, which lasts
``seconds`` and then to the end of its pass over the views.

Checked, once the window has closed: the first steps' losses, the first
gradient's norm (from Adam's first moment after one step) and the
parameters' change after the checked steps, each by the worst field,
against the reference's steps from the same start (reference/train.py).
"""

from __future__ import annotations

import time

import torch

import vk_gaussian_splatting_tpu_torch as gt
from splatbench import checks, scene, trace
from splatbench.reference import train as reftrain
from splatbench.workloads import (Outcome, Program, camera, fit_budget, free, make_scene,
                                  mean_work, plain_float32, poses_of, reference, render_config,
                                  sync, work)

BETA1 = 0.9  # the program's Adam first-moment decay (its state holds (1 - beta1) g after one step)


def train_config(config: dict) -> gt.TrainConfig:
    return gt.TrainConfig(**config["train"])


def reference_lrs(tc) -> dict:
    return dict(means=tc.lr_means * tc.scene_extent, scales=tc.lr_scales, quats=tc.lr_quats,
                opacities=tc.lr_opacities, sh_dc=tc.lr_sh_dc, sh_rest=tc.lr_sh_rest)


def train_start(config: dict, traffic: dict, seed: int, dev, truth: dict | None = None) -> dict:
    """Where training starts: the scene, jittered."""
    truth = make_scene(config, seed, dev) if truth is None else truth
    jit = traffic["jitter"]
    return scene.jittered_start(truth, dev, seed, jit["means"], jit["sh_dc"])


def train_inputs(config: dict, traffic: dict, seed: int, dev):
    """(start, poses, targets, seconds): where training starts, the
    training poses, their targets (the reference's frames of the scene
    itself) and the seconds those frames took."""
    truth = make_scene(config, seed, dev)
    poses = poses_of(config, traffic["views"], seed)
    model = reference(traffic)
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        targets = [model.render(truth, pose, background=config["background"]).image
                   for pose in poses]
    sync(dev)
    ref_s = time.perf_counter() - t0
    return train_start(config, traffic, seed, dev, truth), poses, targets, ref_s


def first_steps(splats, opt, step, first: int, start: dict) -> tuple[dict, list]:
    """Drive the training object through its first ``first`` steps: (the
    readings the reference follows, their overflow flags). The first
    gradient is read from Adam's state after one step (its first moment is
    (1 - beta1) g); the change is the parameters' distance from ``start``
    after the last."""
    losses, flags, grad1, moved1 = [], [], {}, {}
    for k in range(first):
        loss, ov = step(k)
        losses.append(loss)
        flags.append(ov)
        if k == 0:
            for f in scene.FIELDS:
                p = getattr(splats, f)
                m = opt.state[p]["exp_avg"] if p in opt.state else torch.zeros_like(p)
                grad1[f] = float(torch.linalg.vector_norm(m)) / (1.0 - BETA1)
                moved1[f] = int((p.detach() != start[f]).sum())
    change = {f: float(torch.linalg.vector_norm(getattr(splats, f).detach() - start[f]))
              for f in scene.FIELDS}
    return dict(losses=[float(x) for x in losses], grad1=grad1, change=change,
                moved1=moved1), flags


def run(config: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float, program: Program = Program()) -> Outcome:
    plain_float32()
    start, poses, targets, ref_s = train_inputs(config, traffic, seed, dev)
    print(f"reference targets: {len(targets)} frames in {ref_s:.3f} s, left out of setup_s",
          flush=True)
    free(dev)
    splats = gt.SplatSet(**{f: start[f].clone() for f in scene.FIELDS})
    tc = train_config(config)
    opt = program.make_optimizer(splats, tc)
    cfg = render_config(config, traffic)
    nv = len(poses)

    def fit_frame(pose, budget):
        with torch.no_grad():
            return program.render(splats.prepare(cfg.sh_format), camera(pose, dev), cfg, budget)

    max_pairs, budget_line = fit_budget(fit_frame, poses, traffic)
    print(budget_line, flush=True)

    def step(k: int):
        return program.train_step(splats, opt, camera(poses[k % nv], dev), targets[k % nv], cfg,
                                  max_pairs, tc)

    first = traffic["checked_steps"]
    prog, flags = first_steps(splats, opt, step, first, start)
    del start
    sync(dev)
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start - ref_s

    times, window_s = [], 0.0
    if not traced:
        i = 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            _, ov = step(first + i)
            sync(dev)
            b = time.perf_counter()
            times.append(b - a)
            flags.append(ov)
            i += 1
            if b - t0 >= seconds and (first + i) % nv == 0:
                break
        window_s = b - t0
    else:
        def call(i):
            _, ov = step(first + i)
            sync(dev)
            if i:
                flags.append(ov)
        events = trace.traced_events(call, traffic["trace_steps"], lambda: sync(dev))
    attempted = len(flags) - first
    failed = int(torch.stack(flags).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del splats, opt
    free(dev)

    model, counted = reference(traffic), work(traffic)
    start = train_start(config, traffic, seed, dev)
    ref = reftrain.train(start, poses[:first], targets[:first], reference_lrs(tc), tc.ssim_lambda,
                         model, background=config["background"])
    numbers, left_out = checks.train_numbers(prog, ref)
    notes = [f"change_gap leaves out {f}: its reference gradient is under "
             f"{checks.LEAF_FLOOR} of the median leaf's" for f in left_out]
    summary = None
    if traced:
        steps = [first + i for i in range(1, traffic["trace_steps"] + 1)]
        with torch.no_grad():
            cs = [model.render(start, poses[k % nv], count=True,
                               background=config["background"]).counts for k in steps]
        work_of = {"blend_fwd": mean_work(counted.blend_fwd(c) for c in cs),
                   "blend_bwd": mean_work(counted.blend_bwd(c) for c in cs),
                   "step": mean_work(counted.train_step(config["splats"], c) for c in cs)}
        summary = trace.summarize(events, "train", traffic["trace_steps"], {}, work_of)
    return Outcome(attempted, failed, setup_s, window_s, times, peak, numbers, notes, summary)
