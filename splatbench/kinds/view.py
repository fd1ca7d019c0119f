"""A viewer flying an orbit: the ``view`` kind.

The camera path is ``orbit.views`` poses evenly around the scene, the seed
sets the first azimuth, and frame i shows pose i modulo the path. A closed
loop with one frame in flight: each frame is timed on the host clock from
its camera update (the camera made on the device from its pose) to its
image complete on the card. The window lasts ``seconds`` and then to the
end of the pass over the orbit that it is in: whole passes, the same work
for every seed in another order.

Checked: ``check_frames`` frames drawn from the seed among the first
``check_first`` and the window's last (a traced run: its traced frames),
against the traffic's reference frame of the same splats and pose.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import vk_gaussian_splatting_tpu_torch as gt
from splatbench import checks, trace
from splatbench.workloads import (Outcome, Program, camera, fit_budget, free, make_scene,
                                  mean_work, plain_float32, poses_of, reference, render_config,
                                  sync, work)


def run(config: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float, program: Program = Program()) -> Outcome:
    plain_float32()
    inputs = make_scene(config, seed, dev)
    poses = poses_of(config, traffic["orbit"], seed)
    cfg = render_config(config, traffic)
    prepared = gt.SplatSet(**inputs).prepare(cfg.sh_format)
    del inputs  # made again for the reference once the window has closed

    def frame(i: int, budget: int):
        return program.render(prepared, camera(poses[i % len(poses)], dev), cfg, budget)

    max_pairs, budget_line = fit_budget(lambda pose, b: program.render(
        prepared, camera(pose, dev), cfg, b), poses, traffic)
    print(budget_line, flush=True)
    for i in range(traffic["warmup_frames"]):
        frame(i, max_pairs)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    kept, flags, times, pairs, window_s = {}, [], [], [], 0.0
    if not traced:
        rng = np.random.default_rng(seed + 7)
        picks = set(int(k) for k in rng.choice(traffic["check_first"], traffic["check_frames"],
                                               replace=False))
        i = 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            out = frame(i, max_pairs)
            sync(dev)
            b = time.perf_counter()
            times.append(b - a)
            flags.append(out.overflow)
            if i in picks:
                kept[i] = out
            i += 1
            if b - t0 >= seconds and i % len(poses) == 0:
                break
        kept[i - 1] = out
        window_s = b - t0
    else:
        def call(i):
            out = frame(i, max_pairs)
            sync(dev)
            if i:
                kept[i] = out
                flags.append(out.overflow)
        events = trace.traced_events(call, traffic["trace_frames"], lambda: sync(dev))
        pairs = [int(kept[i].num_pairs) for i in sorted(kept)]
    failed = int(torch.stack(flags).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del prepared
    out = None
    free(dev)

    ref_model, counted = reference(traffic), work(traffic)
    inputs = make_scene(config, seed, dev)
    rows, blends, frames = [], [], []
    for i in sorted(kept):
        o = kept.pop(i)
        ref = ref_model.render(inputs, poses[i % len(poses)], count=traced,
                               background=config["background"])
        rows.append(checks.frame_numbers(o.image, o.transmittance, o.depth, o.splat_id, ref))
        if traced:
            blends.append(counted.blend_fwd(ref.counts))
            frames.append(counted.frame(config["splats"], ref.counts))
        del o, ref
    summary = None
    if traced:
        summary = trace.summarize(events, "view", traffic["trace_frames"], {"num_pairs": pairs},
                                  {"blend_fwd": mean_work(blends), "frame": mean_work(frames)})
    return Outcome(len(flags), failed, setup_s, window_s, times, peak, checks.worst(rows), [],
                   summary)
