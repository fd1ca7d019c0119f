"""What every kind of traffic shares: the program's entry points, the
inputs made from the seed, the render configuration read from the traffic
file, the pair-budget fit and the outcome of a run.

A traffic file (traffic/<mix>.json) names:

- ``kind``: the runner, ``kinds/<kind>.py`` (``view``, ``train``), whose
  ``run`` drives the program through set-up, the timed (or traced) window
  and the comparison once the window has closed;
- ``reference``: the plain reference frame, ``reference/<name>.py``
  (``gs3d``, ``gut3d``), the one the check holds the program's frames to;
- ``work``: the work counts of the rooflines and mfu, ``work/<name>.py``;
- ``render``: the program's ``RenderConfig`` fields, a ``raster`` block of
  ``RasterConfig`` fields and an ``rt`` block of ``RtConfig`` fields, each
  by its name (an enum by its member's name, a tuple as a list); width,
  height, SH degree and background come from the configuration;
- the parameters of its kind (camera path, budget, checks) and ``limits``,
  the limits of ``correct``.

Every frame bins with the exact expansion into a pair budget fitted in
set-up (``fit_budget``). A frame or step whose ``overflow`` fires counts as
failed.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import importlib
import math
import typing

import numpy as np
import torch

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch.render import render
from splatbench import cameras, counts, scene

BUDGET_ROUND = 1 << 16
BUDGET_MAX = 1 << 28   # a frame that overflows at this budget overflows at every budget


def plain_float32() -> None:
    """Full float32 matrix products and convolutions: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Program:
    """The entry points under test. The fault tests and the controls hand
    the runner a broken or replaced copy."""

    render: object = render
    train_step: object = gt.train_step
    make_optimizer: object = gt.make_optimizer


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    setup_s: float
    window_s: float
    times_s: list                 # per frame or step (timed window)
    memory_peak_bytes: int
    numbers: dict                 # the compared numbers
    notes: list                   # what the comparison left out, and why
    summary: object = None        # trace.TraceSummary of a traced run


def kind(traffic: dict):
    return importlib.import_module(f"splatbench.kinds.{traffic['kind']}")


def reference(traffic: dict):
    return importlib.import_module(f"splatbench.reference.{traffic['reference']}")


def work(traffic: dict):
    return importlib.import_module(f"splatbench.work.{traffic['work']}")


def with_raster(traffic: dict, **fields) -> dict:
    """A copy of ``traffic`` whose ``render.raster`` block also sets ``fields``."""
    out = copy.deepcopy(traffic)
    out["render"].setdefault("raster", {}).update(fields)
    return out


def build(cls, block: dict):
    """``cls(**block)`` with each value converted to its field's type: an
    enum member by name, a nested configuration from its block, a tuple
    from a list."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for key, value in block.items():
        t = hints[key]
        if isinstance(t, type) and issubclass(t, enum.Enum):
            value = t[value]
        elif dataclasses.is_dataclass(t):
            value = build(t, value)
        elif isinstance(value, list):
            value = tuple(value)
        kw[key] = value
    return cls(**kw)


def render_config(config: dict, traffic: dict) -> gt.RenderConfig:
    return build(gt.RenderConfig, dict(traffic["render"], width=config["width"],
                                       height=config["height"], sh_degree=config["sh_degree"],
                                       background=config["background"]))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def camera(pose, dev):
    return gt.make_camera(pose.viewmat, pose.fx, pose.fy, pose.cx, pose.cy, pose.near,
                          pose.far, device=dev)


def make_scene(config: dict, seed: int, dev) -> dict:
    return scene.bench_scene(dev, config["splats"], seed, config["sh_degree"], config["extent"],
                             config["mix"])


def poses_of(config: dict, path: dict, seed: int) -> list:
    return cameras.ring(cameras.start_azimuth(seed), path["views"], path["radius"],
                        path["elevation"], config["width"], config["height"], path["fov_y"],
                        path["near"], path["far"])


def fit_budget(frame, poses, traffic: dict) -> tuple[int, str]:
    """(max_pairs, its line): the largest pair count over ``poses`` times
    the margin, rounded up. ``frame(pose, budget)`` renders one pose: the
    first at ``budget_start``, the others at 1.25 times the most so far; a
    pose that overflows its trial budget is rendered again at twice it, up
    to ``BUDGET_MAX`` (a frame that still overflows, as one of the bucket
    path whose caps are short, raises)."""
    budget, need = traffic["budget_start"], 0
    for pose in poses:
        while True:
            out = frame(pose, budget)
            if not bool(out.overflow):
                break
            if budget >= BUDGET_MAX:
                raise RuntimeError(f"the frame overflows at a budget of {budget} pairs")
            budget *= 2
        need = max(need, int(out.num_pairs))
        budget = -(-int(need * 1.25) // BUDGET_ROUND) * BUDGET_ROUND
        del out
    margin = traffic["budget_margin"]
    max_pairs = -(-int(math.ceil(need * margin)) // BUDGET_ROUND) * BUDGET_ROUND
    return max_pairs, (f"budget: max_pairs={max_pairs} = {need} pairs (the most of "
                       f"{len(poses)} poses) x margin {margin}, rounded up to {BUDGET_ROUND}")


def mean_work(items) -> counts.Work:
    items = list(items)
    return counts.Work(sum(w.ops for w in items) / len(items),
                       sum(w.bytes for w in items) / len(items))


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
