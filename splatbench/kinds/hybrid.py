"""A viewer flying an orbit around a scene lit by two moving lights: the
``hybrid`` kind.

Each frame is the program's hybrid frame (``render_hybrid``, deep shadow
maps): the raster primary, its normal buffer, one deep shadow map per
light and the deferred shade. The camera path is the view kind's orbit
(``orbit``); the lights are the configuration's (``lights``: type, cones,
colour, intensity, ``shadow_res``) and move every frame as ``light_path``
says, in units of the scene's extent: a spot light ``spot.above_camera``
above the camera, aiming at the scene's centre; a point light circling
the centre at ``point.radius`` and ``point.height`` above it, once per
pass over the orbit, ``point.lead_turns`` of a turn ahead of the camera.
A closed loop with one frame in flight: each frame is timed on the host
clock from its camera and light update (both made on the device from
their numbers) to its shaded image complete on the card; the window is
the view kind's, whole passes over the orbit.

Set-up fits two pair budgets over the path's poses, each pose with its
own lights: the primary's (``max_pairs``) and one for every map face
(``shadow_max_pairs``), each the most over the poses times the margin,
rounded as ``workloads.fit_budget`` rounds. A frame whose ``overflow``
(the primary's or any map's) fires counts as failed.

Checked once the window has closed (a traced run: its traced frames):
``check_frames`` frames drawn from the seed among the first
``check_first``, and the window's last, against reference/hybrid.py of the
same splats, pose and lights (``numbers``). Traced: the device time inside
the hybrid's own spans (normals, shadow_map and its children, shade) is
added to the summary (splatbench/spans.py), with the maps' live pairs per
frame as the counter ``shadow_pairs``.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import time

import numpy as np
import torch

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch.render.pipelines import render_hybrid
from vk_gaussian_splatting_tpu_torch.scene.lights import AttenuationMode, LightType, make_light
from splatbench import cameras, checks, spans, trace
from splatbench.cameras import Pose
from splatbench.reference import hybrid as ref_hybrid
from splatbench.workloads import (BUDGET_MAX, BUDGET_ROUND, Outcome, camera, free, make_scene,
                                  mean_work, plain_float32, poses_of, reference, render_config,
                                  sync, work)

SPANS = ("normals", "shadow_map", "shade")
# A shaded pixel whose shade point lies at a staircase's step in one
# program and not in the other (its picked depth, or the step's depth,
# rounded across) moves by a level, 0.25 of its light: a few such pixels
# make the shaded image's root mean square gap of a sound frame, so the
# share of pixels off by more than the images' own agreement (2e-4, five
# times over) is compared beside it.
SHADED_TOLERANCE = 1e-3


@dataclasses.dataclass(frozen=True)
class HybridProgram:
    """The entry point under test; the faults hand the runner a broken copy."""

    render_hybrid: object = render_hybrid


class LightPath:
    """The lights of pose k as plain numbers (reference/hybrid.Light), each
    coordinate rounded once to float32, and as the program's lights."""

    def __init__(self, config: dict, traffic: dict, poses: list, start: float):
        self.config, self.poses, self.start = config, poses, start
        self.path = traffic["light_path"]

    def plain(self, k: int) -> list:
        extent = self.config["extent"]
        vm = self.poses[k].viewmat.astype(np.float64)
        eye = -vm[:3, :3].T @ vm[:3, 3]
        out = []
        for light in self.config["lights"]:
            kind = light["type"].lower()
            if kind == "spot":
                pos = eye + np.array([0.0, self.path["spot"]["above_camera"] * extent, 0.0])
            else:
                p = self.path["point"]
                az = self.start + 2.0 * math.pi * (k / len(self.poses) + p["lead_turns"])
                pos = extent * np.array([p["radius"] * math.sin(az), p["height"],
                                         -p["radius"] * math.cos(az)])
            direction = -pos / np.linalg.norm(pos)
            out.append(ref_hybrid.Light(
                kind, tuple(float(v) for v in pos.astype(np.float32)),
                tuple(float(v) for v in direction.astype(np.float32)),
                tuple(light["color"]), light["intensity"], light["inner_cone_deg"],
                light["outer_cone_deg"]))
        return out

    def program(self, k: int, dev) -> tuple:
        return tuple(make_light(LightType[p.kind.upper()], p.position, p.direction, p.color,
                                p.intensity, attenuation=AttenuationMode.NONE,
                                inner_cone_deg=p.inner_cone_deg,
                                outer_cone_deg=p.outer_cone_deg, device=dev)
                     for p in self.plain(k))


def faces_of(shadow_maps) -> list:
    """Every face of the frame's maps (a cube map's six in turn)."""
    return [f for m in shadow_maps for f in getattr(m, "faces", [m])]


def _rounded(need: int, margin: float) -> int:
    return -(-int(math.ceil(need * margin)) // BUDGET_ROUND) * BUDGET_ROUND


def fit_budgets(frame, views: int, traffic: dict) -> tuple[int, int, str]:
    """(max_pairs, shadow_max_pairs, their line): ``workloads.fit_budget``'s
    fit of the primary's pairs and of the largest map face's, together:
    ``frame(k, budgets)`` renders pose k; a budget its frame overflows is
    doubled and the pose rendered again."""
    budgets = [traffic["budget_start"], traffic["shadow_budget_start"]]
    need = [0, 0]
    for k in range(views):
        while True:
            out = frame(k, budgets)[0]
            if not bool(out.overflow):
                break
            over = [int(out.num_pairs) >= budgets[0],
                    any(bool(f.overflow) for f in faces_of(out.shadow_maps))]
            for b in (0, 1):
                if over[b]:
                    if budgets[b] >= BUDGET_MAX:
                        raise RuntimeError(f"the frame overflows at a budget of {budgets[b]}")
                    budgets[b] *= 2
        need[0] = max(need[0], int(out.num_pairs))
        need[1] = max([need[1]] + [int(f.num_pairs) for f in faces_of(out.shadow_maps)])
        budgets = [_rounded(n, 1.25) for n in need]
        del out
    margin = traffic["budget_margin"]
    max_pairs, shadow_max_pairs = (_rounded(n, margin) for n in need)
    return max_pairs, shadow_max_pairs, (
        f"budget: max_pairs={max_pairs} = {need[0]} pairs, shadow_max_pairs={shadow_max_pairs} "
        f"= {need[1]} pairs of the largest map face (the most of {views} poses) x margin "
        f"{margin}, rounded up to {BUDGET_ROUND}")


def program_maps(shadow_maps) -> list:
    """The program's maps as reference/hybrid.Face lists, one per light."""
    out = []
    for m in shadow_maps:
        faces = []
        for f in getattr(m, "faces", [m]):
            cam = f.cam
            res = f.breakpoints.shape[0]
            faces.append(ref_hybrid.Face(Pose(cam.viewmat.detach().cpu().numpy(), float(cam.fx),
                                              float(cam.fy), float(cam.cx), float(cam.cy),
                                              float(cam.near), float(cam.far), res, res),
                                         f.breakpoints))
        out.append(faces)
    return out


def numbers(primary, shaded, normals, maps, ref, angle_deg: float) -> dict:
    """The gaps of one frame from the reference's ``HybridFrame``:
    ``checks.frame_numbers`` of the primary; the shaded image's root mean
    square gap and the share of its pixels off by more than
    SHADED_TOLERANCE in some channel; the share of the reference's shaded
    pixels whose normal is more than ``angle_deg`` off; and the share of
    (shaded pixel, light) whose shadow level, read from ``maps`` (one Face
    list per light) at the reference's shade points, differs from the
    reference's. A level flips where a splat crosses one of its
    transmittances by a rounding in one program and not in the other, so
    this is a share."""
    row = checks.frame_numbers(primary.image, primary.transmittance, primary.depth,
                               primary.splat_id, ref.primary)
    gap = torch.abs(shaded.float() - ref.shaded)
    row["shaded_rmse"] = float(torch.sqrt(torch.mean(gap ** 2)))
    row["shaded_off_share"] = float((gap.amax(dim=-1) > SHADED_TOLERANCE).float().mean())
    cov = ref.covered
    cos = (normals.float() * ref.normals).sum(dim=-1)
    off = cos < math.cos(math.radians(angle_deg))
    row["normal_off_share"] = float(off[cov].float().mean()) if bool(cov.any()) else 0.0
    flips = [(ref_hybrid.light_shadow_t(ref.points, faces) != t)[cov]
             for faces, t in zip(maps, ref.shadow_t)]
    row["shadow_level_off_share"] = (float(torch.cat(flips).float().mean())
                                     if flips and bool(cov.any()) else 0.0)
    return row


def takes_map_budget(fn) -> None:
    """Fail at once where the program's ``render_hybrid`` takes no map
    budget (a program older than the cell)."""
    params = inspect.signature(fn).parameters
    if "shadow_max_pairs" not in params and not any(
            p.kind == p.VAR_KEYWORD for p in params.values()):
        raise SystemExit("splatbench: the program's render_hybrid takes no shadow_max_pairs: "
                         "it cannot run this cell")


def run(config: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float, program: HybridProgram = HybridProgram()) -> Outcome:
    takes_map_budget(program.render_hybrid)
    plain_float32()
    inputs = make_scene(config, seed, dev)
    poses = poses_of(config, traffic["orbit"], seed)
    path = LightPath(config, traffic, poses, cameras.start_azimuth(seed))
    cfg = render_config(config, traffic)
    prepared = gt.SplatSet(**inputs).prepare(cfg.sh_format)
    del inputs  # made again for the reference once the window has closed
    shadow_res = config["shadow_res"]

    def frame(i: int, budgets):
        k = i % len(poses)
        return program.render_hybrid(prepared, camera(poses[k], dev), cfg, budgets[0],
                                     lights=path.program(k, dev), shadow_res=shadow_res,
                                     shadow_max_pairs=budgets[1])

    max_pairs, shadow_max_pairs, budget_line = fit_budgets(frame, len(poses), traffic)
    budgets = (max_pairs, shadow_max_pairs)
    print(budget_line, flush=True)
    for i in range(traffic["warmup_frames"]):
        frame(i, budgets)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    kept, flags, times, window_s = {}, [], [], 0.0
    counters = {"num_pairs": [], "shadow_pairs": []}
    if not traced:
        rng = np.random.default_rng(seed + 7)
        picks = set(int(k) for k in rng.choice(traffic["check_first"], traffic["check_frames"],
                                               replace=False))
        i = 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            res = frame(i, budgets)
            sync(dev)
            b = time.perf_counter()
            times.append(b - a)
            flags.append(res[0].overflow)
            if i in picks:
                kept[i] = res
            i += 1
            if b - t0 >= seconds and i % len(poses) == 0:
                break
        kept[i - 1] = res
        window_s = b - t0
    else:
        def call(i):
            res = frame(i, budgets)
            sync(dev)
            if i:
                kept[i] = res
                flags.append(res[0].overflow)
        events = trace.traced_events(call, traffic["trace_frames"], lambda: sync(dev))
        for i in sorted(kept):
            counters["num_pairs"].append(int(kept[i][0].num_pairs))
            counters["shadow_pairs"].append(int(kept[i][0].shadow_pairs))
    failed = int(torch.stack(flags).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del prepared
    res = None
    free(dev)

    ref_model, counted = reference(traffic), work(traffic)
    inputs = make_scene(config, seed, dev)
    rows, blends, frames = [], [], []
    for i in sorted(kept):
        out, shaded, normals = kept.pop(i)
        k = i % len(poses)
        ref = ref_model.render(inputs, poses[k], path.plain(k), shadow_res, count=traced,
                               background=config["background"])
        rows.append(numbers(out, shaded, normals, program_maps(out.shadow_maps), ref,
                            traffic["normal_angle_deg"]))
        if traced:
            blends.append(counted.shadow_blend(ref.counts))
            frames.append(counted.frame(config["splats"], ref.counts))
        del out, shaded, normals, ref
    summary = None
    if traced:
        # a frame's summary: the view readers' twins (idle_share, mfu) read it
        summary = spans.with_spans(
            trace.summarize(events, "view", traffic["trace_frames"], counters,
                            {"shadow_blend": mean_work(blends), "frame": mean_work(frames)}),
            events, SPANS)
    return Outcome(len(flags), failed, setup_s, window_s, times, peak, checks.worst(rows), [],
                   summary)
