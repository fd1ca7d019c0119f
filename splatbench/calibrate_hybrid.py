"""The readings that the limits of a ``hybrid`` cell's ``correct`` are set
from, at the cell's own size, several seeds in one process:

    python3 -m splatbench.calibrate_hybrid --workload greenhouse_15m.view_hybrid --seeds 1 2

For each seed it prints one JSON line per variant with what
``checks.judge`` compares, each number beside its limit:

- ``program``: the program as the cell runs it (kinds/hybrid.py, a window
  of one pass over the orbit);
- ``control``: the reference computed with bfloat16 storage
  (reference/hybrid.render, precision "bf16") in the program's place, at
  the frames the run checks, against the float32 reference;
- the faults, each the cell's runner with a broken ``render_hybrid``:
  ``shadows_ignored`` (the shade without its maps), ``stale_maps`` (the
  maps rendered with the previous frame's lights) and ``altered`` (one
  16x16 block of the shaded image 0.05 brighter).

The benchmark's own runs never run these; the fault tests drive a whole
CPU run with each (splatbench/tests/test_splatbench_hybrid.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.render.deferred import DeferredMaterial, deferred_shade
from vk_gaussian_splatting_tpu_torch.render.pipelines import render_hybrid
from vk_gaussian_splatting_tpu_torch.render.shadows import make_shadow_fn
from splatbench import cameras, checks, spec, workloads
from splatbench.kinds import hybrid


def shadows_ignored(prepared, cam, cfg, max_pairs=0, lights=(), **kw):
    """A frame whose shade ignores its maps: the maps are rendered, the
    shade is unshadowed."""
    out, _, normals = render_hybrid(prepared, cam, cfg, max_pairs, lights=lights, **kw)
    shaded = deferred_shade(out.image, out.transmittance, normals, out.depth, cam, cfg,
                            list(lights), DeferredMaterial())
    return out, shaded, normals


class StaleMaps:
    """Frames whose maps are one frame stale: rendered with the lights of
    the call before (the first call's own), the shade with its own."""

    def __init__(self):
        self.before = None

    def __call__(self, prepared, cam, cfg, max_pairs=0, lights=(), shadow_res=512,
                 shadow_max_pairs=None, **kw):
        out, _, normals = render_hybrid(prepared, cam, cfg, max_pairs, lights=lights,
                                        shadow_res=shadow_res,
                                        shadow_max_pairs=shadow_max_pairs, **kw)
        before = self.before or lights
        self.before = lights
        stale = make_shadow_fn(prepared, before, cfg, shadow_res, shadow_max_pairs)
        of = {id(now): then for now, then in zip(lights, before)}
        shaded = deferred_shade(out.image, out.transmittance, normals, out.depth, cam, cfg,
                                list(lights), DeferredMaterial(),
                                shadow_fn=lambda pts, light: stale(pts, of[id(light)]))
        return dataclasses.replace(out, shadow_maps=tuple(stale.maps.values())), shaded, normals


def altered(prepared, cam, cfg, max_pairs=0, **kw):
    """A frame whose answer is altered where it is produced: one 16x16
    block of the shaded image 0.05 brighter."""
    out, shaded, normals = render_hybrid(prepared, cam, cfg, max_pairs, **kw)
    shaded = shaded.clone()
    shaded[:16, :16] += 0.05
    return out, shaded, normals


FAULTS = {"shadows_ignored": lambda: shadows_ignored, "stale_maps": StaleMaps,
          "altered": lambda: altered}


def control_numbers(config: dict, traffic: dict, seed: int, dev, frames) -> dict:
    """The worst numbers over ``frames`` (orbit pose indices) of the
    reference with bfloat16 storage against the float32 reference."""
    workloads.plain_float32()
    inputs = workloads.make_scene(config, seed, dev)
    poses = workloads.poses_of(config, traffic["orbit"], seed)
    path = hybrid.LightPath(config, traffic, poses, cameras.start_azimuth(seed))
    model = workloads.reference(traffic)
    rows = []
    for k in frames:
        args = (inputs, poses[k], path.plain(k), config["shadow_res"])
        ref = model.render(*args, background=config["background"])
        low = model.render(*args, precision="bf16", background=config["background"])
        rows.append(hybrid.numbers(low.primary, low.shaded, low.normals, low.maps, ref,
                                   traffic["normal_angle_deg"]))
        del ref, low
    return checks.worst(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+",
                    default=["program", "control"] + list(FAULTS))
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_hybrid: no CUDA device")
    dev = torch.device("cuda", 0)
    config, traffic = cell["config"], cell["traffic"]
    for seed in args.seeds:
        for name in args.variants:
            t0 = time.perf_counter()
            if name == "control":
                rng = np.random.default_rng(seed + 7)
                frames = [int(k) for k in rng.choice(traffic["check_first"],
                                                     traffic["check_frames"], replace=False)]
                numbers, failed, attempted = control_numbers(config, traffic, seed, dev,
                                                             frames), 0, len(frames)
            else:
                program = hybrid.HybridProgram(
                    **({} if name == "program" else {"render_hybrid": FAULTS[name]()}))
                out = hybrid.run(config, traffic, seed, 0.0, False, dev, t0, program)
                numbers, failed, attempted = out.numbers, out.failed, out.attempted
                del out
            ok, compared = checks.judge(dict(numbers, failed=failed), traffic["limits"])
            print(json.dumps(dict(workload=args.workload, seed=seed, variant=name, correct=ok,
                                  checks=compared, attempted=attempted,
                                  seconds=time.perf_counter() - t0)), flush=True)
            workloads.free(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
