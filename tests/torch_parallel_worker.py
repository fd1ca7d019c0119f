"""One gloo rank of tests/test_torch_parallel.py (run as a script, one
process per rank, on the loopback; imports no JAX):

    python tests/torch_parallel_worker.py --rank R --world W --port P --out DIR

Joins the group through ``parallel.distributed.initialize``, takes its
shard of the test scene (``shard_leading`` of one host copy), runs the
sharded frames and train steps of ``JOBS`` and writes what its rank holds
to ``DIR/rank<R>.npz``. The scene, camera and configs are defined here and
imported by the test, so both sides use one definition.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import vk_gaussian_splatting_tpu_torch as gt  # noqa: E402
from vk_gaussian_splatting_tpu_torch import interop  # noqa: E402

WIDTH, HEIGHT = 64, 128  # 8 tile rows: two bands of 4, or three of 3, 3 and 2
SCENE = dict(seed=0, n=256, sh_degree=1, scale_range=(-3.0, -1.0))
DENSE = dict(seed=4, n=3000, sh_degree=1, scale_range=(-4.5, -3.5))  # overflows small caps
CAPS = (128, 256, 128, 128)
SMALL_CAPS = (128, 128, 128, 128)
BIG_CAPS = (1024, 128, 128, 128)
MAX_PAIRS = 8192
LR = 1e-4
TIMEOUT_S = 60  # each collective


def scene_arrays(spec=SCENE, n=None) -> dict:
    d = interop.random_splat_arrays(spec["seed"], spec["n"], sh_degree=spec["sh_degree"],
                                    scale_range=spec["scale_range"])
    return {k: v[:n] for k, v in d.items()}


def config(method="pairs", caps=CAPS) -> gt.RenderConfig:
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=SCENE["sh_degree"])
    if method == "bucket":
        cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, method="bucket",
                                                     bucket_caps=caps))
    return cfg


def camera(device="cpu"):
    return gt.look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, device=device)


def _raises(fn) -> bool:
    """True where ``fn`` raises ValueError (a refusal checked before any
    collective, so every rank refuses alike)."""
    try:
        fn()
    except ValueError:
        return True
    return False


def main(argv=None):
    from vk_gaussian_splatting_tpu_torch.parallel import distributed as pd
    from vk_gaussian_splatting_tpu_torch.parallel import sharded_render as sr

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=SCENE["n"], help="splats of the scene")
    ap.add_argument("--full", action="store_true",
                    help="also the gut and grt frames, overflow and the train steps")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    pd.initialize(f"127.0.0.1:{args.port}", args.world, args.rank, platform="cpu",
                  timeout_s=TIMEOUT_S)
    try:
        mesh = sr.make_mesh(args.world)
        cam = pd.replicate(camera(), mesh)
        splats = gt.SplatSet(**pd.shard_leading(scene_arrays(n=args.n), mesh))
        res = {}
        for method in ("pairs", "bucket"):
            img, trans, ov = sr.render_3dgs_sharded(splats, cam, config(method), MAX_PAIRS, mesh)
            res.update({f"{method}_img": img, f"{method}_trans": trans, f"{method}_ov": ov})
        if args.full:
            for name, fn in (("gut", sr.render_3dgut_sharded), ("grt", sr.render_3dgrt_sharded)):
                for method in ("pairs", "bucket"):
                    img, trans, ov = fn(splats, cam, config(method), MAX_PAIRS, mesh)
                    res.update({f"{name}_{method}_img": img, f"{name}_{method}_trans": trans})
            dense = gt.SplatSet(**pd.shard_leading(scene_arrays(DENSE), mesh))
            for tag, caps in (("small", SMALL_CAPS), ("big", BIG_CAPS)):
                res[f"ov_{tag}"] = sr.render_3dgs_sharded(dense, cam, config("bucket", caps), 0,
                                                          mesh)[2]
            res["refusals"] = torch.tensor([
                _raises(lambda: sr.make_mesh(args.world + 1)),
                _raises(lambda: pd.shard_leading({"a": np.zeros(2 * args.world + 1)}, mesh)),
                _raises(lambda: sr.train_step_sharded(splats, cam, torch.zeros((1, WIDTH, 3)),
                                                      config(), MAX_PAIRS, mesh))])
            y0, y1 = sr.band_span(config(), args.rank, args.world)
            target = torch.zeros((y1 - y0, WIDTH, 3))
            for method in ("pairs", "bucket"):
                for tag, lr in (("step", LR), ("grad", 1.0)):
                    new, loss = sr.train_step_sharded(splats, cam, target, config(method),
                                                      MAX_PAIRS, mesh, lr=lr)
                    res[f"{method}_{tag}_loss"] = loss
                    for f in interop.SPLAT_FIELDS:
                        res[f"{method}_{tag}_{f}"] = getattr(new, f)
        np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in res.items()})
    finally:
        pd.dist.destroy_process_group()


if __name__ == "__main__":
    main()
