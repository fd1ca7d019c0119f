"""Multi-process (multi-host) entry points.

The reference is a single-GPU app (SURVEY.md §2.4); scaling across devices
and hosts is ``torch.distributed`` here — one process (rank) per device,
NCCL between cards, gloo on the CPU — with the band-sharded policies of
parallel/sharded_render.py. This module is the init wrapper, the host-array
plumbing (each rank takes its rows of one identical host copy), and a
runnable multi-process training demo that the 2-process CPU test
(tests/test_torch_parallel.py) runs end to end over gloo on the loopback,
so the same entry point runs unchanged with one process per card.

Usage (one command per process; the coordinator is rank 0's address and a
free port):

    python -m vk_gaussian_splatting_tpu_torch.parallel.distributed \\
        --coordinator <host0>:29500 --num-processes N --process-id i

With no ``--coordinator`` the standard ``torchrun`` environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) describes the group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120  # each collective of the group; a rank that hangs fails the others


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               platform: str | None = None,
               timeout_s: float = TIMEOUT_S) -> None:
    """``init_process_group`` for this rank: gloo for platform="cpu", NCCL
    otherwise, the rank's card then ``process_id % device_count`` (made
    current). The group meets at ``tcp://<coordinator_address>`` (host:port)
    when given, else by ``env://``; num_processes and process_id are the
    world size and this rank (from the environment when None)."""
    if platform == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for NCCL: pass platform='cpu' for gloo")
        backend = "nccl"
        rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1,
        timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(axis: str = "data"):
    """1-D mesh over every rank of the group (``make_mesh``)."""
    from vk_gaussian_splatting_tpu_torch.parallel.sharded_render import make_mesh
    return make_mesh(None, axis)


def _tree_map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_leading(tree, mesh, axis: str = "data"):
    """This rank's rows of a tree (numpy arrays or tensors, on any device,
    in dataclasses, dicts, tuples, lists), on the rank's device: rows
    [r n / D, (r + 1) n / D) of every leaf's leading dim n, r the rank and
    D the mesh size. Every rank must hold the identical host copy (same
    seed / same file). The leading dims must divide the mesh size."""
    from vk_gaussian_splatting_tpu_torch.parallel.sharded_render import mesh_device
    size, rank, dev = mesh.size(), mesh.get_local_rank(), mesh_device(mesh)

    def put(x):
        n = x.shape[0]
        if n % size:
            raise ValueError(f"leading dim {n} must divide the mesh size {size}")
        k = n // size
        return torch.as_tensor(x[rank * k:(rank + 1) * k], device=dev)

    return _tree_map(put, tree)


def replicate(tree, mesh):
    """The whole tree (numpy arrays or tensors) on this rank's device."""
    from vk_gaussian_splatting_tpu_torch.parallel.sharded_render import mesh_device
    dev = mesh_device(mesh)
    return _tree_map(lambda x: torch.as_tensor(x, device=dev), tree)


def multiprocess_train_demo(n_splats: int = 256, width: int = 64,
                            height_tiles_per_dev: int = 1, steps: int = 3,
                            sh_degree: int = 1):
    """Run `steps` sharded train steps over the global mesh; returns a dict
    with losses, step time, and the collective-traffic estimate. All
    processes compute the identical result (same-seed host data)."""
    from vk_gaussian_splatting_tpu_torch.config import RenderConfig
    from vk_gaussian_splatting_tpu_torch.interop import random_splat_arrays
    from vk_gaussian_splatting_tpu_torch.parallel.sharded_render import (
        PROJ_FLOATS,
        mesh_device,
        train_step_sharded,
    )
    from vk_gaussian_splatting_tpu_torch.scene.cameras import look_at
    from vk_gaussian_splatting_tpu_torch.scene.splat_set import SplatSet

    mesh = global_mesh()
    nd = mesh.size()
    dev = mesh_device(mesh)
    cfg = RenderConfig(width=width, height=16 * height_tiles_per_dev * nd,
                       sh_degree=sh_degree)
    n = -(-n_splats // nd) * nd
    splats_h = random_splat_arrays(0, n, sh_degree=sh_degree, scale_range=(-3.0, -1.0))
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height, device="cpu")
    target_h = np.zeros((cfg.height, cfg.width, 3), np.float32)

    splats = SplatSet(**shard_leading(splats_h, mesh))
    cam = replicate(cam, mesh)
    target = shard_leading(target_h, mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = []
    t0 = None
    for step in range(steps):
        splats, loss = train_step_sharded(splats, cam, target, cfg,
                                          max_pairs=4096, mesh=mesh, lr=1e-4)
        losses.append(float(loss))
        if step == 0:
            sync()
            t0 = time.perf_counter()
    sync()
    dt = (time.perf_counter() - t0) / max(steps - 1, 1)

    # collective traffic: the all-gather of the projected fields (PROJ_FLOATS
    # f32 per splat) + the reduce-scatter of their gradients in the backward
    gather_bytes = n * PROJ_FLOATS * 4 * (nd - 1) // nd * 2  # fwd + bwd
    return {
        "num_processes": dist.get_world_size(),
        "num_devices": nd,
        "losses": losses,
        "step_time_s": dt,
        "pixels_per_s": cfg.width * cfg.height / dt,
        "collective_bytes_per_step": gather_bytes,
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None, help="rank 0's host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="cpu: gloo on the CPU (the test harness); default NCCL on the cards")
    ap.add_argument("--splats", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id,
               platform=args.platform)
    try:
        stats = multiprocess_train_demo(n_splats=args.splats, steps=args.steps)
        ok = all(np.isfinite(v) for v in stats["losses"])
        print(f"MULTIHOST_{'OK' if ok else 'FAIL'} "
              f"process={dist.get_rank()} {json.dumps(stats)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
