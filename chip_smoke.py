"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path — ``render(prepared, camera, cfg)`` with the
default RenderConfig, the 3DGS raster frame — and checks it:

1. builds the CUDA tile blender (csrc/rasterize_fwd.cu) from the checkout
   and prints the card's name and power limit;
2. golden gate: the checked-in trained scene at 256x192 through the kernel,
   PSNR > 45 dB against assets/golden/golden_view0.npy, and the kernel
   against its plain PyTorch twin over the whole frame;
3. full size: 1,000,000 splats at SH degree 3 (96.9 / 2.5 / 0.6 % small /
   mid / large scales) at 1920x1080, made on the card from a seeded
   generator; 8 jittered frames through ``render``, with the kernel's launch
   count read around them; the exact expansion (max_pairs = 2^22), which
   must not overflow; a bit-equal repeat frame; 64 sampled tiles against
   the twin;
4. CUDA-event timings after warm-up: project, bin, blend and the whole
   frame, and the kernel against the twin at the frame's shape;
5. a torch.profiler trace of three frames per expansion: kernels and
   kernel time per stage, the six costliest kernels, and the device's idle
   share over the frames.

Without a CUDA device it raises and prints no result. The last line is
``{"ok": true, "device": {...}}``; the line before it holds the kernel
report as JSON. Every number printed was measured in this run.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# f32 everywhere: TF32 would shift projected geometry visibly
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

import vk_gaussian_splatting_tpu_torch as gt  # noqa: E402
from vk_gaussian_splatting_tpu_torch.io import load_ply  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import _build  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import render  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    bin_for_cfg,
    gs_attr_rows,
    raster_statics,
)
from vk_gaussian_splatting_tpu_torch.scene.splat_set import random_splats  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "assets", "golden")
KERNEL_SOURCE = "vk_gaussian_splatting_tpu_torch/csrc/rasterize_fwd.cu"
REPLACES = "vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:202"
FRAMES = 8
# Kernel against twin on one device: alphas agree bit for bit (-fmad=false,
# exact expf); transmittance products run in another order, and a pixel at
# T ~ min_transmittance (1e-4) may freeze one blend step apart.
KERNEL_ATOL = 1e-4
ID_AGREE = 0.999


def log(*a):
    print(*a, flush=True)


def gpu_name_and_limit() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int, warmup: int = 2) -> list[float]:
    """Per-call device milliseconds from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def median(xs):
    return float(np.median(np.asarray(xs)))


def compare_kernel_with_twin(bins, st, tiles=None):
    """(max abs err on rgb+T, id agreement) of the kernel against the twin."""
    out_k, id_k = tr.rasterize_bins(bins, st)
    out_r, id_r = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                         bins.tile_count, st, tiles=tiles)
    if tiles is not None:
        out_k, id_k = out_k[tiles], id_k[tiles]
    torch.cuda.synchronize()
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item() if out_k.numel() else 0.0
    same = id_k == id_r
    check(torch.equal(out_k[:, 4][same], out_r[:, 4][same]),
          "kernel and twin picked the same splat at different depths")
    return err, same.float().mean().item()


def bins_of(prepared, cam, cfg, max_pairs=0):
    proj = project_splats(prepared, cam, cfg)
    rows, ids = gs_attr_rows(proj)
    return bin_for_cfg(proj, rows, ids, cfg, max_pairs)


def frame_stages(prepared, cam, cfg, max_pairs=0):
    """render_3dgs's stages as (name, step) pairs, each step reading what
    the one before it left in the returned dict."""
    st = raster_statics(cfg)
    c = {}

    def project():
        c["proj"] = project_splats(prepared, cam, cfg)

    def bin_():
        rows, ids = gs_attr_rows(c["proj"])
        c["bins"] = bin_for_cfg(c["proj"], rows, ids, cfg, max_pairs)

    def blend():
        c["out"] = tr.rasterize_bins(c["bins"], st)

    def assemble():
        tr.assemble_image(*c["out"], st.tiles_x, st.tiles_y, cfg.width, cfg.height,
                          cfg.background)

    return [("project", project), ("bin", bin_), ("blend", blend),
            ("assemble", assemble)], c


def profile_frames(name, stages, card, frames=3):
    """Device busy and idle share over `frames` staged frames, from the
    torch.profiler trace: busy is the union of kernel intervals, the span
    runs from the first kernel's start to the last one's end. Each kernel
    belongs to the stage whose device-side annotation holds it."""
    def frame():
        for stage, step in stages:
            with torch.profiler.record_function(stage):
                step()

    frame()  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel")
    annotations = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "gpu_user_annotation"]
    if not kernels:
        log(f"profile {name}: the profiler traced no kernels; idle share not measured")
        return
    busy, (cur_s, cur_e, _) = 0.0, kernels[0]
    for s, e, _ in kernels[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in kernels) - kernels[0][0]
    log(f"profile {name} ({card}): {frames} frames, {len(kernels)} kernels, device span "
        f"{span / 1e3:.3f} ms, kernel-busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / span:.4f}")
    for stage, _ in stages:
        spans = [(a, b) for a, b, n in annotations if n == stage]
        inside = [e - s for s, e, _ in kernels if any(a <= s and e <= b + 1 for a, b in spans)]
        log(f"profile {name} stage {stage}: kernels/frame={len(inside) / frames:.1f} "
            f"kernel_ms/frame={sum(inside) / 1e3 / frames:.4f} "
            f"span_ms/frame={sum(b - a for a, b in spans) / 1e3 / frames:.4f}")
    by_name = collections.Counter()
    for s, e, kname in kernels:
        by_name[kname[:72]] += e - s
    for kname, us in by_name.most_common(6):
        log(f"profile {name} kernel: ms/frame={us / 1e3 / frames:.4f} {kname}")


def golden_gate(dev):
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                     device=dev)
    prepared = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev).prepare()
    out = render(prepared, cam, cfg)
    ref = torch.from_numpy(np.load(os.path.join(GOLDEN, "golden_view0.npy"))
                           .astype(np.float32)).to(dev)
    mse = torch.mean((out.image.clamp(0, 1) - ref) ** 2).item()
    psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
    err, agree = compare_kernel_with_twin(bins_of(prepared, cam, cfg), raster_statics(cfg))
    log(f"golden: {w}x{h} psnr_db={psnr:.3f} kernel_vs_twin_max_abs={err:.3e} "
        f"id_agree={agree:.6f}")
    check(psnr > 45.0, f"golden PSNR {psnr} <= 45 dB")
    check(err <= KERNEL_ATOL, f"golden kernel vs twin {err} > {KERNEL_ATOL}")
    check(agree >= ID_AGREE, f"golden id agreement {agree}")
    return err


def bench_scene(dev, n: int, seed: int):
    """The repository's headline scene: small / mid / large splats in a
    96.9 / 2.5 / 0.6 % mix, SH degree 3, made on the card."""
    n_s, n_m = int(n * 0.969), int(n * 0.025)
    parts = []
    for i, (count, scales) in enumerate(((n_s, (-7.0, -5.0)), (n_m, (-5.0, -3.5)),
                                         (n - n_s - n_m, (-3.5, -2.0)))):
        g = torch.Generator(device=dev).manual_seed(seed * 3 + i)
        parts.append(random_splats(g, count, sh_degree=3, extent=4.0, scale_range=scales))
    fields = {f: torch.cat([getattr(p, f) for p in parts]) for f in
              ("means", "scales", "quats", "opacities", "sh_dc", "sh_rest")}
    return gt.SplatSet(**fields).prepare()


def jitter(cam, i: int):
    """Per-frame camera nudge along x (1e-4 per frame)."""
    vm = cam.viewmat.clone()
    vm[0, 3] += i * 1e-4
    return dataclasses.replace(cam, viewmat=vm)


def full_size(dev, card: str, seed: int):
    cfg = gt.RenderConfig(width=1920, height=1080, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    prepared = bench_scene(dev, 1_000_000, seed)
    torch.cuda.synchronize()

    # ---- the main path: FRAMES frames through render(), launches counted
    tr.rasterize_tiles.launches = 0
    outs = [render(prepared, jitter(cam, i), cfg) for i in range(FRAMES)]
    torch.cuda.synchronize()
    launches = tr.rasterize_tiles.launches
    log(f"main path: {FRAMES} frames, rasterize_fwd launches={launches}")
    check(launches == FRAMES, f"{launches} kernel launches for {FRAMES} frames")
    for o in outs:
        check(tuple(o.image.shape) == (cfg.height, cfg.width, 3), "image shape")
        check(bool(torch.isfinite(o.image).all()), "non-finite image")
        check(bool(((o.transmittance >= 0) & (o.transmittance <= 1)).all()),
              "transmittance outside [0, 1]")
    o0 = outs[0]
    covered = (o0.transmittance < 0.5).float().mean().item()
    log(f"slots frame: overflow={bool(o0.overflow)} num_pairs={int(o0.num_pairs)} "
        f"covered_frac={covered:.4f} ids_picked={(o0.splat_id >= 0).float().mean().item():.4f}")
    check(covered > 0.05, "the frame covers almost nothing")
    del outs

    again = render(prepared, jitter(cam, 0), cfg)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(getattr(again, f), getattr(o0, f))
                    for f in ("image", "transmittance", "depth", "splat_id"))
    log(f"repeat frame bit-equal: {bit_equal}")
    check(bit_equal, "repeat render differs")

    exact_cfg = cfg.replace(raster=gt.RasterConfig(expansion="exact"))
    ex = render(prepared, cam, exact_cfg, max_pairs=1 << 22)
    torch.cuda.synchronize()
    log(f"exact frame: overflow={bool(ex.overflow)} num_pairs={int(ex.num_pairs)} "
        f"max_abs_vs_slots={(ex.image - o0.image).abs().max().item():.4e}")
    check(not bool(ex.overflow), "exact expansion with max_pairs=2^22 overflowed")
    check(bool(torch.isfinite(ex.image).all()), "non-finite exact image")
    del ex, again

    # ---- kernel against twin on 64 sampled tiles of the slots frame
    st = raster_statics(cfg)
    bins = bins_of(prepared, cam, cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    n_tiles = st.tiles_x * st.tiles_y
    busy = torch.nonzero(bins.tile_count > 0).flatten()
    tiles = torch.cat([busy[torch.randperm(busy.numel(), generator=g, device=dev)[:48]],
                       torch.randperm(n_tiles, generator=g, device=dev)[:16]])
    err, agree = compare_kernel_with_twin(bins, st, tiles=tiles)
    log(f"64 sampled tiles: kernel_vs_twin_max_abs={err:.3e} id_agree={agree:.6f} "
        f"max_tile_pairs={int(bins.tile_count.max())}")
    check(err <= KERNEL_ATOL, f"1080p tiles kernel vs twin {err} > {KERNEL_ATOL}")
    check(agree >= ID_AGREE, f"1080p tiles id agreement {agree}")

    # ---- timings (CUDA events; medians over 10 after 2 warm-up), stages in order
    stages, c = frame_stages(prepared, cam, cfg)
    t = {stage: median(time_ms(step, 10)) for stage, step in stages}
    t_frame = median(time_ms(lambda: render(prepared, cam, cfg), 10))
    t_exact = median(time_ms(lambda: render(prepared, cam, exact_cfg, max_pairs=1 << 22), 5))
    log(f"timing 1080p/1M slots ({card}): project_ms={t['project']:.4f} "
        f"bin_ms={t['bin']:.4f} blend_ms={t['blend']:.4f} assemble_ms={t['assemble']:.4f} "
        f"frame_ms={t_frame:.4f} exact_frame_ms={t_exact:.4f}")
    bins = c["bins"]
    t_plain = median(time_ms(lambda: tr.rasterize_tiles_ref(
        bins.attrs, bins.pair_id, bins.tile_start, bins.tile_count, st), 3, warmup=1))
    log(f"timing rasterize_fwd 1080p/1M ({card}): kernel_ms={t['blend']:.4f} "
        f"plain_twin_ms={t_plain:.4f}")
    del bins

    profile_frames("slots", stages, card)
    profile_frames("exact", frame_stages(prepared, cam, exact_cfg, max_pairs=1 << 22)[0], card)
    return launches, err, t["blend"], t_plain


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    was_built = _build.library_path("rasterize_fwd").exists()
    _build.load("rasterize_fwd")
    log(f"{'loaded prebuilt' if was_built else 'built'} "
        f"{_build.library_path('rasterize_fwd').name} in {time.perf_counter() - t0:.1f} s")
    log_file = str(_build.library_path("rasterize_fwd")) + ".log"
    if os.path.exists(log_file):
        log(open(log_file).read().strip())
    card = gpu_name_and_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"card: {card}")

    err_golden = golden_gate(dev)
    launches, err_tiles, t_kernel, t_plain = full_size(dev, card, seed=0)

    report = {"kernels": [{
        "name": "rasterize_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(err_golden, err_tiles), "ms": t_kernel, "plain_ms": t_plain,
    }]}
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
