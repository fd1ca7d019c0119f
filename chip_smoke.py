"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths — the 3DGS raster frame, ``render(prepared,
camera, cfg)``, and the training step, ``train_step`` (render, loss,
backward, Adam), each by the pair path (the default RenderConfig) and by
the bucket path (``RasterConfig(method="bucket")``) — and checks them:

1. builds the CUDA kernels from the checkout, one nvcc per source, all at
   once: the pair blender K1 (csrc/rasterize_fwd.cu) and its backward K2
   (csrc/rasterize_bwd.cu), the bucket rasterizer K3
   (csrc/raster_bucket_fwd.cu) and its backward K4
   (csrc/raster_bucket_bwd.cu); prints their -Xptxas -v reports and the
   card's name and power limit;
2. golden gate: the checked-in trained scene at 256x192 through K1, PSNR
   > 45 dB against assets/golden/golden_view0.npy, and K1 against its plain
   PyTorch twin over the whole frame; golden gradients at 128x96, SH 0: K2
   against the twin backward over the whole frame (``bwd_gate``, which
   must also reject the twin on two broken contexts), and a central
   difference of 4 high-gradient opacities through ``render`` on the card;
3. forward at full size: 1,000,000 splats at SH degree 3 (96.9 / 2.5 / 0.6 %
   small / mid / large scales) at 1920x1080, made on the card from a seeded
   generator; 8 jittered frames through ``render``, with K1's launch count
   read around them; the exact expansion (max_pairs = 2^22), which must not
   overflow; a bit-equal repeat frame; 64 sampled tiles against the twin;
4. training at full size: the same scene is the target, the start has
   seeded jitter on means and sh_dc; 5 ``train_step``s with both kernels'
   launch counts read around them, a falling finite loss and finite
   gradients; one exact-expansion step; K2 against the twin backward on 64
   sampled tiles; a bit-equal repeat backward;
5. CUDA-event timings after warm-up: project, bin, blend and the whole
   frame; K1 and K2 against their twins at the frame's shape; fwd_bwd and
   train_step; the (pixel, pair) evaluations and hits that both kernels'
   bounds count;
6. torch.profiler traces of three ``render`` calls per expansion and of
   three ``train_step`` calls: kernels and kernel time per stage (the
   entry points' own spans), the eight costliest kernels, and the device's
   idle share;
7. the bucket path, as 2-6 for the pair path: the golden frame at caps
   fitted to it (``measure_required_caps`` -> ``fit_caps``), PSNR > 45 dB,
   no overflow, within 1e-4 of the pair frame, K3 against its twin over the
   frame; golden gradients, K4 against its twin (``bwd_gate``) and a
   central difference through ``render``; at full size, caps derived over
   the 8 jittered frames with margin 1.25 (doubled once if a frame still
   overflows), 8 frames with K3's launches counted, a bit-equal repeat,
   64 sampled tiles against the twin, the share of pixels within 2e-4 of
   the exact pair frame; 5 train steps with K3's and K4's launches
   counted, K4 against its twin on 64 sampled tiles, a bit-equal repeat
   backward; timings and profiles as above.

Without a CUDA device it raises and prints no result. The last line is
``{"ok": true, "device": {...}}``; the line before it holds the kernel
report as JSON, and the line before that the card's name and power limit.
Every number printed was measured in this run; each kernel's bound is
computed from this run's inputs (``kernel_bound``).
"""

from __future__ import annotations

import collections
import concurrent.futures
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
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import (  # noqa: E402
    BucketGridSpec,
    bucket_splats,
    fit_caps,
    measure_required_caps,
    span_lengths,
)
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import render  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    bin_for_cfg,
    bucket_statics,
    gs_attr_rows,
    raster_statics,
)
from vk_gaussian_splatting_tpu_torch.scene.splat_set import random_splats  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIELDS = ("means", "scales", "quats", "opacities", "sh_dc", "sh_rest")
GOLDEN = os.path.join(HERE, "assets", "golden")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "rasterize_fwd": ("vk_gaussian_splatting_tpu_torch/csrc/rasterize_fwd.cu",
                      "vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:202"),
    "rasterize_bwd": ("vk_gaussian_splatting_tpu_torch/csrc/rasterize_bwd.cu",
                      "vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:367"),
    "raster_bucket_fwd": ("vk_gaussian_splatting_tpu_torch/csrc/raster_bucket_fwd.cu",
                          "vk_gaussian_splatting_tpu/ops/raster_bucket.py:469"),
    "raster_bucket_bwd": ("vk_gaussian_splatting_tpu_torch/csrc/raster_bucket_bwd.cu",
                          "vk_gaussian_splatting_tpu/ops/raster_bucket.py:927"),
}
WIDTH, HEIGHT, SPLATS = 1920, 1080, 1_000_000  # the headline cell
FRAMES = 8
TRAIN_STEPS = 5
# Kernel against twin on one device: alphas agree bit for bit (-fmad=false,
# exact expf); transmittance products run in another order, and a pixel at
# T ~ min_transmittance (1e-4) may freeze one blend step apart.
KERNEL_ATOL = 1e-4
ID_AGREE = 0.999
# K2 against the twin backward, two gates (``bwd_gate``). Alphas agree bit
# for bit; T, the running colour sum and the sums over a tile's pixels run
# in other orders. The suffix S_total - s_run cancels to ~ulp(S_total) at a
# pixel's last pairs and is divided by 1 - alpha, down to 1 - alpha_clamp =
# 1e-3: up to ~1.2e-4 of S_total per pair-pixel. So each gradient row must
# lie within 1e-4 of the row's max abs (measured up to 1.9e-5 on the golden
# frame, whose cotangents all share one sign). The rows have long tails (at
# 1080p a conic row's median nonzero value is ~3e-7 of its max), so that
# bound cannot see a row's ordinary values. Hence the second gate: in each
# row, at least 99.9 % of values within 1e-2 of their own size plus the
# row's median nonzero size (the 99.9th percentile of that ratio measured
# up to 1.5e-3 on the golden frame and 8.6e-5 at 1080p). Each run also
# shows that the gates reject the twin on a broken context: one warp of
# every tile with a zero cotangent (a warp that drops out), and S_total
# zeroed (a wrong suffix).
BWD_RTOL = 1e-4
BWD_ELEM_RTOL, BWD_ELEM_SHARE = 1e-2, 0.999
# The bound: f32 operations, each add, multiply, compare, select and exp
# counted as one, as the kernels' sources spell them. Every (pixel, pair)
# evaluation costs the alpha test (17: offsets 2, quadratic form 9, scale,
# exp, opacity, 2 cutoffs, clamp); a hit, an evaluation whose alpha passes
# the cutoffs, adds the blend in K1 (10: weight, 3 colour multiply-adds,
# T update, depth pick) and in K2 about 44 for the gradient and 9 adds to
# reduce the nine gradients over the tile (``ops/rasterize.blend_work``
# counts both). The bucket kernels K3 and K4 do the same per evaluation and
# hit, over each tile's merged window (``ops/raster_bucket.bucket_work``),
# plus one operation per key comparison of the merge and, in K4, one add
# per (row, tile, shared lane) of the reduce over the reading tiles.
OPS_ALPHA = 17
OPS_PER_HIT = {"rasterize_fwd": 10, "rasterize_bwd": 53,
               "raster_bucket_fwd": 10, "raster_bucket_bwd": 53}
# the bucket frame against the exact pair frame: they freeze pixels at
# different lanes (bucket_chunk 384 against chunk 128) and may order exactly
# equal depths apart, so a share of pixels, not the max
BUCKET_VS_PAIR_ATOL, BUCKET_VS_PAIR_SHARE = 2e-4, 0.999
TWIN_BATCH = 1024  # tiles per twin call at 1080p: a (1024, 256, 384) f32 step is 0.4 GB
# the stage spans that render_3dgs and train_step open, in step order
STAGES = ("prepare", "project", "bin", "blend", "assemble", "loss", "backward", "optimizer")
PEAK_F32_OPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12   # H100 SXM HBM3


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


def row_typical(mag):
    """(rows, 1) median nonzero value of each row of ``mag`` (0 if none)."""
    return torch.stack([r[r > 0].median() if bool((r > 0).any()) else r.new_zeros(())
                        for r in mag])[:, None]


def bwd_gate(d_k, d_r):
    """(passes, max abs err, max err / row max, least share over the rows
    of values inside the elementwise limit, each row's 99.9th percentile
    of |err| / (|ref| + row median)) of gradient rows ``d_k`` against
    reference rows ``d_r``."""
    diff, mag = (d_k - d_r).abs(), d_r.abs()
    rel = (diff / mag.amax(dim=1, keepdim=True).clamp_min(1e-30)).max().item()
    ratio = diff / (mag + row_typical(mag)).clamp_min(1e-30)
    share = (ratio <= BWD_ELEM_RTOL).float().mean(dim=1).min().item()
    p999 = torch.quantile(ratio, 0.999, dim=1).tolist()
    return rel <= BWD_RTOL and share >= BWD_ELEM_SHARE, diff.max().item(), rel, share, p999


def gate_bwd_against_twin(label, d_k, twin, ctx, cols):
    """(max abs err, max err relative to each row's max) of a backward
    kernel's d_attrs ``d_k`` against ``twin(ctx)`` on the columns ``cols``.
    Fails unless ``bwd_gate`` passes, and unless it rejects the twin on two
    broken contexts."""
    d_k, d_r = d_k[:, cols], twin(ctx)[:, cols]
    check(bool((d_k[tr.GRAD_ROWS:] == 0).all()), f"{label} wrote the depth row")
    d_k, d_r = d_k[:tr.GRAD_ROWS], d_r[:tr.GRAD_ROWS]
    ok, abs_err, rel_err, share, p999 = bwd_gate(d_k, d_r)
    typical = row_typical(d_r.abs()) / d_r.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    log(f"  {label} vs twin on {d_r.shape[1]} columns: max err / row max {rel_err:.3e} "
        f"(gate {BWD_RTOL:g}); least share per row within {BWD_ELEM_RTOL:g} (|ref| + "
        f"row median) {share:.6f} (gate {BWD_ELEM_SHARE}); per row, p99.9 of that ratio: "
        + " ".join(f"{x:.2e}" for x in p999) + "; median nonzero |ref| / row max: "
        + " ".join(f"{x:.2e}" for x in typical.flatten().tolist()))
    check(ok, f"{label} vs twin outside the gates: {rel_err} / {share}")
    warp_out, no_suffix = ctx.clone(), ctx.clone()
    warp_out[:, :, 96:128] = 0.0
    no_suffix[:, 3] = 0.0
    for what, bad in (("one warp's cotangent zeroed", warp_out), ("S_total zeroed", no_suffix)):
        ok, _, bad_rel, bad_share, _ = bwd_gate(twin(bad)[:tr.GRAD_ROWS, cols], d_r)
        log(f"  gate self-check, twin with {what}: max err / row max {bad_rel:.3e}, "
            f"share within {bad_share:.6f}, rejected={not ok}")
        check(not ok, f"the {label} gate passed a twin with {what}")
    return abs_err, rel_err


def compare_bwd_with_twin(bins, st, ctx, tiles=None):
    """K2 against the twin backward on the pairs of ``tiles`` (all by
    default): ``gate_bwd_against_twin``."""
    if tiles is None:
        tiles = torch.arange(st.tiles_x * st.tiles_y, device=ctx.device)

    def twin(c):
        return tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start, bins.tile_count, c,
                                          st, tiles=tiles)

    pairs = torch.cat([torch.arange(a, a + n, device=ctx.device) for a, n in
                       zip(bins.tile_start[tiles].tolist(), bins.tile_count[tiles].tolist())])
    d_k = tr.rasterize_tiles_bwd(bins.attrs, bins.tile_start, bins.tile_count, ctx, st)
    return gate_bwd_against_twin("K2", d_k, twin, ctx, pairs)


def sample_tiles(bins, st, dev, seed):
    """48 busy tiles and 16 random ones, from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    busy = torch.nonzero(bins.tile_count > 0).flatten()
    return torch.cat([busy[torch.randperm(busy.numel(), generator=g, device=dev)[:48]],
                      torch.randperm(st.tiles_x * st.tiles_y, generator=g, device=dev)[:16]])


def kernel_bound(name: str, evals: int, hits: int, bytes_moved: int, extra_ops: int = 0):
    """(bound ms, what bounds it): the larger of the f32 operations over the
    card's f32 peak and the bytes over its memory rate."""
    t_ops = (evals * OPS_ALPHA + hits * OPS_PER_HIT[name] + extra_ops) / PEAK_F32_OPS * 1e3
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bin_stage(proj, cfg, max_pairs=0):
    """render_3dgs's bin stage for either method: TileBins or BucketBins."""
    rows, ids = gs_attr_rows(proj)
    if cfg.raster.method == "bucket":
        st = bucket_statics(cfg)
        return bucket_splats(proj, rows, ids, tiles_x=st.tiles_x, tiles_y=st.tiles_y,
                             caps=cfg.raster.bucket_caps)
    return bin_for_cfg(proj, rows, ids, cfg, max_pairs)


def bins_of(prepared, cam, cfg, max_pairs=0):
    return bin_stage(project_splats(prepared, cam, cfg), cfg, max_pairs)


def frame_stages(prepared, cam, cfg, max_pairs=0):
    """render_3dgs's stages as (name, step) pairs, each step reading what
    the one before it left in the returned dict: for per-stage CUDA-event
    timings and for the blend's own inputs and outputs."""
    bucket = cfg.raster.method == "bucket"
    st = bucket_statics(cfg) if bucket else raster_statics(cfg)
    c = {}

    def project():
        c["proj"] = project_splats(prepared, cam, cfg)

    def bin_():
        c["bins"] = bin_stage(c["proj"], cfg, max_pairs)

    def blend():
        c["out"] = (rb.rasterize_buckets(c["bins"], st, cfg.raster.bucket_caps) if bucket
                    else tr.rasterize_bins(c["bins"], st))

    def assemble():
        c["image"] = tr.assemble_image(*c["out"], st.tiles_x, st.tiles_y, cfg.width,
                                       cfg.height, cfg.background)[0]

    return [("project", project), ("bin", bin_), ("blend", blend),
            ("assemble", assemble)], c


def profile_calls(name, call, card, calls=3):
    """Device busy and idle share over `calls` calls of an entry point, from
    the torch.profiler trace: busy is the union of kernel intervals, the
    span runs from the first kernel's start to the last one's end. Each
    kernel belongs to the stage span (STAGES, opened by render_3dgs and
    train_step themselves) that holds its launch call, matched by the
    trace's correlation id, so the kernels autograd launches from its own
    thread count in the backward stage."""
    call()  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"],
                      e.get("args", {}).get("correlation")) for e in events
                     if e.get("cat") == "kernel")
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in STAGES]
    if not kernels:
        log(f"profile {name}: the profiler traced no kernels; idle share not measured")
        return
    busy, (cur_s, cur_e, _, _) = 0.0, kernels[0]
    for s, e, _, _ in kernels[1:]:
        if s > cur_e:
            busy, cur_s = busy + cur_e - cur_s, s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(k[1] for k in kernels) - kernels[0][0]
    log(f"profile {name} ({card}): {calls} calls, {len(kernels)} kernels, device span "
        f"{span / 1e3:.3f} ms, kernel-busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / span:.4f}")

    def stage_of(corr):
        t = launched_at.get(corr)
        return next((n for a, b, n in spans if t is not None and a <= t <= b), None)

    per_stage = collections.defaultdict(list)
    for s, e, _, corr in kernels:
        per_stage[stage_of(corr)].append(e - s)
    for stage in (*STAGES, None):
        inside = per_stage.get(stage, [])
        host = sum(b - a for a, b, n in spans if n == stage)
        if not inside and not host:
            continue
        log(f"profile {name} stage {stage or 'unattributed'}: "
            f"kernels/call={len(inside) / calls:.1f} "
            f"kernel_ms/call={sum(inside) / 1e3 / calls:.4f} "
            f"host_span_ms/call={host / 1e3 / calls:.4f}")
    by_name = collections.Counter()
    for s, e, kname, _ in kernels:
        by_name[kname[:72]] += e - s
    for kname, us in by_name.most_common(8):
        log(f"profile {name} kernel: ms/call={us / 1e3 / calls:.4f} {kname}")


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


def golden_gradients(dev):
    """The golden scene at 128x96, SH 0 (tests/test_golden.py:93-119): K2
    against the twin backward over the whole frame, for the cotangent of
    sum(image^2); then a central difference of 4 high-gradient opacities
    through ``render`` on the card (the sum taken in float64, so the
    quotient sees the image's rounding, not the sum's)."""
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev)
    st = raster_statics(cfg)
    bins = bins_of(splats.prepare(), cam, cfg)
    out, out_id = tr.rasterize_bins(bins, st)
    out = out.requires_grad_()
    image = tr.assemble_image(out, out_id, st.tiles_x, st.tiles_y, cfg.width, cfg.height,
                              cfg.background)[0]
    (g_out,) = torch.autograd.grad((image ** 2).sum(), out)
    abs_err, rel_err = compare_bwd_with_twin(bins, st, tr.bwd_context(out.detach(), g_out))

    def loss(op):
        s = dataclasses.replace(splats, opacities=op)
        return torch.sum(render(s.prepare(), cam, cfg).image.double() ** 2)

    op0 = splats.opacities.clone().requires_grad_()
    loss(op0).backward()
    g = op0.grad
    big = torch.nonzero(g.abs() > torch.quantile(g.abs(), 0.99)).flatten()
    idx = big[torch.randperm(big.numel(), generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)[:4]]
    eps, worst = 1e-2, 0.0
    with torch.no_grad():
        for i in idx.tolist():
            op = splats.opacities.clone()
            op[i] += eps
            lp = loss(op).item()
            op[i] -= 2 * eps
            lm = loss(op).item()
            fd, gi = (lp - lm) / (2 * eps), g[i].item()
            worst = max(worst, abs(fd - gi) / max(abs(fd), abs(gi), 1.0))
    log(f"golden gradients: 128x96 K2_vs_twin_max_abs={abs_err:.3e} "
        f"max_rel_to_row_max={rel_err:.3e} central_difference_worst_rel={worst:.3e}")
    check(rel_err <= BWD_RTOL, f"golden K2 vs twin {rel_err} > {BWD_RTOL}")
    check(worst < 2e-2, f"golden central difference off by {worst}")
    return abs_err


def bench_scene(dev, n: int, seed: int) -> gt.SplatSet:
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
    return gt.SplatSet(**fields)


def jitter(cam, i: int):
    """Per-frame camera nudge along x (1e-4 per frame)."""
    vm = cam.viewmat.clone()
    vm[0, 3] += i * 1e-4
    return dataclasses.replace(cam, viewmat=vm)


def full_size(dev, card: str, prepared, seed: int):
    """The forward path at 1080p with 1M splats; returns K1's report entry
    and both kernels' bounds at this frame."""
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
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
    tiles = sample_tiles(bins, st, dev, seed)
    err, agree = compare_kernel_with_twin(bins, st, tiles=tiles)
    log(f"64 sampled tiles: kernel_vs_twin_max_abs={err:.3e} id_agree={agree:.6f} "
        f"max_tile_pairs={int(bins.tile_count.max())}")
    check(err <= KERNEL_ATOL, f"1080p tiles kernel vs twin {err} > {KERNEL_ATOL}")
    check(agree >= ID_AGREE, f"1080p tiles id agreement {agree}")

    # ---- the bound of both kernels at this frame's shape and data
    evals, hits = tr.blend_work(bins.attrs, bins.tile_start, bins.tile_count, st)
    n_pairs, n_tiles = int(bins.num_pairs), st.tiles_x * st.tiles_y
    bytes_fwd = n_pairs * (10 * 4 + 4) + n_tiles * (2 * 4 + tr.PIX * (tr.OUT_ROWS * 4 + 4))
    bytes_bwd = n_pairs * 2 * tr.GRAD_ROWS * 4 + n_tiles * (2 * 4 + tr.PIX * tr.CTX_ROWS * 4)
    bounds = {"rasterize_fwd": kernel_bound("rasterize_fwd", evals, hits, bytes_fwd),
              "rasterize_bwd": kernel_bound("rasterize_bwd", evals, hits, bytes_bwd)}
    log(f"bound 1080p/1M slots: live_pairs={n_pairs} pixel_pair_evaluations={evals} "
        f"hits={hits} hit_share={hits / max(evals, 1):.4f} "
        + " ".join(f"{k}_bound_ms={v[0]:.4f} ({v[1]})" for k, v in bounds.items()))
    del bins

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
    del bins, c

    profile_calls("slots", lambda: render(prepared, cam, cfg), card)
    profile_calls("exact", lambda: render(prepared, cam, exact_cfg, max_pairs=1 << 22), card)
    return dict(launches=launches, max_abs_err=err, ms=t["blend"], plain_ms=t_plain), bounds


def grads_of(splats):
    return [getattr(splats, f).grad for f in FIELDS]


def train_full_size(dev, card: str, truth: gt.SplatSet, seed: int):
    """The training path at 1080p with 1M splats: the scene renders its own
    target; training starts from seeded jitter on means and sh_dc."""
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    tc = gt.TrainConfig(scene_extent=4.0)
    with torch.no_grad():
        target = render(truth.prepare(), cam, cfg).image
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    fields = {f: getattr(truth, f).detach().clone() for f in FIELDS}
    fields["means"] += 1e-3 * torch.randn(fields["means"].shape, generator=g, device=dev)
    fields["sh_dc"] += 0.3 * torch.randn(fields["sh_dc"].shape, generator=g, device=dev)
    splats = gt.SplatSet(**fields)
    opt = gt.make_optimizer(splats, tc)
    torch.cuda.synchronize()

    # ---- the training path: TRAIN_STEPS steps, both kernels' launches counted
    tr.rasterize_tiles.launches = tr.rasterize_tiles_bwd.launches = 0
    steps = [gt.train_step(splats, opt, cam, target, cfg, 0, tc) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = (tr.rasterize_tiles.launches, tr.rasterize_tiles_bwd.launches)
    losses = [loss.item() for loss, _ in steps]
    log(f"training path: {TRAIN_STEPS} steps, rasterize_fwd launches={launches[0]} "
        f"rasterize_bwd launches={launches[1]}")
    log(f"train losses: {' '.join(f'{x:.6f}' for x in losses)} overflow="
        f"{[bool(o) for _, o in steps]} (slots truncates wide splats by design)")
    check(launches == (TRAIN_STEPS, TRAIN_STEPS),
          f"{launches} kernel launches for {TRAIN_STEPS} train steps")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(bool(torch.isfinite(x).all()) for x in grads_of(splats)),
          "non-finite gradient in the last train step")

    exact_cfg = cfg.replace(raster=gt.RasterConfig(expansion="exact"))
    opt.zero_grad(set_to_none=True)
    ex = render(splats.prepare(), cam, exact_cfg, max_pairs=1 << 22)
    gt.rgb_loss(ex.image, target, tc.ssim_lambda).backward()
    torch.cuda.synchronize()
    log(f"exact fwd+bwd: overflow={bool(ex.overflow)} finite_grads="
        f"{all(bool(torch.isfinite(x).all()) for x in grads_of(splats))}")
    check(not bool(ex.overflow), "exact training frame overflowed")
    check(all(bool(torch.isfinite(x).all()) for x in grads_of(splats)),
          "non-finite gradient in the exact step")
    del ex

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        out = render(splats.prepare(), cam, cfg)
        gt.rgb_loss(out.image, target, tc.ssim_lambda).backward()

    # ---- a repeat backward is bit-equal (slots frame, no step between)
    fwd_bwd()
    first = [x.clone() for x in grads_of(splats)]
    fwd_bwd()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, grads_of(splats))]
    bit_equal = all(same)
    log(f"repeat backward bit-equal (six fields): {bit_equal} "
        f"{dict(zip(FIELDS, same))}")
    check(bit_equal, "repeat backward differs")
    del first

    # ---- K2 against the twin backward on 64 sampled tiles, with the loss's
    # own cotangent at the blend
    st = raster_statics(cfg)
    stages, c = frame_stages(splats.prepare(), cam, cfg)
    for _, step in stages:
        step()
    (g_out,) = torch.autograd.grad(gt.rgb_loss(c["image"], target, tc.ssim_lambda),
                                   c["out"][0])
    out = c["out"][0].detach()
    ctx = tr.bwd_context(out, g_out)
    bins = c["bins"]
    abs_err, rel_err = compare_bwd_with_twin(bins, st, ctx,
                                             tiles=sample_tiles(bins, st, dev, seed))
    log(f"64 sampled tiles: K2_vs_twin_max_abs={abs_err:.3e} "
        f"max_rel_to_row_max={rel_err:.3e}")
    check(rel_err <= BWD_RTOL, f"1080p tiles K2 vs twin {rel_err} > {BWD_RTOL}")

    # ---- timings (CUDA events, medians after warm-up)
    attrs = bins.attrs.detach()
    t_k2 = median(time_ms(lambda: tr.rasterize_tiles_bwd(
        attrs, bins.tile_start, bins.tile_count, ctx, st), 10))
    t_twin = median(time_ms(lambda: tr.rasterize_tiles_bwd_ref(
        attrs, bins.tile_start, bins.tile_count, ctx, st), 2, warmup=1))
    log(f"timing rasterize_bwd 1080p/1M ({card}): kernel_ms={t_k2:.4f} "
        f"plain_twin_ms={t_twin:.4f}")
    del stages, c, bins, attrs, ctx, out, g_out
    t_fb = median(time_ms(fwd_bwd, 10))
    t_step = median(time_ms(lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc), 10))
    log(f"timing training 1080p/1M slots ({card}): fwd_bwd_ms={t_fb:.4f} "
        f"train_step_ms={t_step:.4f}")

    profile_calls("train_step", lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc),
                  card)
    return dict(launches=launches[1], max_abs_err=abs_err, ms=t_k2, plain_ms=t_twin)


# ---- the bucket path (RasterConfig.method="bucket"): K3 and K4 ----------

def bucket_cfg(cfg, caps):
    return cfg.replace(raster=dataclasses.replace(cfg.raster, method="bucket",
                                                  bucket_caps=tuple(caps)))


def twin_tiles(st, dev, tiles=None):
    if tiles is None:
        tiles = torch.arange(st.tiles_x * st.tiles_y, device=dev)
    return [tiles[a:a + TWIN_BATCH] for a in range(0, tiles.shape[0], TWIN_BATCH)]


@torch.no_grad()
def bucket_twin(bins, st, caps, tiles=None):
    """K3's twin over ``tiles`` (all by default) in batches of TWIN_BATCH."""
    parts = [rb.rasterize_buckets_ref(bins.attrs.detach(), bins.ids, bins.bucket_starts, st,
                                      caps, tiles=t)
             for t in twin_tiles(st, bins.attrs.device, tiles)]
    return torch.cat([o for o, _ in parts]), torch.cat([i for _, i in parts])


@torch.no_grad()
def bucket_twin_bwd(bins, st, caps, ctx, tiles=None):
    """K4's twin over ``tiles`` (all by default) in batches of TWIN_BATCH."""
    return sum(rb.rasterize_buckets_bwd_ref(bins.attrs.detach(), bins.bucket_starts, ctx, st,
                                            caps, tiles=t)
               for t in twin_tiles(st, bins.attrs.device, tiles))


@torch.no_grad()
def bucket_work(bins, st, caps):
    """ops/raster_bucket.bucket_work over the whole frame, in batches."""
    parts = [rb.bucket_work(bins.attrs.detach(), bins.bucket_starts, st, caps, tiles=t)
             for t in twin_tiles(st, bins.attrs.device)]
    return rb.BucketWork(*(sum(p[i] for p in parts) for i in range(len(rb.BucketWork._fields))))


def compare_k3_with_twin(bins, st, caps, tiles=None):
    """(max abs err on rgb+T, id agreement) of K3 against its twin."""
    out_k, id_k = rb.rasterize_buckets(bins, st, caps)
    out_r, id_r = bucket_twin(bins, st, caps, tiles)
    if tiles is not None:
        out_k, id_k = out_k[tiles], id_k[tiles]
    torch.cuda.synchronize()
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item() if out_k.numel() else 0.0
    same = id_k == id_r
    check(torch.equal(out_k[:, 4][same], out_r[:, 4][same]),
          "K3 and its twin picked the same splat at different depths")
    return err, same.float().mean().item()


def compare_k4_with_twin(bins, st, caps, ctx, tiles=None):
    """K4 against its twin on the columns the tiles of ``tiles`` read (all by
    default). Shared columns collect gradients from every tile that reads
    them, so the context is zeroed outside ``tiles``: K4 then sums those
    tiles' gradients alone, as the twin does."""
    if tiles is not None:
        keep = torch.zeros(ctx.shape[0], dtype=torch.bool, device=ctx.device)
        keep[tiles] = True
        ctx = ctx * keep[:, None, None]
    d_k = rb.rasterize_buckets_bwd(bins.attrs.detach(), bins.bucket_starts, ctx, st, caps)

    def twin(c):
        return bucket_twin_bwd(bins, st, caps, c, tiles)

    cols = ((d_k != 0) | (twin(ctx) != 0)).any(dim=0)
    return gate_bwd_against_twin("K4", d_k, twin, ctx, cols)


def sample_bucket_tiles(bins, st, dev, seed):
    """48 tiles with candidates and 16 random ones, from a seeded generator,
    without repeats."""
    spec = BucketGridSpec.build(st.tiles_x, st.tiles_y)
    g = torch.Generator(device=dev).manual_seed(seed)
    busy = torch.nonzero(span_lengths(bins.bucket_starts, spec).sum(dim=1) > 0).flatten()
    pick = torch.cat([busy[torch.randperm(busy.numel(), generator=g, device=dev)[:48]],
                      torch.randperm(st.tiles_x * st.tiles_y, generator=g, device=dev)[:16]])
    return torch.unique(pick)


def fitted_caps(prepared, cams, cfg, margin=1.25):
    """(caps, required): the per-class requirement measured over ``cams``
    from the EWA projection (bench.py:164-183; 3DGUT is not ported, so its
    projection is not measured), fitted with ``margin``."""
    spec = BucketGridSpec.build(-(-cfg.width // 16), -(-cfg.height // 16))
    req = torch.stack([measure_required_caps(project_splats(prepared, c, cfg), spec)
                       for c in cams]).amax(dim=0)
    req = [int(x) for x in req.tolist()]
    return fit_caps(req, margin=margin), req


def golden_bucket(dev):
    """The golden gate on the bucket path (tests/test_golden.py:67-90)."""
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                     device=dev)
    prepared = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev).prepare()
    caps, req = fitted_caps(prepared, [cam], cfg)
    bcfg = bucket_cfg(cfg, caps)
    out = render(prepared, cam, bcfg)
    pair = render(prepared, cam, cfg)
    ref = torch.from_numpy(np.load(os.path.join(GOLDEN, "golden_view0.npy"))
                           .astype(np.float32)).to(dev)
    mse = torch.mean((out.image.clamp(0, 1) - ref) ** 2).item()
    psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
    vs_pair = (out.image - pair.image).abs().max().item()
    err, agree = compare_k3_with_twin(bins_of(prepared, cam, bcfg), bucket_statics(bcfg), caps)
    log(f"golden bucket: {w}x{h} required_caps={req} caps={list(caps)} "
        f"overflow={bool(out.overflow)} psnr_db={psnr:.3f} max_abs_vs_pair_frame={vs_pair:.3e} "
        f"K3_vs_twin_max_abs={err:.3e} id_agree={agree:.6f}")
    check(psnr > 45.0, f"golden bucket PSNR {psnr} <= 45 dB")
    check(not bool(out.overflow), "golden bucket frame overflowed at fitted caps")
    check(vs_pair <= 1e-4, f"golden bucket vs pair frame {vs_pair} > 1e-4")
    check(err <= KERNEL_ATOL, f"golden K3 vs twin {err} > {KERNEL_ATOL}")
    check(agree >= ID_AGREE, f"golden K3 id agreement {agree}")
    return err


def golden_bucket_gradients(dev):
    """The golden scene at 128x96, SH 0, on the bucket path: K4 against its
    twin over the whole frame for the cotangent of sum(image^2), and a
    central difference of 4 high-gradient opacities through ``render``."""
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev)
    caps, _ = fitted_caps(splats.prepare(), [cam], cfg)
    bcfg = bucket_cfg(cfg, caps)
    st = bucket_statics(bcfg)
    bins = bins_of(splats.prepare(), cam, bcfg)
    out, out_id = rb.rasterize_buckets(bins, st, caps)
    out = out.detach().requires_grad_()
    image = tr.assemble_image(out, out_id, st.tiles_x, st.tiles_y, cfg.width, cfg.height,
                              cfg.background)[0]
    (g_out,) = torch.autograd.grad((image ** 2).sum(), out)
    abs_err, rel_err = compare_k4_with_twin(bins, st, caps, tr.bwd_context(out.detach(), g_out))

    def loss(op):
        s = dataclasses.replace(splats, opacities=op)
        return torch.sum(render(s.prepare(), cam, bcfg).image.double() ** 2)

    op0 = splats.opacities.clone().requires_grad_()
    loss(op0).backward()
    g = op0.grad
    big = torch.nonzero(g.abs() > torch.quantile(g.abs(), 0.99)).flatten()
    idx = big[torch.randperm(big.numel(), generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev)[:4]]
    eps, worst = 1e-2, 0.0
    with torch.no_grad():
        for i in idx.tolist():
            op = splats.opacities.clone()
            op[i] += eps
            lp = loss(op).item()
            op[i] -= 2 * eps
            lm = loss(op).item()
            fd, gi = (lp - lm) / (2 * eps), g[i].item()
            worst = max(worst, abs(fd - gi) / max(abs(fd), abs(gi), 1.0))
    log(f"golden bucket gradients: 128x96 caps={list(caps)} K4_vs_twin_max_abs={abs_err:.3e} "
        f"max_rel_to_row_max={rel_err:.3e} central_difference_worst_rel={worst:.3e}")
    check(worst < 2e-2, f"golden bucket central difference off by {worst}")
    return abs_err


def bucket_full_size(dev, card: str, prepared, seed: int):
    """The bucket frame at 1080p with 1M splats; returns (caps, K3's report
    entry, both bucket kernels' bounds)."""
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    caps, req = fitted_caps(prepared, [jitter(cam, i) for i in range(FRAMES)], cfg)
    bcfg = bucket_cfg(cfg, caps)
    bumped = any(bool(render(prepared, jitter(cam, i), bcfg).overflow) for i in range(FRAMES))
    if bumped:  # bench.py:225-235: double once, never quietly truncate
        caps = tuple(2 * c for c in caps)
        bcfg = bucket_cfg(cfg, caps)
    log(f"bucket caps 1080p/1M (EWA projection only; 3DGUT not ported): required={req} "
        f"fitted={list(caps)} caps_bumped={bumped}")
    torch.cuda.synchronize()

    # ---- the main path: FRAMES frames through render(), K3's launches counted
    rb.rasterize_buckets.launches = 0
    outs = [render(prepared, jitter(cam, i), bcfg) for i in range(FRAMES)]
    torch.cuda.synchronize()
    launches = rb.rasterize_buckets.launches
    log(f"bucket main path: {FRAMES} frames, raster_bucket_fwd launches={launches}")
    check(launches == FRAMES, f"{launches} K3 launches for {FRAMES} frames")
    for o in outs:
        check(tuple(o.image.shape) == (cfg.height, cfg.width, 3), "bucket image shape")
        check(bool(torch.isfinite(o.image).all()), "non-finite bucket image")
        check(not bool(o.overflow), "a bucket frame overflowed at the derived caps")
    o0 = outs[0]
    del outs
    again = render(prepared, jitter(cam, 0), bcfg)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(getattr(again, f), getattr(o0, f))
                    for f in ("image", "transmittance", "depth", "splat_id"))
    log(f"bucket frame: num_pairs={int(o0.num_pairs)} repeat bit-equal: {bit_equal}")
    check(bit_equal, "repeat bucket render differs")
    exact = render(prepared, jitter(cam, 0), cfg.replace(
        raster=gt.RasterConfig(expansion="exact")), max_pairs=1 << 22)
    diff = (o0.image - exact.image).abs().amax(dim=-1)
    share = (diff <= BUCKET_VS_PAIR_ATOL).float().mean().item()
    log(f"bucket vs exact pair frame: share of pixels within {BUCKET_VS_PAIR_ATOL:g} "
        f"{share:.6f} (gate {BUCKET_VS_PAIR_SHARE}), max abs {diff.max().item():.4e}")
    check(share >= BUCKET_VS_PAIR_SHARE, f"bucket vs pair share {share}")
    del again, exact, diff

    # ---- K3 against its twin on 64 sampled tiles
    st = bucket_statics(bcfg)
    bins = bins_of(prepared, cam, bcfg)
    tiles = sample_bucket_tiles(bins, st, dev, seed)
    err, agree = compare_k3_with_twin(bins, st, caps, tiles=tiles)
    log(f"bucket {tiles.numel()} sampled tiles: K3_vs_twin_max_abs={err:.3e} "
        f"id_agree={agree:.6f}")
    check(err <= KERNEL_ATOL, f"1080p tiles K3 vs twin {err} > {KERNEL_ATOL}")
    check(agree >= ID_AGREE, f"1080p tiles K3 id agreement {agree}")

    # ---- the bound of both bucket kernels at this frame's shape and data
    work = bucket_work(bins, st, caps)
    n_tiles, p = st.tiles_x * st.tiles_y, bins.attrs.shape[1]
    head_bytes = n_tiles * (12 * 4 + 12 * 4)  # span buckets and their starts
    bytes_fwd = work.live * (10 * 4 + 4) + head_bytes + n_tiles * tr.PIX * (tr.OUT_ROWS * 4 + 4)
    bytes_bwd = (work.live * tr.GRAD_ROWS * 4 + head_bytes + n_tiles * tr.PIX * tr.CTX_ROWS * 4
                 + p * tr.GRAD_ROWS * 4)
    bounds = {
        "raster_bucket_fwd": kernel_bound("raster_bucket_fwd", work.evals, work.hits,
                                          bytes_fwd, work.comparisons),
        "raster_bucket_bwd": kernel_bound("raster_bucket_bwd", work.evals, work.hits,
                                          bytes_bwd, work.comparisons
                                          + work.shared * tr.GRAD_ROWS)}
    log(f"bound 1080p/1M bucket: live_candidates={work.live} shared={work.shared} "
        f"per_tile={work.live / n_tiles:.1f} pixel_lane_evaluations={work.evals} "
        f"hits={work.hits} hit_share={work.hits / max(work.evals, 1):.4f} "
        f"merge_comparisons={work.comparisons} "
        + " ".join(f"{k}_bound_ms={v[0]:.4f} ({v[1]})" for k, v in bounds.items())
        + f" (rows read once per slot, not per tile: "
        f"{int(bins.num_valid) * 44 / PEAK_BYTES * 1e3:.4f} ms)")
    del bins

    # ---- timings (CUDA events; medians over 10 after 2 warm-up), stages in order
    stages, c = frame_stages(prepared, cam, bcfg)
    t = {stage: median(time_ms(step, 10)) for stage, step in stages}
    t_frame = median(time_ms(lambda: render(prepared, cam, bcfg), 10))
    log(f"timing 1080p/1M bucket ({card}): project_ms={t['project']:.4f} "
        f"bin_ms={t['bin']:.4f} blend_ms={t['blend']:.4f} assemble_ms={t['assemble']:.4f} "
        f"frame_ms={t_frame:.4f}")
    bins = c["bins"]
    t_plain = median(time_ms(lambda: bucket_twin(bins, st, caps), 2, warmup=1))
    log(f"timing raster_bucket_fwd 1080p/1M ({card}): kernel_ms={t['blend']:.4f} "
        f"plain_twin_ms={t_plain:.4f}")
    del bins, c
    profile_calls("bucket", lambda: render(prepared, cam, bcfg), card)
    return caps, dict(launches=launches, max_abs_err=err, ms=t["blend"], plain_ms=t_plain), bounds


def bucket_train_full_size(dev, card: str, truth: gt.SplatSet, caps, seed: int):
    """The training path on the bucket path at 1080p with 1M splats, at the
    caps of the forward phase: the scene renders its own target; training
    starts from the forward phase's seeded jitter."""
    cfg = bucket_cfg(gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3), caps)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    tc = gt.TrainConfig(scene_extent=4.0)
    with torch.no_grad():
        target = render(truth.prepare(), cam, cfg).image
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    fields = {f: getattr(truth, f).detach().clone() for f in FIELDS}
    fields["means"] += 1e-3 * torch.randn(fields["means"].shape, generator=g, device=dev)
    fields["sh_dc"] += 0.3 * torch.randn(fields["sh_dc"].shape, generator=g, device=dev)
    splats = gt.SplatSet(**fields)
    opt = gt.make_optimizer(splats, tc)
    torch.cuda.synchronize()

    # ---- the training path: TRAIN_STEPS steps, K3's and K4's launches counted
    rb.rasterize_buckets.launches = rb.rasterize_buckets_bwd.launches = 0
    steps = [gt.train_step(splats, opt, cam, target, cfg, 0, tc) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = (rb.rasterize_buckets.launches, rb.rasterize_buckets_bwd.launches)
    losses = [loss.item() for loss, _ in steps]
    log(f"bucket training path: {TRAIN_STEPS} steps, raster_bucket_fwd launches={launches[0]} "
        f"raster_bucket_bwd launches={launches[1]}")
    log(f"bucket train losses: {' '.join(f'{x:.6f}' for x in losses)} overflow="
        f"{[bool(o) for _, o in steps]}")
    check(launches == (TRAIN_STEPS, TRAIN_STEPS),
          f"{launches} bucket kernel launches for {TRAIN_STEPS} train steps")
    check(all(math.isfinite(x) for x in losses), "non-finite bucket training loss")
    check(losses[-1] < losses[0], f"the bucket loss did not fall: {losses}")
    check(all(bool(torch.isfinite(x).all()) for x in grads_of(splats)),
          "non-finite gradient in the last bucket train step")

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        out = render(splats.prepare(), cam, cfg)
        gt.rgb_loss(out.image, target, tc.ssim_lambda).backward()

    # ---- a repeat backward is bit-equal (no step between)
    fwd_bwd()
    first = [x.clone() for x in grads_of(splats)]
    fwd_bwd()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(first, grads_of(splats))]
    log(f"bucket repeat backward bit-equal (six fields): {all(same)} "
        f"{dict(zip(FIELDS, same))}")
    check(all(same), "repeat bucket backward differs")
    del first

    # ---- K4 against its twin on 64 sampled tiles, with the loss's own
    # cotangent at the blend
    st = bucket_statics(cfg)
    stages, c = frame_stages(splats.prepare(), cam, cfg)
    for _, step in stages:
        step()
    (g_out,) = torch.autograd.grad(gt.rgb_loss(c["image"], target, tc.ssim_lambda),
                                   c["out"][0])
    ctx = tr.bwd_context(c["out"][0].detach(), g_out)
    bins = c["bins"]
    abs_err, rel_err = compare_k4_with_twin(bins, st, caps, ctx,
                                            tiles=sample_bucket_tiles(bins, st, dev, seed))
    log(f"bucket 64 sampled tiles: K4_vs_twin_max_abs={abs_err:.3e} "
        f"max_rel_to_row_max={rel_err:.3e}")

    # ---- timings (CUDA events, medians after warm-up)
    attrs = bins.attrs.detach()
    t_k4 = median(time_ms(lambda: rb.rasterize_buckets_bwd(
        attrs, bins.bucket_starts, ctx, st, caps), 10))
    t_twin = median(time_ms(lambda: bucket_twin_bwd(bins, st, caps, ctx), 1, warmup=1))
    log(f"timing raster_bucket_bwd 1080p/1M ({card}): kernel_ms={t_k4:.4f} "
        f"plain_twin_ms={t_twin:.4f}")
    del stages, c, bins, attrs, ctx, g_out
    t_fb = median(time_ms(fwd_bwd, 10))
    t_step = median(time_ms(lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc), 10))
    log(f"timing training 1080p/1M bucket ({card}): fwd_bwd_ms={t_fb:.4f} "
        f"train_step_ms={t_step:.4f}")
    profile_calls("bucket train_step",
                  lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc), card)
    return dict(launches=launches[1], max_abs_err=abs_err, ms=t_k4, plain_ms=t_twin)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    was_built = {name: _build.library_path(name).exists() for name in KERNELS}
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_build.load, KERNELS))  # one nvcc per source, all at once
    for name in KERNELS:
        log(f"{'loaded prebuilt' if was_built[name] else 'built'} "
            f"{_build.library_path(name).name}")
        log_file = str(_build.library_path(name)) + ".log"
        if os.path.exists(log_file):
            log(open(log_file).read().strip())
    log(f"kernels ready in {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    card = gpu_name_and_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"card: {card}")
    t_span = time.perf_counter()
    for _ in range(10000):
        with torch.profiler.record_function("project"):
            pass
    log(f"host cost of one stage span, profiler off: "
        f"{(time.perf_counter() - t_span) * 1e2:.3f} us")

    err_golden = golden_gate(dev)
    err_golden_bwd = golden_gradients(dev)
    truth = bench_scene(dev, SPLATS, seed=0)
    fwd, bounds = full_size(dev, card, truth.prepare(), seed=0)
    fwd["max_abs_err"] = max(fwd["max_abs_err"], err_golden)
    bwd = train_full_size(dev, card, truth, seed=0)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], err_golden_bwd)

    err_golden_k3 = golden_bucket(dev)
    err_golden_k4 = golden_bucket_gradients(dev)
    caps, k3, bucket_bounds = bucket_full_size(dev, card, truth.prepare(), seed=0)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_golden_k3)
    k4 = bucket_train_full_size(dev, card, truth, caps, seed=0)
    k4["max_abs_err"] = max(k4["max_abs_err"], err_golden_k4)
    bounds.update(bucket_bounds)

    report = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][0],
        "replaces": KERNELS[name][1], **res,
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": None,  # no single PyTorch call computes a tile blend
    } for name, res in (("rasterize_fwd", fwd), ("rasterize_bwd", bwd),
                        ("raster_bucket_fwd", k3), ("raster_bucket_bwd", k4))]}
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
