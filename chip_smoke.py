"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths — the 3DGS raster frame, ``render(prepared,
camera, cfg)``, and the training step, ``train_step`` (render, loss,
backward, Adam), each by the pair path (the default RenderConfig) and by
the bucket path (``RasterConfig(method="bucket")``); then the 3DGUT and
3DGRT raster frames (``Pipeline.MESH_3DGUT``, ``Pipeline.RTX``) and 3DGUT
training on both paths; and the design probes P1-P3 through their own
entry points — and checks them:

1. builds the CUDA kernels from the checkout, one nvcc per source, all at
   once: the pair blender K1 (csrc/rasterize_fwd.cu) and its backward K2
   (csrc/rasterize_bwd.cu), the bucket rasterizer K3
   (csrc/raster_bucket_fwd.cu) and its backward K4
   (csrc/raster_bucket_bwd.cu), each source holding the gs2d and the gut3d
   form of its kernel (csrc/response.cuh), and the probe kernels P1
   (csrc/bench_roll.cu), P3 (csrc/bench_sort_stage.cu, three variants)
   and P2 (csrc/bench_radix_ab.cu); prints their -Xptxas -v reports and
   the card's name and power limit;
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
   overflow; a bit-equal repeat frame; K1 against the twin over every tile;
   K1's per-warp cull on that frame: its kept (warp, pair) counter equal to
   the plain count (``ops/rasterize.pair_warp_may_hit`` over the steps each
   tile enters), the kept share, and an audit of every tile for culled
   (warp, pair)s that hit some pixel of the warp (``pair_hits(per_warp=
   True)``; none allowed); K1's bound counts the kept evaluations and the
   cull (``warp_cull_bound``, the all-pair figure beside it);
4. training at full size: the same scene is the target, the start has
   seeded jitter on means and sh_dc; 5 ``train_step``s with both kernels'
   launch counts read around them, a falling finite loss and finite
   gradients; one exact-expansion step; a bit-equal repeat backward; K2
   against the twin backward over every tile of the training frame, in
   tile batches; K2's per-tile cull of the pair lists on that frame: its
   kept-pair counter against the plain predicate's count
   (``ops/rasterize.pair_may_hit`` over the steps each tile enters,
   exactly), the kept share, and an audit of every tile
   for culled pairs that hit (``pair_hits``; none allowed); K2's bound
   counts the kept pairs and the cull (``pair_bound``, the all-pair figure
   beside it);
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
   the 8 jittered frames with margin 1.25 from the EWA and the UT
   projections (bench.py:164-183; doubled once if a frame still
   overflows), 8 frames with K3's launches counted, a bit-equal repeat,
   64 sampled tiles and every tile against the twin, the share of pixels
   within 2e-4 of the exact pair frame; 5 train steps with K3's and K4's
   launches counted, K4 against its twin on 64 sampled tiles, a bit-equal
   repeat backward; timings and profiles as above. The per-tile cull of K3
   and K4, on the headline frame: each kernel's kept-lane counter against
   the plain predicate's count (``ops/raster_bucket.tile_may_hit``,
   exactly) and the two equal, the kept share, and an audit
   of all its tiles for culled lanes that hit (none allowed); K3's and K4's
   bounds count the kept lanes (``bucket_bound``, the all-lane figures
   beside them); K4's three launches timed apart by the profiler;
8. the gut3d forms K1g-K4g (3DGUT, 3DGRT): golden-size 3DGUT frames on
   both paths, K1g and K3g against their twins over the frame, bucket
   against pair, the card against the CPU twin (flip-aware, with the
   flipped pair-pixels counted); golden gradients, K2g and K4g against
   their twins over the frame and a central difference of 4 opacities on
   each path; one golden-size frame with fisheye, rolling shutter and DoF
   at temporal_samples=4; at full size, 8 frames of 3DGUT and of 3DGRT on
   each path with the gut3d launches counted, overflow reported, a
   bit-equal repeat, frame_ms, K1g against its twin over every tile of the
   3DGUT and 3DGRT pair frames with its per-warp cull checked as K1's, K3g
   on 64 sampled tiles and on every tile, K3g's and K4g's cull checked on
   the 3DGUT bucket frame as K3's and K4's; 3DGUT
   training on each path (5 steps, launches counted, loss falling,
   bit-equal repeat backward, K2g against its twin over every tile and
   K4g on 64 sampled tiles, K2g's kept counter (it culls no pair: equal
   to the tested pairs), fwd_bwd_ms, train_step_ms,
   K4g's three launches);
   profiles of a 3DGUT and a 3DGRT pair frame and a 3DGUT train step by
   stage (each frame's kernel-busy time). The gut3d gates are
   flip-aware (``GUT_*``);
9. the probes (vk_gaussian_splatting_tpu_torch/probes): each probe's entry
   point at its script's default arguments (``bench_roll.run``,
   ``bench_sort_stage.run`` per variant, ``bench_radix_ab.run``: their
   lines are printed), with every probe's launch count zeroed before and
   read after; then each probe kernel against its twin, bit for bit (they
   only compare, select and copy; NaN keys compared by their bits): P1 at
   a small size (also with ties, signed zeros and NaN keys), at one 16 x
   2048 tile sorted 200 times and at 8160 tiles; each P3 variant at two
   small sizes (a cut and a repeated schedule; ties, signed zeros and NaN
   keys; a mask table that duplicates columns) and at the default (4096
   blocks); P2's output at every W for one block and for 256, and every
   copied block of 4-step check runs (one block, two) against the twin's;
   each timed with CUDA events beside its twin, a library yardstick
   (torch.sort + take_along_dim of the key rows, or index_select of the
   same blocks), the key network alone (P1 and P3 at 2 rows) and its bound
   (``probe_bound``: the (key, index) network and one permutation, the
   bound of the row-moving form logged beside it, and the share of the
   bound; P2's ``copy_bound``: its offsets reach 8 MB of the source, and
   every copy lands in shared memory).

Without a CUDA device it raises and prints no result. The last line is
``{"ok": true, "device": {...}}``; the line before it holds the kernel
report as JSON, and the line before that the card's name and power limit.
Every number printed was measured in this run; each kernel's bound is
computed from this run's inputs (``kernel_bound``, ``roofline``,
``copy_bound``).
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
from vk_gaussian_splatting_tpu_torch.ops.projection import (  # noqa: E402
    project_splats,
    ut_project_splats,
)
from vk_gaussian_splatting_tpu_torch.ops.response import MODELS, model_of  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_radix_ab as probe_radix  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_roll as probe_roll  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_sort_stage as probe_stage  # noqa: E402
from vk_gaussian_splatting_tpu_torch.timing import call_ms, device_label  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import render  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    bin_for_cfg,
    blend_bins,
    bucket_statics,
    gs_attr_rows,
    gut_bin,
    raster_statics,
)
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays  # noqa: E402
from vk_gaussian_splatting_tpu_torch.scene.splat_set import random_splats  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FIELDS = ("means", "scales", "quats", "opacities", "sh_dc", "sh_rest")
GOLDEN = os.path.join(HERE, "assets", "golden")
_SOURCES = {  # library: (source, the TPU kernel it replaces)
    "rasterize_fwd": ("vk_gaussian_splatting_tpu_torch/csrc/rasterize_fwd.cu",
                      "vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:202"),
    "rasterize_bwd": ("vk_gaussian_splatting_tpu_torch/csrc/rasterize_bwd.cu",
                      "vk_gaussian_splatting_tpu/ops/rasterize_pallas.py:367"),
    "raster_bucket_fwd": ("vk_gaussian_splatting_tpu_torch/csrc/raster_bucket_fwd.cu",
                          "vk_gaussian_splatting_tpu/ops/raster_bucket.py:469"),
    "raster_bucket_bwd": ("vk_gaussian_splatting_tpu_torch/csrc/raster_bucket_bwd.cu",
                          "vk_gaussian_splatting_tpu/ops/raster_bucket.py:927"),
    "bench_roll": ("vk_gaussian_splatting_tpu_torch/csrc/bench_roll.cu",
                   "scripts/bench_roll.py:32"),
    "bench_sort_stage": ("vk_gaussian_splatting_tpu_torch/csrc/bench_sort_stage.cu",
                         "scripts/bench_sort_stage.py:115"),
    "bench_radix_ab": ("vk_gaussian_splatting_tpu_torch/csrc/bench_radix_ab.cu",
                       "scripts/bench_radix_ab.py:89"),
}


def stage_name(variant: str) -> str:
    """The report name of one variant of the sort-stage probe P3."""
    return "bench_sort_stage_" + variant.replace("-", "_")


RASTER = ("rasterize_fwd", "rasterize_bwd", "raster_bucket_fwd", "raster_bucket_bwd")
# report name: (library, source, the TPU kernel it replaces); the gut3d form
# of each raster kernel is another entry point of the same source, and so
# is each variant of the sort-stage probe
KERNELS = {name + suffix: (name, *_SOURCES[name])
           for suffix in ("", "_gut3d") for name in RASTER}
KERNELS.update({"bench_roll": ("bench_roll", *_SOURCES["bench_roll"])})
KERNELS.update({stage_name(v): ("bench_sort_stage", *_SOURCES["bench_sort_stage"])
                for v in probe_stage.VARIANTS})
KERNELS.update({"bench_radix_ab": ("bench_radix_ab", *_SOURCES["bench_radix_ab"])})
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
# The bound: f32 operations, each add, multiply, compare, select, exp,
# sqrt and rsqrt counted as one, as the kernels' sources spell them
# (csrc/response.cuh). Every (pixel, pair) evaluation costs the alpha test:
# gs2d 17 (offsets 2, quadratic form 9, scale, exp, opacity, 2 cutoffs,
# clamp), gut3d 68 (o - p 3, R^T (o - p) and R^T d 30, the two scalings 6,
# the norm 6, rsqrt, normalising 3, the cross product 9, its square 5,
# the degree-2 response 2, opacity, 2 cutoffs). A hit, an evaluation whose
# alpha passes the cutoffs, adds the blend in K1 (10: weight, 3 colour
# multiply-adds, T update, depth pick) and in K2 the blend's backward and
# the model's VJP plus one add per gradient row to reduce it over the
# tile: gs2d 44 + 9 = 53; gut3d 20 (dalpha, colours, T) + 176 (the VJP:
# cross products 18, normalisation 37, R and the scales 45, position 18,
# quaternion 58) + 14 = 210 (``ops/rasterize.blend_work`` counts
# evaluations and hits). The bucket kernels K3 and K4 do the same per
# evaluation and hit, over each tile's merged window
# (``ops/raster_bucket.bucket_work``), plus one operation per key
# comparison of the merge and, in K4, one add per (row, tile, shared lane)
# of the reduce over the reading tiles. K3 and K4 evaluate only the lanes
# their cull keeps (``bucket_bound``), and the cull (csrc/response.cuh
# may_hit) costs f64 operations, as its source spells them without the
# conversions: per
# tested (tile, lane) gs2d 45 (finiteness 7, the conic's tests 5, the
# rounding term 7, the opacity test 1, tau 5, the two radii 12, the box 8),
# gut3d 96 (|q|^2 7, finiteness 19, the thresholds 5, the scales 12, the
# distances to the cone 41, the cut distance 5, the radius 6, the test 1);
# and per pixel of a tile gut3d's TileBound, 67 (|d|^2 5, finiteness 7, the
# warp sums 30, rho 8, cos theta 7, the warp max and min 10).
# K1 and K1g split the cull: per tested pair the pair's part (reach: gs2d
# 37, the box's 8 less; gut3d 52: |q|^2 7, finiteness 19, the thresholds
# 5, the scales 12, kappa 3, the cut distance with its margin 6), per
# tested (warp, pair) the test against the warp's bound (reach_hits: gs2d
# the box 8; gut3d 45: the bound's validity 1, the distances to the cone
# 31, the radius with its rounding term 7, the nearest distance 5, the
# test 1); and per pixel gut3d's warp bound, 79 (the tile bound's 67, and
# the centre and axis, which every lane computes, 12).
OPS_ALPHA = {"gs2d": 17, "gut3d": 68}
OPS_CULL, OPS_TILE_BOUND = {"gs2d": 45, "gut3d": 96}, {"gs2d": 0, "gut3d": 67}
OPS_REACH, OPS_WARP_TEST = {"gs2d": 37, "gut3d": 52}, {"gs2d": 8, "gut3d": 45}
OPS_WARP_BOUND = {"gs2d": 0, "gut3d": 79}
OPS_PER_HIT = {"rasterize_fwd": 10, "rasterize_bwd": 53,
               "raster_bucket_fwd": 10, "raster_bucket_bwd": 53,
               "rasterize_fwd_gut3d": 10, "rasterize_bwd_gut3d": 210,
               "raster_bucket_fwd_gut3d": 10, "raster_bucket_bwd_gut3d": 210}
# the bucket frame against the exact pair frame: they freeze pixels at
# different lanes (bucket_chunk 384 against chunk 128) and may order exactly
# equal depths apart, so a share of pixels, not the max
BUCKET_VS_PAIR_ATOL, BUCKET_VS_PAIR_SHARE = 2e-4, 0.999
TWIN_BATCH = 1024  # tiles per twin call at 1080p: a (1024, 256, 384) f32 step is 0.4 GB
# the stage spans that render_3dgs and train_step open, in step order
STAGES = ("prepare", "project", "bin", "rays", "blend", "assemble", "loss", "backward",
          "optimizer")
PEAK_F32_OPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_F64_OPS = 34e12   # H100 SXM, f64 outside the tensor cores (NVIDIA's data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# shared memory fills at 128 B per clock on each SM (32 banks of 4 B): 132
# SMs at the 1.98 GHz boost clock of the H100 SXM (NVIDIA's specifications)
SM_COUNT, SMEM_BYTES_PER_CLOCK, BOOST_HZ = 132, 128, 1.98e9
# The probes P1 and P3 (phase 9), the least work of the function: per column
# and stage the network's want_min (lane-iota: an and and a compare; from
# the mask table: one compare), its take test (two key compares and a
# select) and the move of the (key, index) pair (two selects); plus one
# permutation, each payload element read and written once (2). The bytes:
# each input read once, each output written once. The count of the
# row-moving form, which moves every row of each column that takes its
# partner at every stage, is logged beside it (PROBE_OPS_ROW_FORM, plus one select per row
# for each take on this data). P2 moves bytes and counts none.
PROBE_OPS_PER_COLUMN = {"lane-iota": 7, "lane-const": 6, "sub8": 6}
PROBE_OPS_PER_ELEMENT = 2
PROBE_OPS_ROW_FORM = {"lane-iota": 5, "lane-const": 4, "sub8": 4}
KEY_NETWORK_ROWS = 2  # the key network alone: the key row and one payload row


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int, warmup: int = 2) -> list[float]:
    """Per-call device milliseconds from CUDA events, after warm-up."""
    return call_ms(fn, torch.device("cuda", 0), iters, warmup)


def median(xs):
    return float(np.median(np.asarray(xs)))


@torch.no_grad()
def compare_kernel_with_twin(bins, st):
    """(max abs err on rgb+T, id agreement) of K1 against the twin over every
    tile, the twin in batches of TWIN_BATCH tiles."""
    out_k, id_k = tr.rasterize_bins(bins, st)
    parts = [tr.rasterize_tiles_ref(bins.attrs.detach(), bins.pair_id, bins.tile_start,
                                    bins.tile_count, st, tiles=t)
             for t in twin_tiles(st, bins.attrs.device)]
    out_r, id_r = torch.cat([o for o, _ in parts]), torch.cat([i for _, i in parts])
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


def bwd_gate(d_k, d_r, rtol=BWD_RTOL):
    """(passes, max abs err, max err / row max, least share over the rows
    of values inside the elementwise limit, each row's 99.9th percentile
    of |err| / (|ref| + row median)) of gradient rows ``d_k`` against
    reference rows ``d_r``; ``rtol`` bounds the max err / row max."""
    diff, mag = (d_k - d_r).abs(), d_r.abs()
    rel = (diff / mag.amax(dim=1, keepdim=True).clamp_min(1e-30)).max().item()
    ratio = diff / (mag + row_typical(mag)).clamp_min(1e-30)
    share = (ratio <= BWD_ELEM_RTOL).float().mean(dim=1).min().item()
    p999 = torch.quantile(ratio, 0.999, dim=1).tolist()
    return rel <= rtol and share >= BWD_ELEM_SHARE, diff.max().item(), rel, share, p999


def gate_bwd_against_twin(label, d_k, twin, ctx, cols, grad_rows=tr.GRAD_ROWS,
                          rtol=BWD_RTOL):
    """(max abs err, max err relative to each row's max) of a backward
    kernel's d_attrs ``d_k`` against ``twin(ctx)`` on the columns ``cols``,
    over its ``grad_rows`` gradient rows. Fails unless ``bwd_gate`` passes
    (at ``rtol``), and unless it rejects the twin on two broken contexts."""
    d_k, d_r = d_k[:, cols], twin(ctx)[:, cols]
    check(bool((d_k[grad_rows:] == 0).all()), f"{label} wrote the depth row")
    d_k, d_r = d_k[:grad_rows], d_r[:grad_rows]
    ok, abs_err, rel_err, share, p999 = bwd_gate(d_k, d_r, rtol)
    typical = row_typical(d_r.abs()) / d_r.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    log(f"  {label} vs twin on {d_r.shape[1]} columns: max err / row max {rel_err:.3e} "
        f"(gate {rtol:g}); least share per row within {BWD_ELEM_RTOL:g} (|ref| + "
        f"row median) {share:.6f} (gate {BWD_ELEM_SHARE}); per row, p99.9 of that ratio: "
        + " ".join(f"{x:.2e}" for x in p999) + "; median nonzero |ref| / row max: "
        + " ".join(f"{x:.2e}" for x in typical.flatten().tolist()))
    check(ok, f"{label} vs twin outside the gates: {rel_err} / {share}")
    warp_out, no_suffix = ctx.clone(), ctx.clone()
    warp_out[:, :, 96:128] = 0.0
    no_suffix[:, 3] = 0.0
    for what, bad in (("one warp's cotangent zeroed", warp_out), ("S_total zeroed", no_suffix)):
        ok, _, bad_rel, bad_share, _ = bwd_gate(twin(bad)[:grad_rows, cols], d_r, rtol)
        log(f"  gate self-check, twin with {what}: max err / row max {bad_rel:.3e}, "
            f"share within {bad_share:.6f}, rejected={not ok}")
        check(not ok, f"the {label} gate passed a twin with {what}")
    return abs_err, rel_err


def compare_bwd_with_twin(bins, st, ctx):
    """K2 against the twin backward over every tile (in batches of
    TWIN_BATCH tiles, each writing its own tiles' pairs): ``gate_bwd_against_twin``."""
    attrs = bins.attrs.detach()

    @torch.no_grad()
    def twin(c):
        return sum(tr.rasterize_tiles_bwd_ref(attrs, bins.tile_start, bins.tile_count, c, st,
                                              tiles=t)
                   for t in twin_tiles(st, ctx.device))

    d_k = tr.rasterize_tiles_bwd(attrs, bins.tile_start, bins.tile_count, ctx, st)
    pairs = torch.arange(int(bins.num_pairs), device=ctx.device)
    return gate_bwd_against_twin("K2", d_k, twin, ctx, pairs)


def check_pair_cull(label: str, bins, st, batches, pix=None):
    """K2's or K2g's kept-pair counter on a whole frame, after a launch of
    it on that frame: (blend_work's (evaluations, hits, tested, kept, kept
    evaluations) over ``batches`` of tiles, the counter). Where the model
    culls its pair lists (``Model.cull_pairs``), ``kept`` counts the pairs
    ``ops/rasterize.pair_may_hit`` keeps over the steps each tile enters and
    the counter must equal it; then, over every tile in ``batches``, the
    pairs the plain predicate culls that the twin's alpha passes at some
    pixel of the tile (``pair_hits``, frozen pixels too): none allowed.
    Where it does not cull, the counter must equal the tested pairs."""
    culls = model_of(st).cull_pairs
    attrs = bins.attrs.detach()
    args = (attrs, bins.tile_start, bins.tile_count, st)
    every = torch.ones(attrs.shape[1], dtype=torch.bool, device=attrs.device)
    work, may, hit, bad = [0] * 5, 0, 0, 0
    for tiles in batches:
        m = tr.pair_may_hit(*args, tiles, pix) if culls else every
        if culls:
            h = tr.pair_hits(*args, tiles, pix)
            may, hit, bad = may + int(m.sum()), hit + int(h.sum()), bad + int((h & ~m).sum())
        work = [a + b for a, b in zip(work, tr.blend_work(*args, tiles, pix, keep=m))]
    torch.cuda.synchronize()
    kept = int(getattr(tr.rasterize_tiles_bwd, tr.KEPT_COUNTER[st.model]))
    log(f"{label} cull 1080p/1M: kept={kept} of tested={work[2]} (kept share "
        f"{kept / work[2]:.4f}; the model culls: {culls}); the plain count over the steps "
        f"each tile enters: {work[3]} (must be equal); kept pairs' pixel evaluations "
        f"{work[4]} of {work[0]}")
    check(kept == work[3], f"{label} kept {kept} pairs, the plain count {work[3]}")
    if culls:
        log(f"  {label} cull audit on all {sum(b.numel() for b in batches)} tiles: {may} "
            f"pairs kept, {hit} hit some pixel, culled pairs that hit: {bad}")
        check(bad == 0, f"{label}: the cull dropped {bad} pairs that hit")
    return work, kept


def check_warp_cull(label: str, bins, st, batches, pix=None):
    """K1's or K1g's kept (warp, pair) counter on a whole frame, after a
    launch of it on that frame: (blend_work's (evaluations, hits, tested,
    kept, kept evaluations) over ``batches`` of tiles with the plain per-warp
    predicate ``ops/rasterize.pair_warp_may_hit``, the counter). The counter
    must equal the plain count of kept (warp, pair) bits over the steps each
    tile enters; and over every tile in ``batches``, the (warp, pair)s the
    plain predicate culls that the twin's alpha passes at some pixel of the
    warp (``pair_hits(per_warp=True)``, frozen pixels too): none allowed."""
    attrs = bins.attrs.detach()
    args = (attrs, bins.tile_start, bins.tile_count, st)
    work, may, hit, bad = [0] * 5, 0, 0, 0
    for tiles in batches:
        m = tr.pair_warp_may_hit(*args, tiles, pix)
        h = tr.pair_hits(*args, tiles, pix, per_warp=True)
        may, hit, bad = may + int(m.sum()), hit + int(h.sum()), bad + int((h & ~m).sum())
        work = [a + b for a, b in zip(work, tr.blend_work(*args, tiles, pix, keep=m))]
    torch.cuda.synchronize()
    kept = int(getattr(tr.rasterize_tiles, tr.KEPT_COUNTER[st.model]))
    log(f"{label} per-warp cull 1080p/1M: kept (warp, pair)s={kept} of tested pairs "
        f"{work[2]} x {tr.WARPS} warps (kept share {kept / (tr.WARPS * work[2]):.4f}); the "
        f"plain count over the steps each tile enters: {work[3]} (must be equal); kept "
        f"evaluations {work[4]} of {work[0]} ({work[4] / work[0]:.4f}), hits {work[1]}")
    check(kept == work[3], f"{label} kept {kept} (warp, pair)s, the plain count {work[3]}")
    log(f"  {label} per-warp cull audit on all {sum(b.numel() for b in batches)} tiles: {may} "
        f"(warp, pair)s kept, {hit} hit some pixel of the warp, culled ones that hit: {bad}")
    check(bad == 0, f"{label}: the cull dropped {bad} (warp, pair)s that hit")
    return work, kept


def warp_cull_bound(name: str, work, bytes_moved: int, n_tiles: int):
    """((ms, what bounds it) of K1 or K1g at one frame, a log fragment with
    it and the all-pair figure). The kernel evaluates the (pixel, pair)s of
    the (warp, pair)s it keeps (``work[4]``) and blends the hits; its cull
    costs f64 operations per tested pair (OPS_REACH), per tested (warp,
    pair) (OPS_WARP_TEST) and, for gut3d, per pixel (OPS_WARP_BOUND). The
    all-pair figure prices every live (pixel, pair), as the sweep before the
    cull made them."""
    evals, hits, tested, _, kept_evals = work
    model = "gut3d" if name.endswith("_gut3d") else "gs2d"
    all_pairs = kernel_bound(name, evals, hits, bytes_moved)
    cull = (tested * (OPS_REACH[model] + tr.WARPS * OPS_WARP_TEST[model])
            + n_tiles * tr.PIX * OPS_WARP_BOUND[model])
    bound = kernel_bound(name, kept_evals, hits, bytes_moved, f64_ops=cull)
    return bound, (f"{name}_bound_ms={bound[0]:.4f} ({bound[1]}; the kept (warp, pair)s) "
                   f"{name}_all_pair_bound_ms={all_pairs[0]:.4f} ({all_pairs[1]})")


def pair_bound(name: str, work, bytes_moved: int, n_tiles: int):
    """((ms, what bounds it) of K2 or K2g at one frame, a log fragment with
    it and the all-pair figure). Where the model culls its pair lists, the
    kernel evaluates the kept pairs (``work[4]``) and blends the hits, and
    the cull costs its own f64 operations per tested pair (OPS_CULL) and,
    for gut3d, per pixel (OPS_TILE_BOUND); the all-pair figure prices every
    pair's evaluations, as the sweep before the cull made them."""
    evals, hits, tested, _, kept_evals = work
    model = "gut3d" if name.endswith("_gut3d") else "gs2d"
    all_pairs = kernel_bound(name, evals, hits, bytes_moved)
    if not MODELS[model].cull_pairs:
        return all_pairs, f"{name}_bound_ms={all_pairs[0]:.4f} ({all_pairs[1]}; no cull)"
    cull = tested * OPS_CULL[model] + n_tiles * tr.PIX * OPS_TILE_BOUND[model]
    bound = kernel_bound(name, kept_evals, hits, bytes_moved, f64_ops=cull)
    return bound, (f"{name}_bound_ms={bound[0]:.4f} ({bound[1]}; the kept pairs) "
                   f"{name}_all_pair_bound_ms={all_pairs[0]:.4f} ({all_pairs[1]})")


def kernel_bound(name: str, evals: int, hits: int, bytes_moved: int, extra_ops: int = 0,
                 f64_ops: int = 0):
    """(bound ms, what bounds it): the larger of the operations over the
    card's peak for their type and the bytes over its memory rate."""
    per_eval = OPS_ALPHA["gut3d" if name.endswith("_gut3d") else "gs2d"]
    return roofline(evals * per_eval + hits * OPS_PER_HIT[name] + extra_ops, bytes_moved,
                    f64_ops)


def bucket_bound(model: str, work, bytes_fwd: int, bytes_bwd: int, grad_rows: int,
                 n_tiles: int):
    """({name: (ms, what bounds it)} of K3 and K4 at one frame, a log
    fragment with those and the all-lane figures). Both kernels evaluate
    the lanes their cull keeps (``work.kept_evals``) and blend the hits,
    plus the merge's comparisons and, in K4, the reduce; the cull costs its
    own f64 operations per tested lane and, for gut3d, per pixel (OPS_CULL,
    OPS_TILE_BOUND). The all-lane figure prices every live lane's
    evaluations, as the sweep before the cull made them."""
    suffix = "_gut3d" if model == "gut3d" else ""
    cull = work.tested * OPS_CULL[model] + n_tiles * tr.PIX * OPS_TILE_BOUND[model]
    bounds, all_lanes = {}, {}
    for base, bytes_moved, extra in (
            ("raster_bucket_fwd", bytes_fwd, work.comparisons),
            ("raster_bucket_bwd", bytes_bwd, work.comparisons + work.shared * grad_rows)):
        name = base + suffix
        bounds[name] = kernel_bound(name, work.kept_evals, work.hits, bytes_moved, extra, cull)
        all_lanes[name] = kernel_bound(name, work.evals, work.hits, bytes_moved, extra)
    text = (" ".join(f"{k}_bound_ms={v[0]:.4f} ({v[1]})" for k, v in bounds.items())
            + " (the kept lanes; every live lane's evaluations: "
            + " ".join(f"{k}_all_lane_bound_ms={v[0]:.4f} ({v[1]})" for k, v in all_lanes.items())
            + ")")
    return bounds, text


def roofline(ops: float, bytes_moved: float, f64_ops: float = 0.0):
    """(bound ms, what bounds it): the larger of the operations over the
    card's peak for their type (f32, and f64 where given) and the bytes over
    its memory rate."""
    t_ops = (ops / PEAK_F32_OPS + f64_ops / PEAK_F64_OPS) * 1e3
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def copy_bound(fresh_bytes: float, landed_bytes: float):
    """(bound ms, "bytes") of copies into shared memory: the larger of the
    bytes that must come from device memory (each distinct source byte read
    once, the output written once) over its rate, and every copied byte
    landing in shared memory over the card's fill rate."""
    fill = SM_COUNT * SMEM_BYTES_PER_CLOCK * BOOST_HZ
    return max(fresh_bytes / PEAK_BYTES, landed_bytes / fill) * 1e3, "bytes"


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


def traced_events(call, calls):
    """The torch.profiler trace events of ``calls`` calls of ``call`` and
    its kernels as sorted (start us, end us, name, correlation id). The
    profiler's schedule traces one warm-up call first and throws it away:
    on an H100 a window without that step has lost the records of its
    first one to three kernels (PERF.md §6, PR 9)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts, schedule=once,
                                    on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            call()  # warm-up
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
            prof.step()
        events = json.load(open(path))["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"],
                      e.get("args", {}).get("correlation")) for e in events
                     if e.get("cat") == "kernel")
    return events, kernels


# K4's wrapper launches three kernels (csrc/raster_bucket_bwd.cu)
K4_KERNELS = ("raster_bucket_bwd_tiles", "raster_bucket_bwd_partial", "raster_bucket_bwd_reduce")


def kernel_split(call, counter, names=K4_KERNELS, calls=7):
    """{name: median device ms per call} of the kernels whose names hold
    each of ``names``, from the profiler's per-kernel durations over
    ``calls`` calls, each launching each kernel once. ``counter()`` reads
    the wrapper's launch count: it must advance by exactly the calls and
    the warm-up, and the trace must hold a record of every kernel of every
    call."""
    before = counter()
    _, kernels = traced_events(call, calls)
    launched = counter() - before
    check(launched == calls + 1, f"kernel_split: {launched} launches in {calls + 1} calls")
    split = {}
    for name in names:
        durs = [(e - s) / 1e3 for s, e, kname, _ in kernels if name in kname]
        check(len(durs) == calls, f"{len(durs)} records of {name} in {calls} calls")
        split[name] = median(durs)
    return split


def profile_calls(name, call, card, calls=3):
    """Device busy and idle share over `calls` calls of an entry point, from
    the torch.profiler trace: busy is the union of kernel intervals, the
    span runs from the first kernel's start to the last one's end. Each
    kernel belongs to the stage span (STAGES, opened by render_3dgs and
    train_step themselves) that holds its launch call, matched by the
    trace's correlation id, so the kernels autograd launches from its own
    thread count in the backward stage."""
    events, kernels = traced_events(call, calls)
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
    and its bound at this frame."""
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

    # ---- K1 against its twin over every tile of the slots frame; its
    # per-warp cull and its bound at this frame's shape and data (K2's: the
    # training frame)
    st = raster_statics(cfg)
    bins = bins_of(prepared, cam, cfg)
    n_pairs, n_tiles = int(bins.num_pairs), st.tiles_x * st.tiles_y
    err, agree = compare_kernel_with_twin(bins, st)
    log(f"all {n_tiles} tiles: kernel_vs_twin_max_abs={err:.3e} id_agree={agree:.6f} "
        f"max_tile_pairs={int(bins.tile_count.max())}")
    check(err <= KERNEL_ATOL, f"1080p tiles kernel vs twin {err} > {KERNEL_ATOL}")
    check(agree >= ID_AGREE, f"1080p tiles id agreement {agree}")
    work, kept = check_warp_cull("K1", bins, st, twin_tiles(st, dev))
    bytes_fwd = n_pairs * (10 * 4 + 4) + n_tiles * (2 * 4 + tr.PIX * (tr.OUT_ROWS * 4 + 4))
    bound, text = warp_cull_bound("rasterize_fwd", work, bytes_fwd, n_tiles)
    bounds = {"rasterize_fwd": bound}
    log(f"bound 1080p/1M slots: live_pairs={n_pairs} pixel_pair_evaluations={work[0]} "
        f"kept_evaluations={work[4]} hits={work[1]} hit_share={work[1] / max(work[0], 1):.4f} "
        + text)
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
    return dict(launches=launches, max_abs_err=err, ms=t["blend"], plain_ms=t_plain,
                kept_share=kept / (tr.WARPS * work[2])), bounds


def grads_of(splats):
    return [getattr(splats, f).grad for f in FIELDS]


def jittered_start(truth: gt.SplatSet, dev, seed: int) -> gt.SplatSet:
    """Where training starts: the scene with seeded jitter on means (1e-3)
    and sh_dc (0.3)."""
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    fields = {f: getattr(truth, f).detach().clone() for f in FIELDS}
    fields["means"] += 1e-3 * torch.randn(fields["means"].shape, generator=g, device=dev)
    fields["sh_dc"] += 0.3 * torch.randn(fields["sh_dc"].shape, generator=g, device=dev)
    return gt.SplatSet(**fields)


def train_full_size(dev, card: str, truth: gt.SplatSet, seed: int):
    """The training path at 1080p with 1M splats: the scene renders its own
    target; training starts from seeded jitter on means and sh_dc. Returns
    K2's report entry and its bound at the training frame."""
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    tc = gt.TrainConfig(scene_extent=4.0)
    with torch.no_grad():
        target = render(truth.prepare(), cam, cfg).image
    splats = jittered_start(truth, dev, seed)
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

    # ---- K2 against the twin backward over every tile, with the loss's own
    # cotangent at the blend; its cull and bound on this frame
    st = raster_statics(cfg)
    stages, c = frame_stages(splats.prepare(), cam, cfg)
    for _, step in stages:
        step()
    (g_out,) = torch.autograd.grad(gt.rgb_loss(c["image"], target, tc.ssim_lambda),
                                   c["out"][0])
    out = c["out"][0].detach()
    ctx = tr.bwd_context(out, g_out)
    bins = c["bins"]
    n_pairs, n_tiles = int(bins.num_pairs), st.tiles_x * st.tiles_y
    abs_err, rel_err = compare_bwd_with_twin(bins, st, ctx)
    log(f"all {n_tiles} tiles: K2_vs_twin_max_abs={abs_err:.3e} "
        f"max_rel_to_row_max={rel_err:.3e}")
    check(rel_err <= BWD_RTOL, f"1080p frame K2 vs twin {rel_err} > {BWD_RTOL}")
    work, kept = check_pair_cull("K2", bins, st, twin_tiles(st, dev))
    bytes_bwd = n_pairs * 2 * tr.GRAD_ROWS * 4 + n_tiles * (2 * 4 + tr.PIX * tr.CTX_ROWS * 4)
    bound, text = pair_bound("rasterize_bwd", work, bytes_bwd, n_tiles)
    log(f"bound 1080p/1M slots training frame: live_pairs={n_pairs} "
        f"pixel_pair_evaluations={work[0]} kept_pair_evaluations={work[4]} hits={work[1]} "
        + text)

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
    return dict(launches=launches[1], max_abs_err=abs_err, ms=t_k2, plain_ms=t_twin,
                kept_share=kept / work[2]), bound


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


def check_cull(label: str, work, k3, k4, model: str, bins, st, caps, batches, pix=None) -> int:
    """The cull of K3 and K4 on a whole frame; returns the kept-lane count.
    Each kernel's kept-lane counter after one launch, ``k3()`` and ``k4(ctx)``
    (any cotangent: what the cull keeps reads the rows and the freeze
    alone), against the plain predicate's count (``work``, from
    ops/raster_bucket.bucket_work): equal, as K1's and K2's are (the
    predicate is in double with margins, and every card run of the
    counters has given the plain count); and the two counts equal, since both kernels run one
    predicate over the same steps and freeze.
    Then, over every tile in ``batches``, the lanes the plain predicate
    culls that the twin's alpha passes at some pixel of the tile
    (ops/raster_bucket.tile_lane_hits, frozen pixels too): none allowed."""
    n_tiles = st.tiles_x * st.tiles_y
    g = "g" if model == "gut3d" else ""
    k3()
    k4(torch.ones((n_tiles, tr.CTX_ROWS, tr.PIX), device=bins.attrs.device))
    torch.cuda.synchronize()
    kept = {f"K3{g}": int(getattr(rb.rasterize_buckets, rb.KEPT_COUNTER[model])),
            f"K4{g}": int(getattr(rb.rasterize_buckets_bwd, rb.KEPT_COUNTER[model]))}
    for kname, n in kept.items():
        log(f"{kname} cull 1080p/1M: kept={n} of live={work.live} (kept share "
            f"{n / work.live:.4f}), tested={work.tested}; tile_may_hit over the steps each "
            f"tile enters {work.kept} (differ by {n - work.kept}; gate: equal); kept lanes' "
            f"pixel evaluations {work.kept_evals} of {work.evals}")
        check(n == work.kept, f"{kname} kept {n} lanes, the plain predicate {work.kept}")
    check(len(set(kept.values())) == 1, f"{label}: the kernels kept {kept}")
    may = hit = bad = 0
    attrs = bins.attrs.detach()
    for tiles in batches:
        m = rb.tile_may_hit(attrs, bins.bucket_starts, st, caps, tiles, pix)
        h = rb.tile_lane_hits(attrs, bins.bucket_starts, st, caps, tiles, pix)
        may, hit, bad = may + int(m.sum()), hit + int(h.sum()), bad + int((h & ~m).sum())
    log(f"  {label} cull audit on all {sum(b.numel() for b in batches)} tiles: {may} lanes "
        f"kept, {hit} hit some pixel, culled lanes that hit: {bad}")
    check(bad == 0, f"{label}: the cull dropped {bad} lanes that hit")
    return kept[f"K3{g}"]


def k4_launches(k4, model: str, bins, st, caps) -> str:
    """K4's three launches (``kernel_split``) and the kept share of its last
    launch, as a log fragment."""
    split = kernel_split(k4, lambda: getattr(rb.rasterize_buckets_bwd, tr.LAUNCH_COUNTER[model]))
    torch.cuda.synchronize()
    kept = int(getattr(rb.rasterize_buckets_bwd, rb.KEPT_COUNTER[model]))
    live = int(rb._tile_spans(bins.bucket_starts, st, caps,
                              torch.arange(st.tiles_x * st.tiles_y, device="cuda"))[1].sum())
    return (" ".join(f"{k}_ms={v:.4f}" for k, v in split.items())
            + f" (median of 7 profiled calls) kept={kept} of live={live} "
            f"(kept share {kept / live:.4f})")


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
    from both the EWA and the UT projection (bench.py:164-183: EWA feeds
    3DGS, UT feeds 3DGUT and 3DGRT), fitted with ``margin``."""
    spec = BucketGridSpec.build(-(-cfg.width // 16), -(-cfg.height // 16))
    req = torch.stack([measure_required_caps(project(prepared, c, cfg), spec)
                       for c in cams for project in (project_splats, ut_project_splats)]
                      ).amax(dim=0)
    req = [int(x) for x in req.tolist()]
    return fit_caps(req, margin=margin), req


def headline_caps(prepared, cam, cfg):
    """The bucket caps of the headline cell: fitted over the FRAMES jittered
    frames from both projections, doubled once if a frame still overflows
    (bench.py:225-235: never quietly truncate)."""
    caps, req = fitted_caps(prepared, [jitter(cam, i) for i in range(FRAMES)], cfg)
    bumped = any(bool(render(prepared, jitter(cam, i), bucket_cfg(cfg, caps)).overflow)
                 for i in range(FRAMES))
    if bumped:
        caps = tuple(2 * c for c in caps)
    log(f"bucket caps 1080p/1M (EWA and UT projections): required={req} "
        f"fitted={list(caps)} caps_bumped={bumped}")
    torch.cuda.synchronize()
    return caps


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
    caps = headline_caps(prepared, cam, cfg)
    bcfg = bucket_cfg(cfg, caps)

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
    bounds, text = bucket_bound("gs2d", work, bytes_fwd, bytes_bwd, tr.GRAD_ROWS, n_tiles)
    log(f"bound 1080p/1M bucket: live_candidates={work.live} shared={work.shared} "
        f"per_tile={work.live / n_tiles:.1f} pixel_lane_evaluations={work.evals} "
        f"kept_lane_evaluations={work.kept_evals} "
        f"hits={work.hits} hit_share={work.hits / max(work.evals, 1):.4f} "
        f"merge_comparisons={work.comparisons} {text} (rows read once per slot, not per tile: "
        f"{int(bins.num_valid) * 44 / PEAK_BYTES * 1e3:.4f} ms)")
    kept = check_cull("K3, K4", work, lambda: rb.rasterize_buckets(bins, st, caps),
                      lambda ctx: rb.rasterize_buckets_bwd(bins.attrs.detach(),
                                                           bins.bucket_starts, ctx, st, caps),
                      "gs2d", bins, st, caps, twin_tiles(st, dev))
    del bins

    # ---- timings (CUDA events; medians over 10 after 2 warm-up), stages in
    # order; K3 against its twin over every tile of the frame
    stages, c = frame_stages(prepared, cam, bcfg)
    t = {stage: median(time_ms(step, 10)) for stage, step in stages}
    t_frame = median(time_ms(lambda: render(prepared, cam, bcfg), 10))
    log(f"timing 1080p/1M bucket ({card}): project_ms={t['project']:.4f} "
        f"bin_ms={t['bin']:.4f} blend_ms={t['blend']:.4f} assemble_ms={t['assemble']:.4f} "
        f"frame_ms={t_frame:.4f}")
    bins = c["bins"]
    err_all, agree_all = compare_k3_with_twin(bins, st, caps)
    log(f"bucket all {n_tiles} tiles: K3_vs_twin_max_abs={err_all:.3e} "
        f"id_agree={agree_all:.6f}")
    check(err_all <= KERNEL_ATOL, f"1080p frame K3 vs twin {err_all} > {KERNEL_ATOL}")
    check(agree_all >= ID_AGREE, f"1080p frame K3 id agreement {agree_all}")
    t_plain = median(time_ms(lambda: bucket_twin(bins, st, caps), 2, warmup=1))
    log(f"timing raster_bucket_fwd 1080p/1M ({card}): kernel_ms={t['blend']:.4f} "
        f"plain_twin_ms={t_plain:.4f}")
    del bins, c
    profile_calls("bucket", lambda: render(prepared, cam, bcfg), card)
    return caps, dict(launches=launches, max_abs_err=max(err, err_all), ms=t["blend"],
                      plain_ms=t_plain, kept_share=kept / work.live), bounds


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
    splats = jittered_start(truth, dev, seed)
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
    tiles = sample_bucket_tiles(bins, st, dev, seed)
    abs_err, rel_err = compare_k4_with_twin(bins, st, caps, ctx, tiles=tiles)
    log(f"bucket 64 sampled tiles: K4_vs_twin_max_abs={abs_err:.3e} "
        f"max_rel_to_row_max={rel_err:.3e}")

    # ---- timings (CUDA events, medians after warm-up; the profiler's
    # per-kernel durations for K4's three launches)
    attrs = bins.attrs.detach()

    def k4():
        return rb.rasterize_buckets_bwd(attrs, bins.bucket_starts, ctx, st, caps)

    t_k4 = median(time_ms(k4, 10))
    t_twin = median(time_ms(lambda: bucket_twin_bwd(bins, st, caps, ctx), 1, warmup=1))
    log(f"timing raster_bucket_bwd 1080p/1M ({card}): kernel_ms={t_k4:.4f} "
        f"plain_twin_ms={t_twin:.4f} " + k4_launches(k4, "gs2d", bins, st, caps))
    del stages, c, bins, attrs, ctx, g_out
    t_fb = median(time_ms(fwd_bwd, 10))
    t_step = median(time_ms(lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc), 10))
    log(f"timing training 1080p/1M bucket ({card}): fwd_bwd_ms={t_fb:.4f} "
        f"train_step_ms={t_step:.4f}")
    profile_calls("bucket train_step",
                  lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc), card)
    return dict(launches=launches[1], max_abs_err=abs_err, ms=t_k4, plain_ms=t_twin)


# ---- the gut3d model: 3DGUT (MESH_3DGUT) and 3DGRT (RTX), K1g-K4g --------

# Kernel against twin, card against CPU, gut3d (tests/test_torch_cuda.py,
# verify SKILL): alphas are rounded alike, but a ray-response cutoff
# (resp > kernel_min_response) that one side's rounding flips drops a whole
# pair-pixel, moving the pixel by up to about kernel_min_response *
# opacity ~ 1.1e-2. So a share within KERNEL_ATOL and a cap, never the max
# alone; gradient rows within 2e-3 of the row's max plus the elementwise
# gate. Each comparison logs how far the flips went.
GUT_SHARE, GUT_MAX, GUT_BWD_RTOL = 0.999, 1.2e-2, 2e-3
GUT_TAIL, GUT_CUT_ALPHA_MIN = 2e-2, 0.02  # gut_bucket_vs_pairs
GUT_TWIN_BATCH = 256  # tiles per gut3d twin call at 1080p
GUT_PIPELINES = (("3dgut", gt.Pipeline.MESH_3DGUT), ("3dgrt", gt.Pipeline.RTX))
GRAD_ROWS_GUT = 14


def gut_cfg(cfg, pipeline=gt.Pipeline.MESH_3DGUT, method="pairs", caps=None, **kw):
    raster = dataclasses.replace(cfg.raster, method=method,
                                 bucket_caps=tuple(caps or cfg.raster.bucket_caps))
    return cfg.replace(pipeline=pipeline, raster=raster, **kw)


def gut_stages(prepared, cam, cfg, max_pairs=0):
    """render_3dgut's / render_3dgrt's stages for one temporal sample, as
    ``frame_stages``: project, bin, rays, blend, assemble."""
    c = {}
    grt = cfg.pipeline == gt.Pipeline.RTX

    def project():
        c["proj"] = ut_project_splats(prepared, cam, cfg)

    def bin_():
        c["bins"], c["st"] = gut_bin(prepared, c["proj"], cam, cfg, max_pairs, radial_order=grt)

    def rays():
        c["pix"] = build_tile_rays(cam, cfg)

    def blend():
        c["out"] = blend_bins(c["bins"], cfg, c["st"], c["pix"])

    def assemble():
        c["image"] = tr.assemble_image(*c["out"], c["st"].tiles_x, c["st"].tiles_y, cfg.width,
                                       cfg.height, cfg.background)[0]

    return [("project", project), ("bin", bin_), ("rays", rays), ("blend", blend),
            ("assemble", assemble)], c


def run_stages(stages):
    for _, step in stages:
        step()


def blend_st(c, cfg):
    """The statics the blend ran with (the bucket chunk on the bucket path)."""
    if cfg.raster.method == "bucket":
        return dataclasses.replace(c["st"], chunk=cfg.raster.bucket_chunk)
    return c["st"]


def tile_batches(st, dev, tiles=None):
    """``tiles`` (all by default) in batches of GUT_TWIN_BATCH: a gut3d
    twin keeps about 80 (tiles, 256, chunk) f32 intermediates."""
    if tiles is None:
        tiles = torch.arange(st.tiles_x * st.tiles_y, device=dev)
    return [tiles[a:a + GUT_TWIN_BATCH] for a in range(0, tiles.shape[0], GUT_TWIN_BATCH)]


@torch.no_grad()
def gut_twin(c, cfg, tiles=None):
    """K1g's or K3g's twin over ``tiles`` (all by default), in batches."""
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    parts = []
    for t in tile_batches(st, pix.device, tiles):
        if cfg.raster.method == "bucket":
            parts.append(rb.rasterize_buckets_ref(bins.attrs.detach(), bins.ids,
                                                  bins.bucket_starts, st, cfg.raster.bucket_caps,
                                                  tiles=t, pix_ctx=pix))
        else:
            parts.append(tr.rasterize_tiles_ref(bins.attrs.detach(), bins.pair_id,
                                                bins.tile_start, bins.tile_count, st, tiles=t,
                                                pix_ctx=pix))
    return torch.cat([o for o, _ in parts]), torch.cat([i for _, i in parts])


@torch.no_grad()
def gut_twin_bwd(c, cfg, ctx, tiles=None):
    """K2g's or K4g's twin over ``tiles`` (all by default), in batches."""
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    total = 0
    for t in tile_batches(st, pix.device, tiles):
        if cfg.raster.method == "bucket":
            total = total + rb.rasterize_buckets_bwd_ref(
                bins.attrs.detach(), bins.bucket_starts, ctx, st, cfg.raster.bucket_caps,
                tiles=t, pix_ctx=pix)
        else:
            total = total + tr.rasterize_tiles_bwd_ref(
                bins.attrs.detach(), bins.tile_start, bins.tile_count, ctx, st, tiles=t,
                pix_ctx=pix)
    return total


def gut_kernel_bwd(c, cfg, ctx):
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    if cfg.raster.method == "bucket":
        return rb.rasterize_buckets_bwd(bins.attrs.detach(), bins.bucket_starts, ctx, st,
                                        cfg.raster.bucket_caps, pix)
    return tr.rasterize_tiles_bwd(bins.attrs.detach(), bins.tile_start, bins.tile_count, ctx,
                                  st, pix)


def gut_fwd_gate(label, out_k, id_k, out_r, id_r):
    """(max abs err, share within KERNEL_ATOL, id agreement) of a gut3d
    forward against a reference, flip-aware; fails outside the gates."""
    diff = (out_k[:, :4] - out_r[:, :4]).abs()
    err = diff.max().item() if diff.numel() else 0.0
    share = (diff <= KERNEL_ATOL).float().mean().item() if diff.numel() else 1.0
    agree = (id_k == id_r).float().mean().item()
    log(f"  {label}: max abs {err:.3e}, share within {KERNEL_ATOL:g} {share:.6f} (gate "
        f"{GUT_SHARE}, cap {GUT_MAX:g}), values beyond {int((diff > KERNEL_ATOL).sum())}, "
        f"id agreement {agree:.6f}")
    check(share >= GUT_SHARE and err <= GUT_MAX, f"{label} outside the gut3d gates")
    check(agree >= ID_AGREE, f"{label} id agreement {agree}")
    return err


def compare_gut_kernel(label, c, cfg, tiles=None):
    """K1g or K3g (the blend ``c`` ran) against its twin on ``tiles``."""
    out_k, id_k = c["out"]
    out_r, id_r = gut_twin(c, cfg, tiles)
    if tiles is not None:
        out_k, id_k = out_k[tiles], id_k[tiles]
    torch.cuda.synchronize()
    return gut_fwd_gate(label, out_k.detach(), id_k, out_r, id_r)


def compare_gut_bwd(label, c, cfg, ctx, tiles=None):
    """K2g or K4g against its twin on the columns ``tiles`` read (all by
    default; the context zeroed outside them, as compare_k4_with_twin)."""
    if tiles is not None:
        keep = torch.zeros(ctx.shape[0], dtype=torch.bool, device=ctx.device)
        keep[tiles] = True
        ctx = ctx * keep[:, None, None]
    d_k = gut_kernel_bwd(c, cfg, ctx)

    def twin(cx):
        return gut_twin_bwd(c, cfg, cx, tiles)

    cols = ((d_k != 0) | (twin(ctx) != 0)).any(dim=0)
    return gate_bwd_against_twin(label, d_k, twin, ctx, cols, GRAD_ROWS_GUT, GUT_BWD_RTOL)


@torch.no_grad()
def count_flips(c, n_tiles=64):
    """(flipped, hits) pair-pixels of a gut3d pair frame: alpha > 0 on the
    card but not on the CPU twin or the reverse, over the first tiles with
    pairs, from the same attributes and rays."""
    bins, st, pix = c["bins"], c["st"], c["pix"]
    tiles = torch.nonzero(bins.tile_count > 0).flatten()[:n_tiles]
    flipped = hits = 0
    steps = [tr._blend_steps(bins.attrs.detach().to(dev), bins.tile_start.to(dev),
                             bins.tile_count.to(dev), st, tiles.to(dev), pix.to(dev))[1]
             for dev in (pix.device, torch.device("cpu"))]
    for a, b in zip(*steps):
        flipped += int(((a.alpha > 0).cpu() != (b.alpha > 0)).sum())
        hits += int((b.alpha > 0).sum())
    return flipped, hits


def golden_gut(dev):
    """3DGUT on the golden scene: 256x192 frames on both paths, K1g and K3g
    against their twins over the frame, bucket against pair; at 128x96 the
    card against the CPU twin (flip-aware; flipped pair-pixels counted), K2g
    and K4g against their twins over the frame with the cotangent of
    sum(image^2), and a central difference of 4 opacities on each path."""
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev)
    prepared = splats.prepare()
    base = gt.RenderConfig(width=w, height=h, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)
    caps, req = fitted_caps(prepared, [cam], base)
    errs = {}
    frames = {}
    for method in ("pairs", "bucket"):
        cfg = gut_cfg(base, method=method, caps=caps)
        stages, c = gut_stages(prepared, cam, cfg)
        run_stages(stages)
        frames[method] = render(prepared, cam, cfg)
        check(not bool(frames[method].overflow) or method == "pairs",
              "golden 3DGUT bucket frame overflowed")
        errs[method] = compare_gut_kernel(f"golden 3DGUT {method}: kernel vs twin over the frame",
                                          c, cfg)
    ref = torch.from_numpy(np.load(os.path.join(GOLDEN, "golden_view0.npy"))
                           .astype(np.float32)).to(dev)
    mse = torch.mean((frames["pairs"].image.clamp(0, 1) - ref) ** 2).item()
    diff = (frames["bucket"].image - frames["pairs"].image).abs()
    share = (diff <= BUCKET_VS_PAIR_ATOL).float().mean().item()
    log(f"golden 3DGUT: {w}x{h} caps={list(caps)} required={req} psnr_vs_3dgs_golden_db="
        f"{10 * math.log10(1.0 / max(mse, 1e-12)):.3f} (informative: 3DGUT of a 3DGS-trained "
        f"scene) bucket_vs_pair share within {BUCKET_VS_PAIR_ATOL:g} {share:.6f} max "
        f"{diff.max().item():.3e}")
    check(share >= BUCKET_VS_PAIR_SHARE and diff.max().item() <= GUT_MAX,
          f"golden 3DGUT bucket vs pair frame: share {share}")

    # gradients and the card against the CPU at 128x96
    cfg_s = gt.RenderConfig(width=128, height=96, sh_degree=0)
    cam_s = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], 128, 96, fov_y_rad=0.9,
                       device=dev)
    caps_s, _ = fitted_caps(prepared, [cam_s], cfg_s)
    cpu_splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device="cpu")
    cam_cpu = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], 128, 96, fov_y_rad=0.9,
                         device="cpu")
    bwd_errs = {}
    for method in ("pairs", "bucket"):
        cfg = gut_cfg(cfg_s, method=method, caps=caps_s)
        card = render(prepared, cam_s, cfg)
        cpu = render(cpu_splats.prepare(), cam_cpu, cfg)
        d = (card.image.cpu() - cpu.image).abs().flatten()
        n_far = int((d > 5e-5).sum())
        log(f"golden 3DGUT {method} 128x96, card vs CPU twin: max abs {d.max().item():.3e}, "
            f"channels beyond 5e-5 {n_far} of {d.numel()}, ids agree "
            f"{(card.splat_id.cpu() == cpu.splat_id).float().mean().item():.6f}")
        check(n_far <= d.numel() // 1000 and d.max().item() <= GUT_MAX,
              f"golden 3DGUT {method} card vs CPU outside the flip-aware gate")
        stages, c = gut_stages(prepared, cam_s, cfg)
        run_stages(stages)
        if method == "pairs":
            flipped, hits = count_flips(c)
            log(f"golden 3DGUT pairs, card twin vs CPU twin alphas on 64 tiles: {flipped} "
                f"flipped pair-pixels of {hits} hits")
        out = c["out"][0].detach().requires_grad_()
        image = tr.assemble_image(out, c["out"][1], c["st"].tiles_x, c["st"].tiles_y,
                                  cfg.width, cfg.height, cfg.background)[0]
        (g_out,) = torch.autograd.grad((image ** 2).sum(), out)
        label = "K2g" if method == "pairs" else "K4g"
        bwd_errs[method], rel = compare_gut_bwd(f"golden {label}", c, cfg,
                                                tr.bwd_context(out.detach(), g_out))

        def loss(op):
            s = dataclasses.replace(splats, opacities=op)
            return torch.sum(render(s.prepare(), cam_s, cfg).image.double() ** 2)

        op0 = splats.opacities.clone().requires_grad_()
        loss(op0).backward()
        g = op0.grad
        big = torch.nonzero(g.abs() > torch.quantile(g.abs(), 0.99)).flatten()
        idx = big[torch.randperm(big.numel(), device=dev,
                                 generator=torch.Generator(device=dev).manual_seed(0))[:4]]
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
        log(f"golden 3DGUT gradients {method} 128x96: {label}_vs_twin_max_abs="
            f"{bwd_errs[method]:.3e} max_rel_to_row_max={rel:.3e} "
            f"central_difference_worst_rel={worst:.3e}")
        check(worst < 2e-2, f"golden 3DGUT {method} central difference off by {worst}")
    return errs, bwd_errs


def gut_camera_effects(dev):
    """One golden-size 3DGUT frame with a fisheye camera, a rolling shutter
    (the end pose 0.3 to the right) and thin-lens DoF at temporal_samples=4:
    finite, one K1g launch per sample, and changed by the aperture."""
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    prepared = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev).prepare()
    cfg = gut_cfg(gt.RenderConfig(width=w, height=h, sh_degree=0,
                                  camera_type=gt.CameraType.FISHEYE,
                                  shutter=gt.ShutterType.ROLLING_TOP_TO_BOTTOM,
                                  temporal_samples=4))
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)
    vm_end = cam.viewmat.clone()
    vm_end[0, 3] -= 0.3
    cam = dataclasses.replace(cam, viewmat_end=vm_end)
    dof = dataclasses.replace(cam, aperture=torch.tensor(0.15, device=dev),
                              focus_dist=torch.tensor(7.0, device=dev))
    tr.rasterize_tiles.launches_gut3d = 0
    sharp, blurred = render(prepared, cam, cfg), render(prepared, dof, cfg)
    torch.cuda.synchronize()
    launches = tr.rasterize_tiles.launches_gut3d
    change = (sharp.image - blurred.image).abs().max().item()
    log(f"golden 3DGUT fisheye + rolling shutter + DoF, temporal_samples=4: launches={launches} "
        f"(2 frames), finite={bool(torch.isfinite(blurred.image).all())}, max change by the "
        f"aperture {change:.4e}, covered_frac={(blurred.transmittance < 0.5).float().mean().item():.4f}")
    check(launches == 8, f"{launches} K1g launches for 2 frames of 4 samples")
    check(bool(torch.isfinite(blurred.image).all()), "non-finite DoF frame")
    check(change > 1e-3, "the aperture did not change the frame")


def gut_pair_bounds(label, c):
    """({K1g's bound at this pair frame}, the kept share of its per-warp
    cull), after the cull's checks (``check_warp_cull``; K2g's bound comes
    from the training frame)."""
    st, pix = c["st"], c["pix"]
    work, kept = check_warp_cull(f"{label} K1g", c["bins"], st, tile_batches(st, pix.device),
                                 pix)
    n_tiles, n_pairs = st.tiles_x * st.tiles_y, int(c["bins"].num_pairs)
    fwd = (n_pairs * (15 * 4 + 4) + n_tiles * (8 + tr.PIX * (tr.OUT_ROWS * 4 + 4))
           + n_tiles * tr.PIX * 6 * 4)
    bound, text = warp_cull_bound("rasterize_fwd_gut3d", work, fwd, n_tiles)
    log(f"bound {label} pairs: live_pairs={n_pairs} pixel_pair_evaluations={work[0]} "
        f"kept_evaluations={work[4]} hits={work[1]} hit_share={work[1] / max(work[0], 1):.4f} "
        + text)
    return {"rasterize_fwd_gut3d": bound}, kept / (tr.WARPS * work[2])


@torch.no_grad()
def gut_bounds(c, cfg):
    """(K3g's and K4g's bounds at a 3DGUT bucket frame, the kept share of
    their cull)."""
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    parts = [rb.bucket_work(bins.attrs.detach(), bins.bucket_starts, st, cfg.raster.bucket_caps,
                            tiles=t, pix_ctx=pix)
             for t in tile_batches(st, pix.device)]
    work = rb.BucketWork(*(sum(p[i] for p in parts) for i in range(len(parts[0]))))
    evals, hits = work.evals, work.hits
    n_tiles = c["st"].tiles_x * c["st"].tiles_y
    rays = n_tiles * tr.PIX * 6 * 4
    p = c["bins"].attrs.shape[1]
    head = n_tiles * (12 * 4 + 12 * 4)
    fwd = work.live * (15 * 4 + 4) + head + n_tiles * tr.PIX * (tr.OUT_ROWS * 4 + 4) + rays
    bwd = (work.live * GRAD_ROWS_GUT * 4 + head + n_tiles * tr.PIX * tr.CTX_ROWS * 4 + rays
           + p * GRAD_ROWS_GUT * 4)
    bounds, text = bucket_bound("gut3d", work, fwd, bwd, GRAD_ROWS_GUT, n_tiles)
    log(f"bound gut3d bucket: live_candidates={work.live} shared={work.shared} "
        f"pixel_lane_evaluations={evals} kept_lane_evaluations={work.kept_evals} hits={hits} "
        f"hit_share={hits / max(evals, 1):.4f} merge_comparisons={work.comparisons} {text}")
    st, caps, pix = blend_st(c, cfg), cfg.raster.bucket_caps, c["pix"]
    kept = check_cull("K3g, K4g", work, lambda: rb.rasterize_buckets(c["bins"], st, caps, pix),
                      lambda ctx: gut_kernel_bwd(c, cfg, ctx), "gut3d", c["bins"], st, caps,
                      tile_batches(st, pix.device), pix)
    return bounds, kept / work.live


def gut_bucket_vs_pairs(prepared, cam, cfg, bucket_out):
    """The 3DGUT bucket frame against the exact pair frame. The pair path
    blends a splat only in the tiles of its UT rect, which bounds the
    extent where opacity * response >= 0.01; the bucket path blends every
    candidate of a tile's window, so it also adds a mid or coarse splat's
    tail beyond its rect, where alpha lies between alpha_min (1/255) and
    about 0.01. So at the default alpha_min the frames differ by up to
    about 0.01 per tail (gate: >= 99.9 % of pixels within GUT_TAIL); with
    the tails cut (alpha_min 0.02 on both paths) they must agree as the
    gs2d paths do (BUCKET_VS_PAIR_ATOL on >= 99.9 % of pixels)."""
    exact_cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, method="pairs",
                                                       expansion="exact"))
    for alpha_min in (cfg.raster.alpha_min, GUT_CUT_ALPHA_MIN):
        def with_alpha_min(c):
            return c.replace(raster=dataclasses.replace(c.raster, alpha_min=alpha_min))

        bucket = (bucket_out if alpha_min == cfg.raster.alpha_min
                  else render(prepared, cam, with_alpha_min(cfg)))
        exact = render(prepared, cam, with_alpha_min(exact_cfg), max_pairs=1 << 22)
        diff = (bucket.image - exact.image).abs().amax(dim=-1)
        atol = GUT_TAIL if alpha_min == cfg.raster.alpha_min else BUCKET_VS_PAIR_ATOL
        share = (diff <= atol).float().mean().item()
        log(f"3dgut bucket vs exact pair frame, alpha_min {alpha_min:.6g}: share of pixels "
            f"within {BUCKET_VS_PAIR_ATOL:g} {(diff <= BUCKET_VS_PAIR_ATOL).float().mean().item():.6f}"
            f", within {atol:g} {share:.6f} (gate {BUCKET_VS_PAIR_SHARE}), max abs "
            f"{diff.max().item():.4e}, exact overflow={bool(exact.overflow)}")
        check(not bool(exact.overflow) and share >= BUCKET_VS_PAIR_SHARE,
              f"3dgut bucket vs pair at alpha_min {alpha_min}: share {share}")


def gut_full_size(dev, card: str, prepared, caps, seed: int):
    """3DGUT and 3DGRT frames at 1080p with 1M splats on both paths, at the
    caps derived over both projections; returns K1g's and K3g's report
    entries and the four gut3d kernels' bounds."""
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    entries, bounds = {}, {}
    for label, pipeline in GUT_PIPELINES:
        for method in ("pairs", "bucket"):
            cfg = gut_cfg(base, pipeline, method, caps)
            fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
            torch.cuda.synchronize()
            # ---- the main path: FRAMES frames through render(), launches counted
            fwd.launches = fwd.launches_gut3d = 0
            outs = [render(prepared, jitter(cam, i), cfg) for i in range(FRAMES)]
            torch.cuda.synchronize()
            launches = (fwd.launches_gut3d, fwd.launches)
            log(f"{label} {method} main path: {FRAMES} frames, gut3d launches={launches[0]} "
                f"gs2d launches={launches[1]}")
            check(launches == (FRAMES, 0), f"{launches} launches for {FRAMES} {label} frames")
            for o in outs:
                check(tuple(o.image.shape) == (HEIGHT, WIDTH, 3), f"{label} image shape")
                check(bool(torch.isfinite(o.image).all()), f"non-finite {label} image")
                check(bool(((o.transmittance >= 0) & (o.transmittance <= 1)).all()),
                      f"{label} transmittance outside [0, 1]")
                check(method == "pairs" or not bool(o.overflow),
                      f"a {label} bucket frame overflowed at the derived caps")
            o0 = outs[0]
            del outs
            again = render(prepared, jitter(cam, 0), cfg)
            torch.cuda.synchronize()
            bit_equal = all(torch.equal(getattr(again, f), getattr(o0, f))
                            for f in ("image", "transmittance", "depth", "splat_id"))
            covered = (o0.transmittance < 0.5).float().mean().item()
            log(f"{label} {method} frame: overflow={bool(o0.overflow)} num_pairs="
                f"{int(o0.num_pairs)} covered_frac={covered:.4f} repeat bit-equal: {bit_equal}")
            check(bit_equal, f"repeat {label} {method} render differs")
            check(covered > 0.05, f"the {label} frame covers almost nothing")
            if label == "3dgut" and method == "bucket":
                gut_bucket_vs_pairs(prepared, jitter(cam, 0), cfg, o0)
            del again, o0
            t_frame = median(time_ms(lambda: render(prepared, cam, cfg), 10))
            log(f"timing 1080p/1M {label} {method} ({card}): frame_ms={t_frame:.4f}")
            if label != "3dgut" and method == "bucket":
                continue
            # ---- the kernel against its twin (K3g on 64 sampled tiles too),
            # stages, bounds; K1g on every tile of the 3DGUT and 3DGRT frames
            stages, c = gut_stages(prepared, cam, cfg)
            if label == "3dgut":
                t = {stage: median(time_ms(step, 10)) for stage, step in stages}
                log(f"timing 1080p/1M 3dgut {method} stages ({card}): "
                    + " ".join(f"{k}_ms={v:.4f}" for k, v in t.items()))
            else:
                run_stages(stages)
            if method == "bucket":
                tiles = sample_bucket_tiles(c["bins"], c["st"], dev, seed)
                err = compare_gut_kernel(f"K3g vs twin on {tiles.numel()} sampled 1080p tiles",
                                         c, cfg, tiles)
                err = max(err, compare_gut_kernel("K3g vs twin on all 1080p tiles", c, cfg))
                frame_bounds, kept_share = gut_bounds(c, cfg)
            else:
                err = compare_gut_kernel(f"{label} K1g vs twin on all 1080p tiles", c, cfg)
                frame_bounds, kept_share = gut_pair_bounds(label, c)
            if label != "3dgut":  # the 3DGRT pairs frame: K1g's gates and cull, no entry
                entries["rasterize_fwd_gut3d"]["max_abs_err"] = max(
                    entries["rasterize_fwd_gut3d"]["max_abs_err"], err)
                del stages, c
                profile_calls("3dgrt pairs", lambda: render(prepared, cam, cfg), card)
                continue
            bounds.update(frame_bounds)
            kname = "K3g" if method == "bucket" else "K1g"
            t_plain = median(time_ms(lambda: gut_twin(c, cfg), 1, warmup=1))
            log(f"timing {kname} 1080p/1M ({card}): kernel_ms={t['blend']:.4f} "
                f"plain_twin_ms={t_plain:.4f}")
            name = "raster_bucket_fwd_gut3d" if method == "bucket" else "rasterize_fwd_gut3d"
            entries[name] = dict(launches=launches[0], max_abs_err=err, ms=t["blend"],
                                 plain_ms=t_plain, kept_share=kept_share)
            del stages, c
            if method == "pairs":
                profile_calls("3dgut pairs", lambda: render(prepared, cam, cfg), card)
    return entries, bounds


def gut_train_full_size(dev, card: str, truth: gt.SplatSet, caps, seed: int):
    """3DGUT training at 1080p with 1M splats on both paths: the scene
    renders its own target; training starts from seeded jitter on means and
    sh_dc. Returns K2g's and K4g's report entries and K2g's bound at the
    pair path's training frame."""
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    tc = gt.TrainConfig(scene_extent=4.0)
    entries, bounds = {}, {}
    for method in ("pairs", "bucket"):
        cfg = gut_cfg(base, method=method, caps=caps)
        fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
        bwd = rb.rasterize_buckets_bwd if method == "bucket" else tr.rasterize_tiles_bwd
        with torch.no_grad():
            target = render(truth.prepare(), cam, cfg).image
        splats = jittered_start(truth, dev, seed)
        opt = gt.make_optimizer(splats, tc)
        torch.cuda.synchronize()

        # ---- the training path: TRAIN_STEPS steps, the gut3d launches counted
        fwd.launches_gut3d = bwd.launches_gut3d = 0
        steps = [gt.train_step(splats, opt, cam, target, cfg, 0, tc) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        launches = (fwd.launches_gut3d, bwd.launches_gut3d)
        losses = [loss.item() for loss, _ in steps]
        log(f"3dgut {method} training path: {TRAIN_STEPS} steps, fwd launches={launches[0]} "
            f"bwd launches={launches[1]}; losses {' '.join(f'{x:.6f}' for x in losses)} "
            f"overflow={[bool(o) for _, o in steps]}")
        check(launches == (TRAIN_STEPS, TRAIN_STEPS),
              f"{launches} gut3d launches for {TRAIN_STEPS} train steps")
        check(all(math.isfinite(x) for x in losses), "non-finite 3DGUT training loss")
        check(losses[-1] < losses[0], f"the 3DGUT {method} loss did not fall: {losses}")
        check(all(bool(torch.isfinite(x).all()) for x in grads_of(splats)),
              "non-finite gradient in the last 3DGUT train step")

        def fwd_bwd():
            opt.zero_grad(set_to_none=True)
            out = render(splats.prepare(), cam, cfg)
            gt.rgb_loss(out.image, target, tc.ssim_lambda).backward()

        fwd_bwd()
        first = [x.clone() for x in grads_of(splats)]
        fwd_bwd()
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(first, grads_of(splats))]
        log(f"3dgut {method} repeat backward bit-equal (six fields): {all(same)} "
            f"{dict(zip(FIELDS, same))}")
        check(all(same), f"repeat 3DGUT {method} backward differs")
        del first

        # ---- the backward kernel against its twin (K4g on 64 sampled tiles,
        # K2g over every tile), with the loss's own cotangent at the blend;
        # K2g's cull and bound on this frame
        stages, c = gut_stages(splats.prepare(), cam, cfg)
        run_stages(stages)
        (g_out,) = torch.autograd.grad(gt.rgb_loss(c["image"], target, tc.ssim_lambda),
                                       c["out"][0])
        ctx = tr.bwd_context(c["out"][0].detach(), g_out)
        if method == "bucket":
            tiles = sample_bucket_tiles(c["bins"], c["st"], dev, seed)
            abs_err, _ = compare_gut_bwd(f"K4g on {tiles.numel()} sampled 1080p tiles", c, cfg,
                                         ctx, tiles)
        else:
            bins, st = c["bins"], c["st"]
            n_pairs, n_tiles = int(bins.num_pairs), st.tiles_x * st.tiles_y
            abs_err, _ = compare_gut_bwd(f"K2g on all {n_tiles} 1080p tiles", c, cfg, ctx)
            work, kept = check_pair_cull("K2g", bins, st, tile_batches(st, dev), c["pix"])
            bwd = (n_pairs * 2 * GRAD_ROWS_GUT * 4 + n_tiles * (8 + tr.PIX * tr.CTX_ROWS * 4)
                   + n_tiles * tr.PIX * 6 * 4)
            bounds["rasterize_bwd_gut3d"], text = pair_bound("rasterize_bwd_gut3d", work, bwd,
                                                             n_tiles)
            log(f"bound gut3d pairs training frame: live_pairs={n_pairs} "
                f"pixel_pair_evaluations={work[0]} hits={work[1]} " + text)
        kname = "K4g" if method == "bucket" else "K2g"
        t_k = median(time_ms(lambda: gut_kernel_bwd(c, cfg, ctx), 10))
        t_twin = median(time_ms(lambda: gut_twin_bwd(c, cfg, ctx), 1, warmup=1))
        split = ""
        if method == "bucket":
            split = k4_launches(lambda: gut_kernel_bwd(c, cfg, ctx), "gut3d", c["bins"],
                                blend_st(c, cfg), caps)
        log(f"timing {kname} 1080p/1M ({card}): kernel_ms={t_k:.4f} plain_twin_ms={t_twin:.4f} "
            + split)
        del stages, c, ctx, g_out
        t_fb = median(time_ms(fwd_bwd, 10))
        t_step = median(time_ms(lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc), 10))
        log(f"timing training 1080p/1M 3dgut {method} ({card}): fwd_bwd_ms={t_fb:.4f} "
            f"train_step_ms={t_step:.4f}")
        if method == "pairs":
            profile_calls("3dgut train_step",
                          lambda: gt.train_step(splats, opt, cam, target, cfg, 0, tc), card)
        name = "raster_bucket_bwd_gut3d" if method == "bucket" else "rasterize_bwd_gut3d"
        entries[name] = dict(launches=launches[1], max_abs_err=abs_err, ms=t_k, plain_ms=t_twin)
        if method == "pairs":
            entries[name]["kept_share"] = kept / work[2]
        del splats, opt, target
    return entries, bounds


def bit_equal(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference of a probe kernel's output against its twin's, 0:
    fails unless they are equal bit for bit, NaN keys included (the probes
    only compare, select and copy)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"{label}: kernel and twin differ")
    return 0.0


def probe_bound(label: str, columns: int, elements: int, bytes_moved: int, variant: str,
                takes: int, rows: int, t_k: float):
    """The probe's bound (``roofline``) over its least work: the (key,
    index) network's operations per column and stage and one permutation
    of the payload; logs it with the share the kernel reaches and the
    bound of the row-moving form beside it."""
    bound = roofline(columns * PROBE_OPS_PER_COLUMN[variant] + elements * PROBE_OPS_PER_ELEMENT,
                     bytes_moved)
    row_form = roofline(columns * PROBE_OPS_ROW_FORM[variant] + takes * rows, bytes_moved)
    log(f"probe {label} bound: {bound[0]:.4f} ms ({bound[1]}), share of bound "
        f"{bound[0] / t_k:.4f}; the row form's count {row_form[0]:.4f} ms ({row_form[1]}), "
        f"columns taking their partner {takes} of {columns}")
    return bound


def ties_nan(x: torch.Tensor, key_row: int) -> torch.Tensor:
    """x with its key row drawn from {0, 1, -0, NaN}: ties, signed zeros and
    keys that never compare."""
    x = x.clone()
    g = torch.Generator(device=x.device).manual_seed(9)
    pick = torch.randint(0, 4, x[:, key_row].shape, generator=g, device=x.device)
    vals = torch.tensor([0.0, 1.0, -0.0, float("nan")], device=x.device)
    x[:, key_row] = vals[pick]
    return x


def zero_probe_counts():
    probe_roll.bitonic_sort.launches = 0
    probe_radix.dma_copies.launches = 0
    for v in probe_stage.VARIANTS:
        probe_stage.sort_stages.launches[v] = 0


def probe_counts() -> dict:
    return {"bench_roll": probe_roll.bitonic_sort.launches,
            "bench_radix_ab": probe_radix.dma_copies.launches,
            **{stage_name(v): probe_stage.sort_stages.launches[v]
               for v in probe_stage.VARIANTS}}


def probe_main_paths() -> dict:
    """Each probe's entry point at its script's default arguments, all probe
    launch counts zeroed just before and read just after: the probe's own
    kernel ran, and no other."""
    paths = [("bench_roll", probe_roll.run)]
    paths += [(stage_name(v), lambda v=v: probe_stage.run(v)) for v in probe_stage.VARIANTS]
    paths += [("bench_radix_ab", probe_radix.run)]
    launches = {}
    for name, path in paths:
        zero_probe_counts()
        path()
        torch.cuda.synchronize()
        counts = probe_counts()
        launches[name] = counts.pop(name)
        log(f"main path {name}: launches={launches[name]}")
        check(launches[name] > 0, f"the {name} probe never launched its kernel")
        check(not any(counts.values()), f"the {name} probe launched other kernels: {counts}")
    return launches


def probe_roll_phase(dev, card: str):
    """P1: bit-equal to the twin at small sizes (3 sorts; ties, signed zeros
    and NaN keys), at the script's (one 16 x 2048 tile, 200 sorts) and at
    the frame's 8160 tiles sorted once, the launch this report times; the
    key network alone at 8160 x (2, 2048)."""
    small = probe_roll.tiles_of(3, 4, 128, dev)
    err = max(bit_equal(f"bench_roll small {name}", probe_roll.bitonic_sort(y, 3),
                        probe_roll.bitonic_sort_ref(y, 3))
              for name, y in (("", small), ("ties and NaN", ties_nan(small, 0))))
    one = probe_roll.tiles_of(1, 16, 2048, dev)
    err = max(err, bit_equal("bench_roll default", probe_roll.bitonic_sort(one, probe_roll.REPS),
                             probe_roll.bitonic_sort_ref(one, probe_roll.REPS)))
    x = probe_roll.tiles_of(probe_roll.FRAME_TILES, 16, 2048, dev, seed=1)
    sched = probe_stage.full_schedule(2048)
    err = max(err, bit_equal("bench_roll 8160 tiles", probe_roll.bitonic_sort(x, 1),
                             probe_roll.bitonic_sort_ref(x, 1)))
    t_k = median(time_ms(lambda: probe_roll.bitonic_sort(x, 1), 10))
    t_twin = median(time_ms(lambda: probe_roll.bitonic_sort_ref(x, 1), 3, warmup=1))

    def library():  # one sort of the key rows, one gather of the payload
        order = torch.sort(x[:, 0], dim=-1).indices
        return torch.take_along_dim(x, order[:, None], dim=-1)

    t_lib = median(time_ms(library, 10))
    keys = x[:, :KEY_NETWORK_ROWS].contiguous()
    t_net = median(time_ms(lambda: probe_roll.bitonic_sort(keys, 1), 10))
    del keys
    takes = probe_stage.taking_columns(x, None, "lane-iota", sched, 0)
    columns = x.shape[0] * x.shape[2] * len(sched)
    label = f"bench_roll {x.shape[0]} x (16, 2048), 66 stages"
    bound = probe_bound(label, columns, x.numel(), 2 * x.numel() * 4, "lane-iota", takes,
                        x.shape[1], t_k)
    log(f"probe {label} ({card}): kernel_ms={t_k:.4f} plain_twin_ms={t_twin:.4f} library_ms "
        f"(torch.sort + torch.take_along_dim)={t_lib:.4f} bound_ms={bound[0]:.4f} "
        f"({bound[1]}); key network alone (8160 x (2, 2048)) {t_net:.4f} ms; "
        f"max_abs_err={err}")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_twin, share_of_bound=bound[0] / t_k,
                key_network_ms=t_net), bound, t_lib


def duplicating_table(m: torch.Tensor, sched) -> torch.Tensor:
    """The mask table with want_min(e ^ j) = want_min(e) for every low
    column e with e % 3 == 0: both columns of such a pair want one side, so
    one may take the other's column and duplicate it."""
    flat = m.clone().reshape(2 * len(sched), -1)
    e = torch.arange(flat.shape[1], device=m.device)
    for s, (_, j) in enumerate(sched):
        lo = e[((e & j) == 0) & (e % 3 == 0)]
        flat[2 * s + 1, lo | j] = flat[2 * s + 1, lo]
    return flat.reshape(m.shape)


def probe_stage_phase(dev, card: str, variant: str):
    """P3, one variant: bit-equal to the twin at small sizes (a cut and a
    repeated schedule; ties, signed zeros and NaN keys; a mask table that
    duplicates columns) and at the script's default (16 rows, 55 stages, 2
    tiles in each of 4096 blocks), the launch this report times; the key
    network alone at 2 rows. The twin and the library call run on the 4096
    x 2 tiles the kernel sorts."""
    err = 0.0
    for rows, n_stages, tpt in ((4, 20, 2), (8, 70, 3)):
        x, m, sched = probe_stage.inputs(variant, rows, n_stages, tpt, dev, seed=7)
        cases = [("", x, m), ("ties and NaN", ties_nan(x, rows - 1), m)]
        if m is not None:
            cases.append(("duplicating table", x, duplicating_table(m, sched)))
        for name, y, table in cases:
            err = max(err, bit_equal(f"{variant} small {name}", probe_stage.sort_stages(
                y, table, variant, sched, rows - 1, blocks=3), probe_stage.sort_stages_ref(
                y, table, variant, sched, rows - 1)))
    rows, steps = 16, probe_stage.STEPS
    x, m, sched = probe_stage.inputs(variant, rows, 55, 2, dev)
    err = max(err, bit_equal(f"{variant} default", probe_stage.sort_stages(
        x, m, variant, sched, rows - 1, blocks=steps), probe_stage.sort_stages_ref(
        x, m, variant, sched, rows - 1)))
    t_k = median(time_ms(lambda: probe_stage.sort_stages(x, m, variant, sched, rows - 1,
                                                         blocks=steps), 10))
    batch = x.repeat(steps, *([1] * (x.dim() - 1)))
    t_twin = median(time_ms(lambda: probe_stage.sort_stages_ref(batch, m, variant, sched,
                                                                rows - 1), 3, warmup=1))
    flat = batch.reshape(batch.shape[0], rows, -1)

    def library():  # one sort of the key rows, one gather of the payload
        order = torch.sort(flat[:, rows - 1], dim=-1).indices
        return torch.take_along_dim(flat, order[:, None], dim=-1)

    t_lib = median(time_ms(library, 10))
    del batch, flat
    keys = x[:, rows - KEY_NETWORK_ROWS:].contiguous()
    t_net = median(time_ms(lambda: probe_stage.sort_stages(
        keys, m, variant, sched, KEY_NETWORK_ROWS - 1, blocks=steps), 10))
    takes = steps * probe_stage.taking_columns(x, m, variant, sched, rows - 1)
    columns = steps * x.shape[0] * probe_stage.C * len(sched)
    label = f"{variant} {steps} blocks x 2 x ({rows}, 1024), 55 stages"
    bound = probe_bound(label, columns, steps * x.numel(),
                        2 * x.numel() * 4 + (0 if m is None else m.numel() * 4), variant, takes,
                        rows, t_k)
    log(f"probe {label} ({card}): kernel_ms={t_k:.4f} plain_twin_ms={t_twin:.4f} library_ms "
        f"(torch.sort + torch.take_along_dim)={t_lib:.4f} bound_ms={bound[0]:.4f} "
        f"({bound[1]}); ns per stage and tile {t_k * 1e6 / steps / 55 / 2:.3f}; key network "
        f"alone (2 rows) {t_net:.4f} ms; max_abs_err={err}")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_twin, share_of_bound=bound[0] / t_k,
                key_network_ms=t_net), bound, t_lib


def probe_radix_phase(dev, card: str, w: int = 16):
    """P2: at the script's 256 steps x 64 copies, for each W, the output of
    one block and of 256 blocks against the block the last copy into ring
    slot 0 brought; at 4 steps x 64 copies, in one block and in two, every
    copied block against the twin's copies; the launch this report times:
    W = 16 across the card."""
    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.randn((probe_radix.SRC_BLOCKS, *probe_radix.BLOCK), generator=g, device=dev)
    n_steps, n_copies = probe_radix.N_STEPS, probe_radix.N_COPIES
    last = ((n_steps - 1) * n_copies + (n_copies - 1) // 8 * 8) % probe_radix.OFFSET_CYCLE
    err = 0.0
    for width in probe_radix.WIDTHS:
        for spb in (None, 1):
            err = max(err, bit_equal(f"bench_radix_ab W={width}", probe_radix.dma_copies(
                src, n_steps, n_copies, width, spb), src[last:last + 1]))
        ref_out, ref_copies = probe_radix.dma_copies_ref(src, 4, n_copies, width, trace=True)
        for spb in (None, 3):   # the one-block ring and the card's
            out, copies = probe_radix.dma_copies(src, 4, n_copies, width, spb, trace=True)
            err = max(err, bit_equal(f"bench_radix_ab W={width} output", out, ref_out),
                      bit_equal(f"bench_radix_ab W={width} every copy", copies, ref_copies))
            del copies
        del ref_copies
    t_k = median(time_ms(lambda: probe_radix.dma_copies(src, n_steps, n_copies, w, 1), 10))
    t_twin = median(time_ms(lambda: probe_radix.dma_copies_ref(src, n_steps, n_copies, w), 3,
                            warmup=1))
    idx = torch.tensor([o + b for o in probe_radix.copy_offsets(n_steps, n_copies)
                        for b in range(w)], device=dev)
    t_lib = median(time_ms(lambda: torch.index_select(src, 0, idx), 10))
    copied = n_steps * n_copies * w * probe_radix.BLOCK_BYTES
    # the distinct source blocks the offsets reach, and the output block
    fresh = (min(n_steps * n_copies, probe_radix.OFFSET_CYCLE) - 1 + w + 1) \
        * probe_radix.BLOCK_BYTES
    bound = copy_bound(fresh, copied)
    props = torch.cuda.get_device_properties(dev)
    log(f"probe bench_radix_ab W={w}, {n_steps} blocks x {n_copies} copies ({card}): "
        f"kernel_ms={t_k:.4f} plain_twin_ms={t_twin:.4f} library_ms (torch.index_select)="
        f"{t_lib:.4f} bound_ms={bound[0]:.4f} ({bound[1]}: {fresh} B from device memory, "
        f"{copied} B into shared memory at {SM_COUNT} SMs x {SMEM_BYTES_PER_CLOCK} B x "
        f"{BOOST_HZ / 1e9} GHz; the card reports {props.multi_processor_count} SMs, "
        f"max SM clock {max_sm_clock()}); {copied / t_k / 1e6:.1f} GB/s; max_abs_err={err}")
    return dict(max_abs_err=err, ms=t_k, plain_ms=t_twin), bound, t_lib


def max_sm_clock() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def probes(dev, card: str):
    """Phase 9: the probes P1-P3. Returns their report entries, bounds and
    library times."""
    t0 = time.perf_counter()
    launches = probe_main_paths()
    entries, bounds, library = {}, {}, {}
    phases = [("bench_roll", lambda: probe_roll_phase(dev, card))]
    phases += [(stage_name(v), lambda v=v: probe_stage_phase(dev, card, v))
               for v in probe_stage.VARIANTS]
    phases += [("bench_radix_ab", lambda: probe_radix_phase(dev, card))]
    for name, phase in phases:
        entry, bounds[name], library[name] = phase()
        entries[name] = dict(launches=launches[name], **entry)
        torch.cuda.empty_cache()
    log(f"probes phase {time.perf_counter() - t0:.1f} s")
    return entries, bounds, library


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    was_built = {name: _build.library_path(name).exists() for name in _SOURCES}
    with concurrent.futures.ThreadPoolExecutor(len(_SOURCES)) as pool:
        list(pool.map(_build.load, _SOURCES))  # one nvcc per source, all at once
    for name in _SOURCES:
        log(f"{'loaded prebuilt' if was_built[name] else 'built'} "
            f"{_build.library_path(name).name}")
        log_file = str(_build.library_path(name)) + ".log"
        if os.path.exists(log_file):
            log(open(log_file).read().strip())
    log(f"kernels ready in {time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    card = device_label(dev)
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
    bwd, bounds["rasterize_bwd"] = train_full_size(dev, card, truth, seed=0)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], err_golden_bwd)

    err_golden_k3 = golden_bucket(dev)
    err_golden_k4 = golden_bucket_gradients(dev)
    caps, k3, bucket_bounds = bucket_full_size(dev, card, truth.prepare(), seed=0)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_golden_k3)
    k4 = bucket_train_full_size(dev, card, truth, caps, seed=0)
    k4["max_abs_err"] = max(k4["max_abs_err"], err_golden_k4)
    k4["kept_share"] = k3["kept_share"]  # the same lanes on the headline frame (check_cull)
    bounds.update(bucket_bounds)
    results = {"rasterize_fwd": fwd, "rasterize_bwd": bwd, "raster_bucket_fwd": k3,
               "raster_bucket_bwd": k4}

    golden_fwd, golden_bwd = golden_gut(dev)
    gut_camera_effects(dev)
    gut_fwd, gut_bounds_ = gut_full_size(dev, card, truth.prepare(), caps, seed=0)
    gut_bwd, gut_bwd_bounds = gut_train_full_size(dev, card, truth, caps, seed=0)
    # K4g's cull keeps the lanes K3g's keeps on the same frame (check_cull)
    gut_bwd["raster_bucket_bwd_gut3d"]["kept_share"] = gut_fwd["raster_bucket_fwd_gut3d"][
        "kept_share"]
    for method, fwd_name, bwd_name in (("pairs", "rasterize_fwd_gut3d", "rasterize_bwd_gut3d"),
                                       ("bucket", "raster_bucket_fwd_gut3d",
                                        "raster_bucket_bwd_gut3d")):
        gut_fwd[fwd_name]["max_abs_err"] = max(gut_fwd[fwd_name]["max_abs_err"],
                                               golden_fwd[method])
        gut_bwd[bwd_name]["max_abs_err"] = max(gut_bwd[bwd_name]["max_abs_err"],
                                               golden_bwd[method])
    results.update(gut_fwd)
    results.update(gut_bwd)
    bounds.update(gut_bounds_)
    bounds.update(gut_bwd_bounds)
    probe_entries, probe_bounds, library = probes(dev, card)
    results.update(probe_entries)
    bounds.update(probe_bounds)

    report = {"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[name][1],
        "replaces": KERNELS[name][2], **results[name],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        # no single PyTorch call computes a tile blend; the probes have one
        "library_ms": library.get(name),
    } for name in KERNELS]}
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
