"""Smoke test of the PyTorch port on one NVIDIA card (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-views ROUNDS   # phase 10's view sweep alone
    python3 chip_smoke.py --lighting            # phase 11 alone (no report)
    python3 chip_smoke.py --raytrace            # phase 12 alone (no report)
    python3 chip_smoke.py --instances           # phase 13 alone (no report)
    python3 chip_smoke.py --tools               # phase 14 alone (no report)

Drives the port's main paths at full size on the card and checks them: the
3DGS raster frame, ``render(prepared, camera, cfg)``, and the training
step, ``train_step`` (render, loss, backward, Adam), each by the pair path
(the default RenderConfig) and by the bucket path
(``RasterConfig(method="bucket")``); then the 3DGUT and 3DGRT raster frames
(``Pipeline.MESH_3DGUT``, ``Pipeline.RTX``) and 3DGUT training on both
paths; the packed tier of all three (``RasterConfig(pair_format="packed")``,
forward only); stochastic transparency and its a-trous pass on all three
and in training; the host-sorted frame (``render(..., host_order=)`` fed by
``io/async_loader.AsyncHostSorter``, ``SortMethod.HOST``) forward and
backward with the splat IO (PLY, spz, .splat); meshes (``render_mesh``,
smooth and flat, and the mesh-composited 3DGS frame
``render_3dgs_composed``, forward and backward); lighting and shadows (the
lit 3DGS frame ``render_3dgs_lit`` and the hybrid frames ``render_hybrid``,
HYBRID and HYBRID_3DGUT, with deep shadow maps); ray tracing (3DGRT's
strict tier ``render_3dgrt_exact``, ``render_hybrid`` with
``rt.shadows="ray"`` and the wavefront bounces of
``render_composed_wavefront``: the plain-torch tracer of ops/raytrace.py);
a multi-instance scene with its project file and the inspection tools
(``SplatScene.flatten``, ``save_project`` / ``load_project``, the metrics,
``ImageCompare``, the overlays, the pixel traces); the tools around them
(the benchmark sequencer ``python -m vk_gaussian_splatting_tpu_torch.bench``,
the orbit and web viewers, the naive oracle, the sharded frames and train
step over ``torch.distributed``); the design probes P1-P3 through their
own entry points; and the SH radiance and EWA projection pairs against
their plain versions at the cells' splat counts. It measures no speed: the
benchmark (``python3 -m splatbench.run``) does, end to end and per layer,
and ``python -m vk_gaussian_splatting_tpu_torch.kernel_time`` times the
bandwidth kernels alone beside their byte bounds. The smoke's scene and training start
are the cells' (``splatbench.scene`` at inria_bicycle_6m.json's extent and
mix, train_3dgs.json's jitter), at 1,000,000 splats. So the inputs of its
full-size gates (the exact expansion's no-overflow check, the fitted caps,
the kept counts) follow those benchmark files: tests/test_torch_inspect.py
pins the extent, mix and jitter the gates were set on.

1. builds the CUDA kernels from the checkout, one nvcc per source, all at
   once: the pair blender K1 (csrc/rasterize_fwd.cu) and its backward K2
   (csrc/rasterize_bwd.cu), the bucket rasterizer K3
   (csrc/raster_bucket_fwd.cu) and its backward K4
   (csrc/raster_bucket_bwd.cu), each source holding the gs2d and the gut3d
   form of its kernel (csrc/response.cuh), the SH radiance pair
   (csrc/sh_radiance.cu) and the EWA projection pair (csrc/ewa_project.cu),
   and the probe kernels P1 (csrc/bench_roll.cu), P3
   (csrc/bench_sort_stage.cu, three variants) and P2
   (csrc/bench_radix_ab.cu), and beside them the native host library
   (native/fast_splats.cpp, c++ into build/native/); prints the kernels'
   -Xptxas -v reports and the card's name and power limit;
2. golden gate: the checked-in trained scene at 256x192 through K1, PSNR
   > 45 dB against assets/golden/golden_view0.npy, and K1 against its plain
   PyTorch twin over the whole frame; golden gradients at 128x96, SH 0: K2
   against the twin backward over the whole frame (``bwd_gate``, which
   must also reject the twin on two broken contexts), and a central
   difference of 4 high-gradient opacities through ``render`` on the card;
3. forward at full size: 1,000,000 splats at SH degree 3 (96.9 / 2.5 / 0.6 %
   small / mid / large scales) at 1920x1080, made on the card from a seeded
   generator; 8 jittered frames through ``render``, with K1's, the SH
   forward kernel's and the EWA forward kernel's launch counts read around
   them (one each a frame); the exact expansion (max_pairs = 2^22), which
   must not overflow; a bit-equal repeat frame; K1 against the twin over
   every tile; K1's per-warp cull on that frame: its kept (warp, pair)
   counter equal to the plain count (``ops/rasterize.pair_warp_may_hit``
   over the steps each tile enters), the kept share, and an audit of every
   tile for culled (warp, pair)s that hit some pixel of the warp
   (``pair_hits(per_warp=True)``; none allowed);
4. training at full size: the same scene is the target, the start the
   train cells' jittered one; 5 ``train_step``s with K1's, K2's, the SH
   pair's and the EWA pair's launch counts read around them (one each a
   step), a falling finite loss and finite gradients; one exact-expansion
   step; a bit-equal repeat backward; K2 against the twin backward over
   every tile of the training frame, in tile batches; K2's per-tile cull
   of the pair lists on that frame: its kept-pair counter against the
   plain predicate's count (``ops/rasterize.pair_may_hit`` over the steps
   each tile enters, exactly), the kept share, and an audit of every tile
   for culled pairs that hit (``pair_hits``; none allowed);
5. the bucket path, as 2-4 for the pair path: the golden frame at caps
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
   repeat backward. The per-tile cull of K3 and K4, on the headline frame:
   each kernel's kept-lane counter against the plain predicate's count
   (``ops/raster_bucket.tile_may_hit``, exactly) and the two equal, the
   kept share, and an audit of all its tiles for culled lanes that hit
   (none allowed);
6. the gut3d forms K1g-K4g (3DGUT, 3DGRT): golden-size 3DGUT frames on
   both paths, K1g and K3g against their twins over the frame, bucket
   against pair, the card against the CPU twin (flip-aware, with the
   flipped pair-pixels counted); golden gradients, K2g and K4g against
   their twins over the frame and a central difference of 4 opacities on
   each path; one golden-size frame with fisheye, rolling shutter and DoF
   at temporal_samples=4; at full size, 8 frames of 3DGUT and of 3DGRT on
   each path with the gut3d launches counted, overflow reported, a
   bit-equal repeat, K1g against its twin over every tile of the 3DGUT
   and 3DGRT pair frames with its per-warp cull checked as K1's, K3g on 64
   sampled tiles and on every tile, K3g's and K4g's cull checked on the
   3DGUT bucket frame as K3's and K4's; 3DGUT training on each path (5
   steps, launches counted, loss falling, bit-equal repeat backward, K2g
   against its twin over every tile and K4g on 64 sampled tiles, K2g's
   kept counter: it culls no pair, so equal to the tested pairs). The
   gut3d gates are flip-aware (``GUT_*``);
7. the packed tier, the forward-only forms K1p, K1gp (csrc/rasterize_fwd.cu
   ``rasterize_fwd_gs2dp``, ``_gut3dp``), K3p and K3gp
   (csrc/raster_bucket_fwd.cu): the golden scene at 256x192, 3DGS and 3DGUT
   on both paths, against the port's f32 frame (> 55 dB, ids > 99 %), the
   PSNR against golden_view0.npy beside the f32 frame's, each packed kernel
   against its twin over the frame; at the headline cell and caps, 3DGS and
   3DGUT on both paths and 3DGRT on the pair path (4 frames): the main path
   with every launch counter of the wrapper zeroed and read (only the
   packed one moves, one launch a frame), a bit-equal repeat, packed
   against f32, packed rows made on the card bit-equal to the CPU's from
   the same f32 quantities, each packed kernel against its twin over every
   tile (K3gp on 64 sampled tiles too), its kept count against the plain
   predicate's and the audit of every tile;
8. stochastic transparency (``cfg.stochastic`` SPLAT: the ``_stoch``
   forms of K1 and K3 for gs2d, gut3d, gs2dp and gut3dp, of K2 and K4 for
   gs2d and gut3d; ``stochastic``): at the headline cell and caps, 3DGS
   pairs and bucket at temporal_samples=4, 3DGUT pairs and bucket and 3DGRT
   pairs at 2, and the four packed frames at 1: the main path through
   ``render`` with every launch counter of the blend's wrapper zeroed and
   read (only the stochastic form moves, once a sample), T a multiple of 1
   / samples, a bit-equal repeat; sample 0's blend against its twin on
   every tile (gs2d and gs2dp bit for bit, gut3d >= 99.9 % of pixels bit
   for bit, the others counted), its kept counter against the plain count
   of the same stochastic sweep; 3 stochastic ``train_step``s on 3DGS and
   3DGUT on both methods (launches counted; opacities, scales and
   quaternions get exactly 0), each backward form against its twin with
   the loss's own cotangent on every tile (colour rows at K2's / K4's
   gates, every other row exactly 0) and its kept counter; the PSNR of
   3DGS pairs against the deterministic frame rising from 1 to 4 to 16
   samples per pixel, and the a-trous pass at 1080p equal to
   ``denoise_output``;
9. the host-sorted path and the IO (``host_sorted``), at the headline cell
   and caps: the native library built, its radix sort of the 1 M plane
   distances equal to numpy's stable argsort and the sorter's order equal
   to it; 8 jittered frames through ``render(..., host_order=)`` on the
   bucket path, each sorted by the sorter, with only
   ``rasterize_buckets.launches_keyrow`` moving (the key-row form of K3,
   csrc/raster_bucket_fwd.cu ``raster_bucket_fwd_keyrow``), no overflow, a
   bit-equal repeat, the frame against the device-sorted bucket frame
   (share within 2e-4, max, PSNR, ids, the picked depth the model's), a
   reversed order moving it by more than 1e-3, K3 _keyrow against its twin
   on every tile, the kept counters of K3 and K4 _keyrow against
   ``tile_may_hit`` over the key-row merge and the audit; the pair path
   with the order (K1 moves) against the device-sorted pair frame; packed
   rows on the bucket config with the order (K1p moves, not K3p; the
   packed pair frame); 3 fwd_bwd through ``render(..., host_order=)`` (K3
   and K4 _keyrow once a step, a bit-equal repeat), K4 _keyrow against its
   twin with the loss's cotangent on every tile and on 64 sampled tiles
   (``bwd_gate``), the key row's gradient exactly 0; a 2-sample stochastic
   host-sorted frame (``_stoch_keyrow`` moves) whose sample-0 blend equals
   its twin bit for bit, and one stochastic fwd_bwd (K4 ``_stoch_keyrow``)
   against its twin, each with its kept counter; then the 1 M scene
   through save and ``load_scene`` in PLY (exact, the native reader), spz
   and .splat (within their quantisation);
10. meshes (``meshes``), at the headline cell: a mesh built in code
   (``headline_mesh``: an octahedron sphere of 131,072 faces and a ground
   grid of 20,000, about half the pixels, splats in front of, inside and
   under it), lit by the headlight. First the view sweep (``mesh_views``,
   ``MESH_VIEWS``: faces on and just past the near plane, through the
   camera plane and edge-on): both mesh passes and the composed frame at
   each view, each synchronised and checked alone (finite, T 0 or 1, both
   passes' tile ranges and pair ids in range; ``--mesh-views ROUNDS`` runs
   it alone, ROUNDS times). ``render_mesh`` smooth and flat (K1
   tri2d_smooth, tri2d), 4 jittered frames each with only the form's
   launch counter moving, T exactly 0 or 1, the coverage, the face, slot
   and pair counts, no overflow, a bit-equal repeat; each form against its
   twin on 64 sampled tiles, its kept counter against
   ``pair_warp_may_hit``'s count and the audit over every tile. The
   composed frame (exact expansion, 2^22 pairs; deterministic and
   ``cfg.stochastic`` SPLAT), 8 jittered frames each with only K1
   tri2d_smooth and the splat pass's form (gs2d_clip, gs2d_clip_stoch)
   moving, no overflow, a bit-equal repeat, the share of splat picks the
   mesh changed; K1's form against its twin on sampled tiles, its kept
   counter and audit, the limit 0 everywhere equal to gs2d's form bit for
   bit. One loss step through each composed frame (K2 gs2d_clip,
   gs2d_clip_stoch once; a bit-equal repeat) and K2's form against its
   twin with the loss's cotangent on sampled tiles (``bwd_gate``; the
   stochastic form's colour rows, every other row 0), its kept counter
   and audit. One gradient of the flat mesh's image in its face colours
   (K2 tri2d once, repeatable), K2 tri2d against its twin (colour rows;
   the vertex rows exactly 0) and its kept counter (every tested pair);
11. lighting and shadows (``lighting``), at the headline cell with two
   lights (``headline_lights``: a directional light from above, which gets
   a 512^2 cone map, and a point light inside the scene's bounding sphere,
   which gets six 256^2 cube faces): ``render_3dgs_lit`` with two
   per-instance materials over the two halves of the splats, placed as two
   instances and routed by their flatten's global index table
   (``halves_scene``; K1 gs2d twice: the pass and its normal buffer; a
   bit-equal repeat, finite, covered pixels changed by the shade);
   ``render_hybrid`` HYBRID and HYBRID_3DGUT on 8 jittered frames each
   with every launch counter zeroed (per frame the blend's form twice and
   K1's multi-iso form, csrc/rasterize_fwd.cu ``rasterize_fwd_iso``, seven
   times), a bit-equal repeat, the shaded frame unlike the one with no
   light, each light's lookups over the covered pixels at two staircase
   levels or more; each map's pairs, overflow and longest tile list; K1's
   multi-iso form on the cone map and on a 2048^2 map against its twin on
   sampled tiles, on the card bit for bit against K1 gs2d (rows 0-3; row 4
   + k against the pick at depth_iso = ISO_LEVELS[k]), its kept counter
   against ``pair_warp_may_hit``'s count and the audit of every tile;
   ``render_hybrid`` at 128x96 with 2,000 splats on the card against the
   CPU (a shaded pixel beyond 1e-4 must read another staircase level); one
   gradient of the lit frame's shaded image (K2 gs2d twice, each launch
   against its twin with its own context, ``bwd_gate``);
12. ray tracing (``raytracing``; no kernel of its own, so no report entry):
   ``render_3dgrt_exact`` on tests/test_grt.py's 150-splat scene above 35
   dB against ``render_3dgrt`` (no blend launched), and on the golden scene
   at 256x192 (its PSNR against the raster frame logged);
   ``render_hybrid`` with ``rt.shadows="ray"`` at 160x90 on the headline
   scene with phase 11's two lights, HYBRID and HYBRID_3DGUT, one frame
   each with the launch counters zeroed (the blend's form twice), one
   shadow trace per light; ``render_composed_wavefront`` at 1080p with
   phase 10's mesh, the sphere glass and the ground a mirror, stride 16, 3
   bounces (the launch counters zeroed: tri2d_smooth and gs2d_clip once),
   then the same bounces step by step (spawn, trace_mesh, trace_splats,
   the rest, the live rays) equal to the frame bit for bit; on 128 rays of
   each batch (primary, shadow, first bounce) the card against the CPU at
   the tracer's gates, repeats bit-equal, the pass and any-hit estimators
   finite with T 0 or 1. The cuts are listed beside ``RT_SHADE_SIZE``;
13. instances, project files and the inspection tools (``instances``; no
   kernel of their own, so no report entry; ``--instances`` runs it alone
   after the builds): the headline mix at 250,000 splats placed five times
   (identity; a 35 degree turn, scale 0.8; a sheared non-uniform transform,
   the general bake; a rigid one with opacity_gain 0.6 and splat_scale
   1.25; an invisible one), 1 M splats after ``SplatScene.flatten``; the
   flatten on the card against the port on the CPU (the table exactly, the
   fields within 1e-6 of each row's scale); 8 jittered frames on pairs
   (exact expansion) and on bucket (caps fitted over them), each main path
   with its wrapper's counters zeroed (one K1 or K3 gs2d launch a frame),
   bit-equal repeats, each instance's share of the pixels, K1 and K3
   against their twins on sampled tiles; the lit frame with four
   per-instance materials routed by the real table (K1 gs2d twice; the
   material index = the table's instance of each picked splat); the
   session saved (the asset as PLY, the headline camera and a fisheye
   rolling-shutter one, phase 11's lights) and reopened on the card, its
   flatten's frame bit-equal, a second save the same JSON; MSE, PSNR and
   FLIP (both modes) at 1080p against the frame with the rigid instance
   moved by 0.05, and on a 256x144 crop the card against the CPU within
   1e-5; ``ImageCompare`` with three samples and the six composites; the
   grid and the three gizmo modes over the frame, and at 320x180 the card
   against the CPU within 1e-5; ``pixel_trace`` at 16 pixels of the exact
   pair frame (T above 1e-3, fewer than 200 contributors) within 2e-5 of
   it, ``pixel_trace_gut`` at 4 pixels each within 2e-2 of
   ``render_3dgut`` and ``render_3dgrt``;
14. the tools and multi-device (``tools``; no kernel of their own, their
   launches and frame differences added to the K1, K1g, K3, K3g and K2
   entries as ``tools_launches`` and ``tools_max_abs_err``; ``--tools``
   runs it alone after the builds): the headline scene written once as a
   PLY with ``save_ply``; ``python -m vk_gaussian_splatting_tpu_torch.bench``
   in-process on a cfg of the reference grammar (MESH at shformat 0, 1, 2,
   MESH_3DGUT, RTX, each with --updateData, one --screenshot) with
   ``--method pairs`` and ``bucket``: stdout parsed by ``bench/report.py``,
   every block's four timers named, one K1 / K3 (K1g / K3g) launch for
   each frame it ran, the screenshot's PNG decoded equal to the 8-bit
   image of ``render`` bit for bit, the Rasterization bytes beside the
   allocator's peak rise over one frame; the orbit viewer (4 frames at
   1080p) and the web viewer on 127.0.0.1, port 0, in a thread (the page
   and three frames: 3DGS rgb, 3DGUT depth, 3DGRT trans), each PNG decoded
   (zlib where Pillow is absent) equal to the 8-bit image of ``render`` /
   ``RenderSession.render``; the naive oracle on 2,000 splats at 128x96
   (``rasterize_naive`` against K1's frame within 3e-5 where the blender
   never froze a pixel, 1.5e-4 where it did; ``rasterize_naive_gut``
   against K1g's at the gut3d gates); world size 1 over NCCL: the sharded
   3DGS, 3DGUT and 3DGRT frames on both methods against the single-device
   ones (bit-equal, else the gates), ``train_step_sharded`` against one
   single-device step, and ``python -m ...parallel.distributed
   --num-processes 1``; two ranks on the one card over gloo with CUDA
   tensors (this script as ``--gloo-rank`` subprocesses, each with a
   timeout; first the collectives on small CUDA tensors, which must give
   the right results): the 3DGS pairs (exact expansion) and bucket bands
   against the single-device frame (3e-5 on pixels never frozen, 1.5e-4
   on frozen ones);
15. the probes (vk_gaussian_splatting_tpu_torch/probes): each probe's entry
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
16. the SH radiance pair (``sh_radiance_phase``): csrc/sh_radiance.cu's
   forward and backward at 6,130,000 and 1,000,000 splats at SH 3 in f32
   (the 3DGS cells' and the 3DGUT trainer's counts), the forward against
   the plain ``sh_radiance_ref`` on the card (within 2e-6), the backward
   against autograd through it and against the closed-form
   ``sh_radiance_bwd_ref`` (each gradient within 1e-5 of its largest
   entry); the pair's report entries take their launches from phases 3
   and 4;
17. the EWA projection pair (``ewa_project_phase``): csrc/ewa_project.cu's
   forward and backward at 6,130,000 and 15,300,000 splats (the 3DGS
   cells' and the hybrid cell's counts) at 1080p, the forward against the
   plain ``project_splats_ref`` on the card, the backward against autograd
   through it and against the closed-form ``project_splats_bwd_ref``, at
   tests/test_torch_cuda.py's gates (launches from phases 3 and 4).

Without a CUDA device it raises and prints no result. The last line is
``{"ok": true, "device": {...}}``; the line before it holds the kernel
report as JSON (each kernel's launches, its largest errors against its
references and the kept share of its cull), and the line before that the
card's name and power limit.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import io
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
from vk_gaussian_splatting_tpu_torch import debug, interop, native  # noqa: E402
from vk_gaussian_splatting_tpu_torch.io import (  # noqa: E402
    load_ply,
    load_scene,
    save_ply,
    save_splat_file,
    save_spz,
)
from vk_gaussian_splatting_tpu_torch.io import ply as tply  # noqa: E402
from vk_gaussian_splatting_tpu_torch.io.async_loader import AsyncHostSorter  # noqa: E402
from vk_gaussian_splatting_tpu_torch.io.project import (  # noqa: E402
    Project,
    load_project,
    save_project,
)
from vk_gaussian_splatting_tpu_torch.io.obj import ObjMaterial, ObjMesh, octa_sphere  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import _build  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import metrics  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import projection as tproj  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import sh as tsh  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import raytrace as rt  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.compare import CompareMode, ImageCompare  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.denoise import denoise_output  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import (  # noqa: E402
    BucketGridSpec,
    fit_caps,
    measure_required_caps,
    span_lengths,
)
from vk_gaussian_splatting_tpu_torch.ops.projection import (  # noqa: E402
    project_splats,
    ut_project_splats,
)
from vk_gaussian_splatting_tpu_torch.ops.response import (  # noqa: E402
    GS_KEY,
    MODELS,
    model_of,
    pack_rows,
)
from vk_gaussian_splatting_tpu_torch.probes import bench_radix_ab as probe_radix  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_roll as probe_roll  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_sort_stage as probe_stage  # noqa: E402
from vk_gaussian_splatting_tpu_torch.timing import device_label  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import (  # noqa: E402
    render,
    render_3dgrt,
    render_3dgrt_exact,
    render_3dgs_composed,
    render_3dgut,
    render_composed_wavefront,
)
from vk_gaussian_splatting_tpu_torch.render import helpers  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import mesh_raster as mr  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import pipelines, shadows, wavefront  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.deferred import (  # noqa: E402
    DeferredMaterial,
    deferred_shade,
    instance_index_image,
    normal_bins,
    normals_from_blend,
    surface_points,
)
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    bin_for_cfg,
    blend_bins,
    bucket_statics,
    gs_attr_rows,
    gs_attr_rows_packed,
    gut_attr_rows,
    gut_bin,
    host_rank,
    packed,
    pairs_cfg,
    raster_statics,
    render_3dgs_lit,
    render_hybrid,
)
from vk_gaussian_splatting_tpu_torch.render.shadows import (  # noqa: E402
    ISO_LEVELS,
    cube_cameras,
    light_camera,
    make_ray_shadow_fn,
    make_shadow_fn,
    scene_bounds,
    shadow_map_bins,
)
from vk_gaussian_splatting_tpu_torch.scene.cameras import CameraSet  # noqa: E402
from vk_gaussian_splatting_tpu_torch.scene.instances import SplatScene  # noqa: E402
from vk_gaussian_splatting_tpu_torch.scene.lights import LightType, make_light  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays  # noqa: E402
from vk_gaussian_splatting_tpu_torch.scene.splat_set import (  # noqa: E402
    SH_C0,
    covariance_from_scale_rot,
)
from splatbench import scene as cell_scene  # noqa: E402

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
    "sh_radiance": ("vk_gaussian_splatting_tpu_torch/csrc/sh_radiance.cu",
                    "none: the JAX package's ops/sh.py is jnp"),
    "ewa_project": ("vk_gaussian_splatting_tpu_torch/csrc/ewa_project.cu",
                    "none: the JAX package's ops/projection.py is jnp"),
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
# the packed tier's forms of K1 and K3 (forward only): entries <name>_gs2dp,
# <name>_gut3dp of the same sources
PACKED_KERNELS = {f"{name}_{model}": (name, *_SOURCES[name])
                  for name in ("rasterize_fwd", "raster_bucket_fwd")
                  for model in ("gs2dp", "gut3dp")}
KERNELS.update(PACKED_KERNELS)
# the stochastic forms (cfg.stochastic SPLAT / ANYHIT): entries <name>_stoch
# of every form of K1 and K3 and of the gs2d and gut3d forms of K2 and K4
STOCH_KERNELS = {name + tr.STOCH: spec for name, spec in KERNELS.items()
                 if "_fwd" in name or not name.endswith(("_gs2dp", "_gut3dp"))}
KERNELS.update(STOCH_KERNELS)
# the key-row forms of K3 and K4 (render_3dgs(host_order=...) on the bucket
# path, gs2d): entries <name>_keyrow and <name>_stoch_keyrow of the same sources
KEYROW_KERNELS = {name + form: (name, *_SOURCES[name])
                  for name in ("raster_bucket_fwd", "raster_bucket_bwd")
                  for form in (tr.KEYROW, tr.STOCH + tr.KEYROW)}
KERNELS.update(KEYROW_KERNELS)
# the mesh forms (render_mesh, render_3dgs_composed): entries <name>_gs2d_clip,
# <name>_gs2d_clip_stoch and <name>_tri2d of K1 and K2, <name>_tri2d_smooth of K1
MESH_KERNELS = {name + "_" + form: (name, *_SOURCES[name])
                for name, forms in (("rasterize_fwd", ("tri2d", "tri2d_smooth", "gs2d_clip",
                                                       "gs2d_clip" + tr.STOCH)),
                                    ("rasterize_bwd", ("gs2d_clip", "gs2d_clip" + tr.STOCH,
                                                       "tri2d")))
                for form in forms}
KERNELS.update(MESH_KERNELS)
# K1's multi-iso form (the deep shadow maps of render_hybrid): entry
# rasterize_fwd_iso of the same source
KERNELS.update({"rasterize_fwd" + tr.ISO: ("rasterize_fwd", *_SOURCES["rasterize_fwd"])})
KERNELS.update({"bench_roll": ("bench_roll", *_SOURCES["bench_roll"])})
KERNELS.update({stage_name(v): ("bench_sort_stage", *_SOURCES["bench_sort_stage"])
                for v in probe_stage.VARIANTS})
KERNELS.update({"bench_radix_ab": ("bench_radix_ab", *_SOURCES["bench_radix_ab"])})
KERNELS.update({name: ("sh_radiance", *_SOURCES["sh_radiance"])
                for name in ("sh_radiance_fwd", "sh_radiance_bwd")})
KERNELS.update({name: ("ewa_project", *_SOURCES["ewa_project"])
                for name in ("ewa_project_fwd", "ewa_project_bwd")})
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
# the bucket frame against the exact pair frame: they freeze pixels at
# different lanes (bucket_chunk 384 against chunk 128) and may order exactly
# equal depths apart, so a share of pixels, not the max
BUCKET_VS_PAIR_ATOL, BUCKET_VS_PAIR_SHARE = 2e-4, 0.999
TWIN_BATCH = 1024  # tiles per twin call at 1080p: a (1024, 256, 384) f32 step is 0.4 GB


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


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
                          rtol=BWD_RTOL, swap_not_suffix=False):
    """(max abs err, max err relative to each row's max) of a backward
    kernel's d_attrs ``d_k`` against ``twin(ctx)`` on the columns ``cols``,
    over its ``grad_rows`` gradient rows. Fails unless ``bwd_gate`` passes
    (at ``rtol``), and unless it rejects the twin on two broken contexts:
    one warp's cotangent zeroed, and S_total zeroed or, with
    ``swap_not_suffix``, the red and green cotangents swapped (for a pass
    whose S_total vanishes by itself: the normal buffer is normalised after
    the blend, so its cotangent is orthogonal to the blended colour)."""
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
    warp_out, other = ctx.clone(), ctx.clone()
    warp_out[:, :, 96:128] = 0.0
    if swap_not_suffix:
        other[:, [0, 1]] = ctx[:, [1, 0]]
    else:
        other[:, 3] = 0.0
    broken = "red and green swapped" if swap_not_suffix else "S_total zeroed"
    for what, bad in (("one warp's cotangent zeroed", warp_out), (broken, other)):
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
    evaluations, draws) over ``batches`` of tiles, the counter). Where the model
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
    work, may, hit, bad = [0] * 6, 0, 0, 0
    for tiles in batches:
        m = tr.pair_may_hit(*args, tiles, pix) if culls else every
        if culls:
            h = tr.pair_hits(*args, tiles, pix)
            may, hit, bad = may + int(m.sum()), hit + int(h.sum()), bad + int((h & ~m).sum())
        work = [a + b for a, b in zip(work, tr.blend_work(*args, tiles, pix, keep=m))]
    torch.cuda.synchronize()
    kept = int(getattr(tr.rasterize_tiles_bwd, tr.KEPT_COUNTER[tr.form_of(st)]))
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
    kept, kept evaluations, draws) over ``batches`` of tiles with the plain per-warp
    predicate ``ops/rasterize.pair_warp_may_hit``, the counter). The counter
    must equal the plain count of kept (warp, pair) bits over the steps each
    tile enters; and over every tile in ``batches``, the (warp, pair)s the
    plain predicate culls that the twin's alpha passes at some pixel of the
    warp (``pair_hits(per_warp=True)``, frozen pixels too): none allowed."""
    attrs = bins.attrs.detach()
    args = (attrs, bins.tile_start, bins.tile_count, st)
    work, may, hit, bad = [0] * 6, 0, 0, 0
    for tiles in batches:
        m = tr.pair_warp_may_hit(*args, tiles, pix)
        h = tr.pair_hits(*args, tiles, pix, per_warp=True)
        may, hit, bad = may + int(m.sum()), hit + int(h.sum()), bad + int((h & ~m).sum())
        work = [a + b for a, b in zip(work, tr.blend_work(*args, tiles, pix, keep=m))]
    torch.cuda.synchronize()
    kept = int(getattr(tr.rasterize_tiles, tr.KEPT_COUNTER[tr.form_of(st)]))
    log(f"{label} per-warp cull 1080p/1M: kept (warp, pair)s={kept} of tested pairs "
        f"{work[2]} x {tr.WARPS} warps (kept share {kept / (tr.WARPS * work[2]):.4f}); the "
        f"plain count over the steps each tile enters: {work[3]} (must be equal); kept "
        f"evaluations {work[4]} of {work[0]} ({work[4] / work[0]:.4f}), hits {work[1]}")
    check(kept == work[3], f"{label} kept {kept} (warp, pair)s, the plain count {work[3]}")
    log(f"  {label} per-warp cull audit on all {sum(b.numel() for b in batches)} tiles: {may} "
        f"(warp, pair)s kept, {hit} hit some pixel of the warp, culled ones that hit: {bad}")
    check(bad == 0, f"{label}: the cull dropped {bad} (warp, pair)s that hit")
    return work, kept


def bin_stage(proj, cfg, max_pairs=0):
    """render_3dgs's bin stage for either method and pair format: TileBins
    or BucketBins."""
    rows, ids = (gs_attr_rows_packed if packed(cfg) else gs_attr_rows)(proj)
    return bin_for_cfg(proj, rows, ids, cfg, max_pairs, raster_statics(cfg))


def bins_of(prepared, cam, cfg, max_pairs=0):
    return bin_stage(project_splats(prepared, cam, cfg), cfg, max_pairs)


def frame_stages(prepared, cam, cfg, max_pairs=0):
    """render_3dgs's stages as (name, step) pairs, each step reading what
    the one before it left in the returned dict: the blend's own inputs and
    outputs."""
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


def cell_file(*parts) -> dict:
    """A JSON file of the benchmark (splatbench/configs, splatbench/traffic):
    the smoke's scene and training start are the cells', so that what it
    checks is what they measure."""
    with open(os.path.join(HERE, "splatbench", *parts)) as f:
        return json.load(f)


def bench_scene(dev, n: int, seed: int, sh_degree: int = 3) -> gt.SplatSet:
    """The view cells' scene (``splatbench.scene.bench_scene`` at
    inria_bicycle_6m.json's extent and mix) with ``n`` splats, made on
    ``dev``."""
    spec = cell_file("configs", "inria_bicycle_6m.json")
    return gt.SplatSet(**cell_scene.bench_scene(dev, n, seed, sh_degree, spec["extent"],
                                                spec["mix"]))


def jitter(cam, i: int):
    """Per-frame camera nudge along x (1e-4 per frame)."""
    vm = cam.viewmat.clone()
    vm[0, 3] += i * 1e-4
    return dataclasses.replace(cam, viewmat=vm)


def full_size(dev, prepared):
    """The forward path at 1080p with 1M splats; returns K1's report entry
    and the SH and EWA forward kernels' launches in the main path."""
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    torch.cuda.synchronize()

    # ---- the main path: FRAMES frames through render(), launches counted
    tr.rasterize_tiles.launches = 0
    tsh.sh_radiance.launches = tsh.sh_radiance_bwd.launches = 0
    tproj.ewa_project.launches = tproj.ewa_project_bwd.launches = 0
    outs = [render(prepared, jitter(cam, i), cfg) for i in range(FRAMES)]
    torch.cuda.synchronize()
    launches = tr.rasterize_tiles.launches
    sh_launches = (tsh.sh_radiance.launches, tsh.sh_radiance_bwd.launches)
    ewa_launches = (tproj.ewa_project.launches, tproj.ewa_project_bwd.launches)
    log(f"main path: {FRAMES} frames, rasterize_fwd launches={launches} "
        f"sh_radiance_fwd launches={sh_launches[0]} sh_radiance_bwd launches={sh_launches[1]} "
        f"ewa_project_fwd launches={ewa_launches[0]} ewa_project_bwd launches={ewa_launches[1]}")
    check(launches == FRAMES, f"{launches} kernel launches for {FRAMES} frames")
    check(sh_launches == (FRAMES, 0), f"{sh_launches} SH kernel launches for {FRAMES} frames")
    check(ewa_launches == (FRAMES, 0), f"{ewa_launches} EWA kernel launches for {FRAMES} frames")
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
    # per-warp cull on this frame (K2's: the training frame)
    st = raster_statics(cfg)
    bins = bins_of(prepared, cam, cfg)
    n_tiles = st.tiles_x * st.tiles_y
    err, agree = compare_kernel_with_twin(bins, st)
    log(f"all {n_tiles} tiles: kernel_vs_twin_max_abs={err:.3e} id_agree={agree:.6f} "
        f"max_tile_pairs={int(bins.tile_count.max())}")
    check(err <= KERNEL_ATOL, f"1080p tiles kernel vs twin {err} > {KERNEL_ATOL}")
    check(agree >= ID_AGREE, f"1080p tiles id agreement {agree}")
    work, kept = check_warp_cull("K1", bins, st, twin_tiles(st, dev))
    return dict(launches=launches, max_abs_err=err, kept_share=kept / (tr.WARPS * work[2])), \
        {"sh_radiance_fwd": sh_launches[0], "ewa_project_fwd": ewa_launches[0]}


def grads_of(splats):
    return [getattr(splats, f).grad for f in FIELDS]


def jittered_start(truth: gt.SplatSet, dev, seed: int) -> gt.SplatSet:
    """Where training starts: the train cells' start
    (``splatbench.scene.jittered_start`` at train_3dgs.json's jitter)."""
    jit = cell_file("traffic", "train_3dgs.json")["jitter"]
    return gt.SplatSet(**cell_scene.jittered_start({f: getattr(truth, f) for f in FIELDS}, dev,
                                                   seed, jit["means"], jit["sh_dc"]))


def train_full_size(dev, truth: gt.SplatSet, seed: int):
    """The training path at 1080p with 1M splats: the scene renders its own
    target; training starts from the train cells' jittered start. Returns
    K2's report entry and the SH and EWA backward kernels' launches."""
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=dev)
    tc = gt.TrainConfig(scene_extent=4.0)
    with torch.no_grad():
        target = render(truth.prepare(), cam, cfg).image
    splats = jittered_start(truth, dev, seed)
    opt = gt.make_optimizer(splats, tc)
    torch.cuda.synchronize()

    # ---- the training path: TRAIN_STEPS steps, the four kernels' launches counted
    tr.rasterize_tiles.launches = tr.rasterize_tiles_bwd.launches = 0
    tsh.sh_radiance.launches = tsh.sh_radiance_bwd.launches = 0
    tproj.ewa_project.launches = tproj.ewa_project_bwd.launches = 0
    steps = [gt.train_step(splats, opt, cam, target, cfg, 0, tc) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = (tr.rasterize_tiles.launches, tr.rasterize_tiles_bwd.launches)
    sh_launches = (tsh.sh_radiance.launches, tsh.sh_radiance_bwd.launches)
    ewa_launches = (tproj.ewa_project.launches, tproj.ewa_project_bwd.launches)
    losses = [loss.item() for loss, _ in steps]
    log(f"training path: {TRAIN_STEPS} steps, rasterize_fwd launches={launches[0]} "
        f"rasterize_bwd launches={launches[1]} sh_radiance_fwd launches={sh_launches[0]} "
        f"sh_radiance_bwd launches={sh_launches[1]} ewa_project_fwd launches={ewa_launches[0]} "
        f"ewa_project_bwd launches={ewa_launches[1]}")
    log(f"train losses: {' '.join(f'{x:.6f}' for x in losses)} overflow="
        f"{[bool(o) for _, o in steps]} (slots truncates wide splats by design)")
    check(launches == (TRAIN_STEPS, TRAIN_STEPS),
          f"{launches} kernel launches for {TRAIN_STEPS} train steps")
    check(sh_launches == (TRAIN_STEPS, TRAIN_STEPS),
          f"{sh_launches} SH kernel launches for {TRAIN_STEPS} train steps")
    check(ewa_launches == (TRAIN_STEPS, TRAIN_STEPS),
          f"{ewa_launches} EWA kernel launches for {TRAIN_STEPS} train steps")
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
    # cotangent at the blend; its cull on this frame
    st = raster_statics(cfg)
    stages, c = frame_stages(splats.prepare(), cam, cfg)
    for _, step in stages:
        step()
    (g_out,) = torch.autograd.grad(gt.rgb_loss(c["image"], target, tc.ssim_lambda),
                                   c["out"][0])
    out = c["out"][0].detach()
    ctx = tr.bwd_context(out, g_out)
    bins = c["bins"]
    n_tiles = st.tiles_x * st.tiles_y
    abs_err, rel_err = compare_bwd_with_twin(bins, st, ctx)
    log(f"all {n_tiles} tiles: K2_vs_twin_max_abs={abs_err:.3e} "
        f"max_rel_to_row_max={rel_err:.3e}")
    check(rel_err <= BWD_RTOL, f"1080p frame K2 vs twin {rel_err} > {BWD_RTOL}")
    work, kept = check_pair_cull("K2", bins, st, twin_tiles(st, dev))
    return dict(launches=launches[1], max_abs_err=abs_err, kept_share=kept / work[2]), \
        {"sh_radiance_bwd": sh_launches[1], "ewa_project_bwd": ewa_launches[1]}


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


def check_cull(label: str, work, k3, k4, model: str, bins, st, caps, batches, pix=None,
               form: str | None = None) -> int:
    """The cull of K3 and K4 on a whole frame; returns the kept-lane count.
    Each kernel's kept-lane counter after one launch, ``k3()`` and ``k4(ctx)``
    (any cotangent: what the cull keeps reads the rows and the freeze
    alone; ``k4`` None for a packed, forward-only model), against the plain
    predicate's count (``work``, from ops/raster_bucket.bucket_work): equal,
    as K1's and K2's are (the predicate is in double with margins, and
    every card run of the counters has given the plain count); and the two
    counts equal, since both kernels run one predicate over the same steps
    and freeze.
    Then, over every tile in ``batches``, the lanes the plain predicate
    culls that the twin's alpha passes at some pixel of the tile
    (ops/raster_bucket.tile_lane_hits, frozen pixels too): none allowed.
    ``form``: the kernels' form whose kept counters to read (``model`` by
    default; the key-row form ``gs2d_keyrow``)."""
    n_tiles = st.tiles_x * st.tiles_y
    g = {"gs2d": "", "gut3d": "g", "gs2dp": "p", "gut3dp": "gp"}[model]
    form = form or model
    k3()
    kept = {f"K3{g}": int(getattr(rb.rasterize_buckets, rb.KEPT_COUNTER[form]))}
    if k4 is not None:
        k4(torch.ones((n_tiles, tr.CTX_ROWS, tr.PIX), device=bins.attrs.device))
        torch.cuda.synchronize()
        kept[f"K4{g}"] = int(getattr(rb.rasterize_buckets_bwd, rb.KEPT_COUNTER[form]))
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


def bucket_full_size(dev, prepared, seed: int):
    """The bucket frame at 1080p with 1M splats; returns (caps, K3's report
    entry)."""
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

    # ---- K3 against its twin over every tile of the frame; the cull of
    # both bucket kernels on it
    n_tiles = st.tiles_x * st.tiles_y
    err_all, agree_all = compare_k3_with_twin(bins, st, caps)
    log(f"bucket all {n_tiles} tiles: K3_vs_twin_max_abs={err_all:.3e} "
        f"id_agree={agree_all:.6f}")
    check(err_all <= KERNEL_ATOL, f"1080p frame K3 vs twin {err_all} > {KERNEL_ATOL}")
    check(agree_all >= ID_AGREE, f"1080p frame K3 id agreement {agree_all}")
    work = bucket_work(bins, st, caps)
    log(f"bucket work 1080p/1M: live_candidates={work.live} shared={work.shared} "
        f"per_tile={work.live / n_tiles:.1f} pixel_lane_evaluations={work.evals} "
        f"kept_lane_evaluations={work.kept_evals} hits={work.hits} "
        f"merge_comparisons={work.comparisons}")
    kept = check_cull("K3, K4", work, lambda: rb.rasterize_buckets(bins, st, caps),
                      lambda ctx: rb.rasterize_buckets_bwd(bins.attrs.detach(),
                                                           bins.bucket_starts, ctx, st, caps),
                      "gs2d", bins, st, caps, twin_tiles(st, dev))
    return caps, dict(launches=launches, max_abs_err=max(err, err_all),
                      kept_share=kept / work.live)


def bucket_train_full_size(dev, truth: gt.SplatSet, caps, seed: int):
    """The training path on the bucket path at 1080p with 1M splats, at the
    caps of the forward phase: the scene renders its own target; training
    starts from the train cells' jittered start."""
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
    return dict(launches=launches[1], max_abs_err=abs_err)


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
def gut_twin(c, cfg, tiles=None, seed=0):
    """The twin of the blend ``c`` ran (K1g's, K3g's, or a packed form's)
    over ``tiles`` (all by default), in batches (of TWIN_BATCH tiles
    without a pixel context, as the gs2d twins run); ``seed`` keys a
    stochastic blend."""
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    parts = []
    batches = twin_tiles if pix is None else tile_batches
    for t in batches(st, bins.attrs.device, tiles):
        if cfg.raster.method == "bucket":
            parts.append(rb.rasterize_buckets_ref(bins.attrs.detach(), bins.ids,
                                                  bins.bucket_starts, st, cfg.raster.bucket_caps,
                                                  tiles=t, pix_ctx=pix, seed=seed))
        else:
            parts.append(tr.rasterize_tiles_ref(bins.attrs.detach(), bins.pair_id,
                                                bins.tile_start, bins.tile_count, st, tiles=t,
                                                pix_ctx=pix, seed=seed))
    return torch.cat([o for o, _ in parts]), torch.cat([i for _, i in parts])


@torch.no_grad()
def gut_twin_bwd(c, cfg, ctx, tiles=None, seed=0):
    """K2g's or K4g's twin (or a gs2d form's: ``c`` without a pixel
    context) over ``tiles`` (all by default), in batches."""
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    total = 0
    for t in tile_batches(st, bins.attrs.device, tiles):
        if cfg.raster.method == "bucket":
            total = total + rb.rasterize_buckets_bwd_ref(
                bins.attrs.detach(), bins.bucket_starts, ctx, st, cfg.raster.bucket_caps,
                tiles=t, pix_ctx=pix, seed=seed)
        else:
            total = total + tr.rasterize_tiles_bwd_ref(
                bins.attrs.detach(), bins.tile_start, bins.tile_count, ctx, st, tiles=t,
                pix_ctx=pix, seed=seed)
    return total


def gut_kernel_bwd(c, cfg, ctx, seed=0):
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    if cfg.raster.method == "bucket":
        return rb.rasterize_buckets_bwd(bins.attrs.detach(), bins.bucket_starts, ctx, st,
                                        cfg.raster.bucket_caps, pix, seed)
    return tr.rasterize_tiles_bwd(bins.attrs.detach(), bins.tile_start, bins.tile_count, ctx,
                                  st, pix, seed)


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


def gut_pair_cull(label, c):
    """The kept share of K1g's per-warp cull at a pair frame, after the
    cull's checks (``check_warp_cull``)."""
    st, pix = c["st"], c["pix"]
    work, kept = check_warp_cull(f"{label} K1g", c["bins"], st, tile_batches(st, pix.device),
                                 pix)
    return kept / (tr.WARPS * work[2])


@torch.no_grad()
def gut_bucket_cull(c, cfg):
    """The kept share of K3g's and K4g's cull at a 3DGUT bucket frame, after
    the cull's checks (``check_cull``)."""
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    parts = [rb.bucket_work(bins.attrs.detach(), bins.bucket_starts, st, cfg.raster.bucket_caps,
                            tiles=t, pix_ctx=pix)
             for t in tile_batches(st, pix.device)]
    work = rb.BucketWork(*(sum(p[i] for p in parts) for i in range(len(parts[0]))))
    log(f"gut3d bucket work: live_candidates={work.live} shared={work.shared} "
        f"pixel_lane_evaluations={work.evals} kept_lane_evaluations={work.kept_evals} "
        f"hits={work.hits} merge_comparisons={work.comparisons}")
    caps = cfg.raster.bucket_caps
    kept = check_cull("K3g, K4g", work, lambda: rb.rasterize_buckets(bins, st, caps, pix),
                      lambda ctx: gut_kernel_bwd(c, cfg, ctx), "gut3d", bins, st, caps,
                      tile_batches(st, pix.device), pix)
    return kept / work.live


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


def gut_full_size(dev, prepared, caps, seed: int):
    """3DGUT and 3DGRT frames at 1080p with 1M splats on both paths, at the
    caps derived over both projections; returns K1g's and K3g's report
    entries."""
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    entries = {}
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
            if label != "3dgut" and method == "bucket":
                continue
            # ---- the kernel against its twin (K3g on 64 sampled tiles too)
            # and its cull; K1g on every tile of the 3DGUT and 3DGRT frames
            stages, c = gut_stages(prepared, cam, cfg)
            run_stages(stages)
            if method == "bucket":
                tiles = sample_bucket_tiles(c["bins"], c["st"], dev, seed)
                err = compare_gut_kernel(f"K3g vs twin on {tiles.numel()} sampled 1080p tiles",
                                         c, cfg, tiles)
                err = max(err, compare_gut_kernel("K3g vs twin on all 1080p tiles", c, cfg))
                kept_share = gut_bucket_cull(c, cfg)
            else:
                err = compare_gut_kernel(f"{label} K1g vs twin on all 1080p tiles", c, cfg)
                kept_share = gut_pair_cull(label, c)
            del stages, c
            if label != "3dgut":  # the 3DGRT pairs frame: K1g's gates and cull, no entry
                entries["rasterize_fwd_gut3d"]["max_abs_err"] = max(
                    entries["rasterize_fwd_gut3d"]["max_abs_err"], err)
                continue
            name = "raster_bucket_fwd_gut3d" if method == "bucket" else "rasterize_fwd_gut3d"
            entries[name] = dict(launches=launches[0], max_abs_err=err, kept_share=kept_share)
    return entries


def gut_train_full_size(dev, truth: gt.SplatSet, caps, seed: int):
    """3DGUT training at 1080p with 1M splats on both paths: the scene
    renders its own target; training starts from the train cells' jittered
    start. Returns K2g's and K4g's report entries."""
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    tc = gt.TrainConfig(scene_extent=4.0)
    entries = {}
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
        # K2g's cull on this frame
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
            st = c["st"]
            n_tiles = st.tiles_x * st.tiles_y
            abs_err, _ = compare_gut_bwd(f"K2g on all {n_tiles} 1080p tiles", c, cfg, ctx)
            work, kept = check_pair_cull("K2g", c["bins"], st, tile_batches(st, dev), c["pix"])
        del stages, c, ctx, g_out
        name = "raster_bucket_bwd_gut3d" if method == "bucket" else "rasterize_bwd_gut3d"
        entries[name] = dict(launches=launches[1], max_abs_err=abs_err)
        if method == "pairs":
            entries[name]["kept_share"] = kept / work[2]
        del splats, opt, target
    return entries


# ---- the packed tier (pair_format="packed"): K1p, K1gp, K3p, K3gp ----------

PACKED_FRAMES = (("3dgs", gt.Pipeline.MESH, "pairs"), ("3dgs", gt.Pipeline.MESH, "bucket"),
                 ("3dgut", gt.Pipeline.MESH_3DGUT, "pairs"),
                 ("3dgut", gt.Pipeline.MESH_3DGUT, "bucket"), ("3dgrt", gt.Pipeline.RTX, "pairs"))
PACKED_PSNR_DB, PACKED_ID_AGREE = 55.0, 0.99  # against f32 (tests/test_rasterize.py:178)
PACKED_GRT_FRAMES = FRAMES // 2  # 3DGRT at a smaller depth: the same kernel as 3DGUT pairs


def with_format(cfg, pair_format):
    return cfg.replace(raster=dataclasses.replace(cfg.raster, pair_format=pair_format))


def packed_name(method: str, model: str) -> str:
    return ("raster_bucket_fwd_" if method == "bucket" else "rasterize_fwd_") + model


def psnr_against(a: torch.Tensor, ref: torch.Tensor) -> float:
    """PSNR of ``a`` against ``ref`` with the peak max(ref.max(), 1), as the
    JAX package's packed test takes it."""
    mse = torch.mean((a - ref) ** 2).item()
    peak = max(ref.max().item(), 1.0)
    return 10 * math.log10(peak * peak / max(mse, 1e-12))


def frame_stages_of(prepared, cam, cfg):
    """The stages of ``cfg``'s pipeline, for one frame (one temporal sample)."""
    if cfg.pipeline == gt.Pipeline.MESH:
        stages, c = frame_stages(prepared, cam, cfg)
        c["st"], c["pix"] = raster_statics(cfg), None  # as gut_stages leaves them
        return stages, c
    return gut_stages(prepared, cam, cfg)


def blend_of(c, cfg):
    """A call of the blend ``c`` ran."""
    st, pix = blend_st(c, cfg), c["pix"]
    if cfg.raster.method == "bucket":
        return lambda: rb.rasterize_buckets(c["bins"], st, cfg.raster.bucket_caps, pix)
    return lambda: tr.rasterize_bins(c["bins"], st, pix)


def compare_packed_kernel(label, c, cfg, tiles=None):
    """A packed kernel (the blend ``c`` ran) against its twin on ``tiles``
    (all by default): gs2dp at KERNEL_ATOL with the same depth where the
    same splat was picked, gut3dp at the flip-aware gut3d gates; ids at
    ID_AGREE either way. Returns the max abs error."""
    out_k, id_k = c["out"]
    out_r, id_r = gut_twin(c, cfg, tiles)
    if tiles is not None:
        out_k, id_k = out_k[tiles], id_k[tiles]
    torch.cuda.synchronize()
    out_k = out_k.detach()
    if blend_st(c, cfg).model == "gut3dp":
        return gut_fwd_gate(label, out_k, id_k, out_r, id_r)
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item() if out_k.numel() else 0.0
    same = id_k == id_r
    agree = same.float().mean().item()
    log(f"  {label}: max abs {err:.3e} (gate {KERNEL_ATOL:g}), id agreement {agree:.6f}")
    check(torch.equal(out_k[:, 4][same], out_r[:, 4][same]),
          f"{label}: kernel and twin picked the same splat at different depths")
    check(err <= KERNEL_ATOL and agree >= ID_AGREE, f"{label} outside the gates: {err}, {agree}")
    return err


def packed_vs_f32(label, got, f32):
    """Packed frame against the f32 frame: PSNR > 55 dB, ids > 99 %."""
    psnr = psnr_against(got.image, f32.image)
    agree = (got.splat_id == f32.splat_id).float().mean().item()
    log(f"  {label} packed vs f32 frame: psnr_db={psnr:.3f} (gate {PACKED_PSNR_DB}) "
        f"id_agree={agree:.6f} (gate {PACKED_ID_AGREE}) max_abs="
        f"{(got.image - f32.image).abs().max().item():.4e}")
    check(psnr > PACKED_PSNR_DB and agree > PACKED_ID_AGREE,
          f"{label} packed vs f32: {psnr} dB, ids {agree}")
    return psnr


def golden_packed(dev):
    """The golden scene at 256x192 in the packed tier, 3DGS and 3DGUT on
    both paths at caps fitted to the frame: against the port's f32 frame
    (> 55 dB, ids > 99 %), the PSNR against golden_view0.npy beside the f32
    frame's, and each packed kernel against its twin over the frame.
    Returns {kernel name: max abs err}."""
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    prepared = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev).prepare()
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)
    base = gt.RenderConfig(width=w, height=h, sh_degree=0)
    caps, _ = fitted_caps(prepared, [cam], base)
    ref = torch.from_numpy(np.load(os.path.join(GOLDEN, "golden_view0.npy"))
                           .astype(np.float32)).to(dev)
    errs = {}
    for label, pipeline, method in PACKED_FRAMES[:4]:
        f32_cfg = gut_cfg(base, pipeline, method, caps)
        cfg = with_format(f32_cfg, "packed")
        got, f32 = render(prepared, cam, cfg), render(prepared, cam, f32_cfg)
        torch.cuda.synchronize()
        check(method == "pairs" or not bool(got.overflow), f"golden packed {label} overflowed")
        log(f"golden packed {label} {method} {w}x{h}: psnr_vs_golden_view0_db packed="
            f"{psnr_against(got.image.clamp(0, 1), ref):.3f} f32="
            f"{psnr_against(f32.image.clamp(0, 1), ref):.3f}")
        packed_vs_f32(f"golden {label} {method}", got, f32)
        stages, c = frame_stages_of(prepared, cam, cfg)
        run_stages(stages)
        name = packed_name(method, blend_st(c, cfg).model)
        errs[name] = compare_packed_kernel(f"golden {name} vs twin over the frame", c, cfg)
    return errs


def check_packed_rows(label, prepared, proj, cfg):
    """Packed rows made on the card bit-equal to those made on the CPU from
    the same f32 rows (``ops/response.pack_rows``: bf16 rounding to nearest
    even, the u16 round half to even)."""
    if cfg.pipeline == gt.Pipeline.MESH:
        model, rows = "gs2dp", gs_attr_rows(proj)[0].detach()
    else:
        model, rows = "gut3dp", gut_attr_rows(prepared, proj, cfg)[0].detach()
    words = [pack_rows(model, r).cpu().view(torch.int32) for r in (rows, rows.cpu())]
    high = words[1] & -65536
    subnormal = int(((high == 0) | (high == -2 ** 31)).sum())
    same = torch.equal(words[0], words[1])
    log(f"  {label} packed rows card vs CPU: {tuple(words[0].shape)} words bit-equal: {same} "
        f"(words with a +-0 high half: {subnormal})")
    check(same, f"{label}: packed rows made on the card differ from the CPU's")


def packed_full_size(dev, prepared, caps, seed: int):
    """The packed tier at 1080p with 1M splats, SH 3, at the headline caps:
    3DGS and 3DGUT on both paths, 3DGRT on the pair path. Per frame: the
    main path through ``render`` with every launch counter of the blend's
    wrapper zeroed before and read after (only the packed model's may
    move), finite frames, no bucket overflow, a bit-equal repeat, packed
    against f32 (> 55 dB, ids > 99 %), packed rows made on the card against
    the CPU's, the packed kernel against its twin (every tile; K3gp also on
    64 sampled tiles), its kept count against the plain predicate's and the
    audit of every tile for a culled (warp, pair) or lane that hits.
    Returns the report entries."""
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    entries = {}
    for label, pipeline, method in PACKED_FRAMES:
        f32_cfg = gut_cfg(base, pipeline, method, caps)
        cfg = with_format(f32_cfg, "packed")
        frames = PACKED_GRT_FRAMES if label == "3dgrt" else FRAMES
        fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
        model = "gs2dp" if pipeline == gt.Pipeline.MESH else "gut3dp"
        name = packed_name(method, model)
        torch.cuda.synchronize()
        # ---- the main path: frames through render(), every counter zeroed
        tr.zero_counters(fwd)
        outs = [render(prepared, jitter(cam, i), cfg) for i in range(frames)]
        torch.cuda.synchronize()
        launches = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
        log(f"packed {label} {method} main path: {frames} frames, launches {launches}")
        check(launches == {m: frames * (m == model) for m in launches},
              f"packed {label} {method}: launches {launches} for {frames} frames")
        for o in outs:
            check(tuple(o.image.shape) == (HEIGHT, WIDTH, 3), f"packed {label} image shape")
            check(bool(torch.isfinite(o.image).all()), f"non-finite packed {label} image")
            check(bool(((o.transmittance >= 0) & (o.transmittance <= 1)).all()),
                  f"packed {label} transmittance outside [0, 1]")
            check(method == "pairs" or not bool(o.overflow),
                  f"a packed {label} bucket frame overflowed at the headline caps")
        o0 = outs[0]
        del outs
        again = render(prepared, jitter(cam, 0), cfg)
        f32 = render(prepared, jitter(cam, 0), f32_cfg)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(getattr(again, f), getattr(o0, f))
                        for f in ("image", "transmittance", "depth", "splat_id"))
        log(f"packed {label} {method} frame: overflow={bool(o0.overflow)} num_pairs="
            f"{int(o0.num_pairs)} covered_frac={(o0.transmittance < 0.5).float().mean().item():.4f}"
            f" repeat bit-equal: {bit_equal}")
        check(bit_equal, f"repeat packed {label} {method} render differs")
        packed_vs_f32(f"1080p/1M {label} {method}", o0, f32)
        del again, f32, o0
        # ---- the kernel against its twin, its cull
        stages, c = frame_stages_of(prepared, cam, cfg)
        run_stages(stages)
        st, pix = blend_st(c, cfg), c["pix"]
        if method == "pairs" and label != "3dgrt":
            check_packed_rows(f"1080p/1M {label}", prepared, c["proj"], cfg)
        err = compare_packed_kernel(f"{name} vs twin on all 1080p {label} tiles", c, cfg)
        if method == "bucket":
            tiles = sample_bucket_tiles(c["bins"], st, dev, seed)
            err = max(err, compare_packed_kernel(f"{name} vs twin on {tiles.numel()} sampled "
                                                 "1080p tiles", c, cfg, tiles))
            parts = [rb.bucket_work(c["bins"].attrs.detach(), c["bins"].bucket_starts, st, caps,
                                    tiles=t, pix_ctx=pix) for t in tile_batches(st, dev)]
            work = rb.BucketWork(*(sum(p[i] for p in parts) for i in range(len(parts[0]))))
            kept = check_cull(f"packed {label}", work, blend_of(c, cfg), None, model,
                              c["bins"], st, caps, tile_batches(st, dev), pix)
            kept_share = kept / work.live
        else:
            blend_of(c, cfg)()  # the kept counter of a launch on this frame
            work, kept = check_warp_cull(f"packed {label} {name}", c["bins"], st,
                                         tile_batches(st, dev), pix)
            kept_share = kept / (tr.WARPS * work[2])
        del stages, c
        if label == "3dgrt":  # K1gp again, at 3DGRT's order and cutoffs: its gates, no entry
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
            continue
        entries[name] = dict(launches=launches[model], max_abs_err=err, kept_share=kept_share)
    return entries


# ---- stochastic transparency (cfg.stochastic SPLAT): the _stoch forms ------
#
# One binary-accept estimator for SPLAT and ANYHIT: each pair that passes
# the cutoffs is opaque where a hashed uniform of (key, pixel, lane) falls
# below its alpha (csrc/response.cuh hash_uniform, stochastic_accept). T is
# then exactly 0 or 1 per sample, and a pixel is one splat's colour. The
# gs2d and gs2dp forms round every alpha as their twins, so they must equal
# them bit for bit; a gut3d accept flips where the kernel and the twin round
# an alpha apart across its uniform, so >= 99.9 % of pixels bit-equal, the
# others counted. The backward forms give the colour rows K2's and K4's
# gates (gut3d: the flip-aware ones) and every other row exactly 0.

STOCH_FRAMES = (  # label, pipeline, method, pair format, temporal samples
    ("3dgs", gt.Pipeline.MESH, "pairs", "f32", 4), ("3dgs", gt.Pipeline.MESH, "bucket", "f32", 4),
    ("3dgut", gt.Pipeline.MESH_3DGUT, "pairs", "f32", 2),
    ("3dgut", gt.Pipeline.MESH_3DGUT, "bucket", "f32", 2),
    ("3dgrt", gt.Pipeline.RTX, "pairs", "f32", 2),
    ("3dgs", gt.Pipeline.MESH, "pairs", "packed", 1),
    ("3dgs", gt.Pipeline.MESH, "bucket", "packed", 1),
    ("3dgut", gt.Pipeline.MESH_3DGUT, "pairs", "packed", 1),
    ("3dgut", gt.Pipeline.MESH_3DGUT, "bucket", "packed", 1))
STOCH_TRAIN_STEPS = 3
STOCH_SEED = 1           # temporal sample 0's (render/pipelines.sample_seed)
STOCH_SPPS = (1, 4, 16)  # the convergence check's samples per pixel
COLOUR_ROWS = slice(tr.ATTR_R, tr.ATTR_B + 1)


def stoch_name(method: str, model: str, pass_: str = "fwd") -> str:
    base = ("raster_bucket_" if method == "bucket" else "rasterize_") + pass_
    return base + ("" if model == "gs2d" else "_" + model) + tr.STOCH


def stoch_cfg(cfg, samples: int = 1):
    return cfg.replace(stochastic=gt.StochasticMode.SPLAT, temporal_samples=samples)


def stoch_blend_inputs(prepared, cam, cfg):
    """(c, blend) of a stochastic frame: the stages up to the blend run
    (``c`` holds bins, the pair statics, the pixel context), and
    ``blend(seed)`` launches the frame's stochastic blend on them."""
    stages, c = frame_stages_of(prepared, cam, cfg)
    for name, step in stages:
        if name not in ("blend", "assemble"):
            step()
    check(c["st"].stochastic, "the statics of a stochastic frame are not stochastic")
    return c, lambda seed=STOCH_SEED: blend_bins(c["bins"], cfg, c["st"], c["pix"], seed)


@torch.no_grad()
def stoch_work(c, cfg, kernel: str):
    """The plain counts of ``kernel`` ("K1" .. "K4") over the stochastic
    sweep of STOCH_SEED on every tile: BucketWork for K3 and K4, else
    blend_work's (evaluations, hits, tested, kept, kept evaluations,
    draws) under K1's per-warp or K2's per-tile predicate."""
    bins, st, pix = c["bins"], blend_st(c, cfg), c["pix"]
    attrs = bins.attrs.detach()
    batches = tile_batches(st, attrs.device)
    if kernel in ("K3", "K4"):
        parts = [rb.bucket_work(attrs, bins.bucket_starts, st, cfg.raster.bucket_caps, tiles=t,
                                pix_ctx=pix, seed=STOCH_SEED) for t in batches]
        return rb.BucketWork(*(sum(p[i] for p in parts) for i in range(len(parts[0]))))
    args = (attrs, bins.tile_start, bins.tile_count, st)
    may = tr.pair_warp_may_hit if kernel == "K1" else tr.pair_may_hit
    work = [0] * 6
    for t in batches:
        keep = may(*args, t, pix)
        if kernel == "K2" and not model_of(st).cull_pairs:
            keep = torch.ones_like(keep)
        work = [a + b for a, b in zip(work, tr.blend_work(*args, t, pix, keep=keep,
                                                          seed=STOCH_SEED))]
    return work


def draw_counts(work) -> str:
    """A log fragment with a stochastic sweep's draws (kept evaluations
    whose alpha passes the cutoffs, where the kernels hash), kept
    evaluations and accepts (``stoch_work``'s counts)."""
    kept_evals, hits, draws = ((work.kept_evals, work.hits, work.draws)
                               if isinstance(work, rb.BucketWork) else (work[4], work[1], work[5]))
    return (f"draws={draws} of kept evaluations {kept_evals} "
            f"({draws / max(kept_evals, 1):.4f}), accepts={hits}")


def stoch_kept_gate(label, kept, plain, exact):
    """A stochastic form's kept counter against the plain count of the same
    sweep: equal where kernel and twin drew the same accepts; else (gut3d,
    flipped accepts) within 1 %, as a tile may stay live a step more or
    less."""
    log(f"  {label} kept={kept} plain count over the stochastic sweep={plain} "
        f"(gate: {'equal' if exact else 'within 1 %'})")
    check(kept == plain if exact else abs(kept - plain) <= 0.01 * plain,
          f"{label} kept {kept}, the plain count {plain}")


def stoch_frame(prepared, cam, base, caps, frame):
    """One stochastic headline frame: the main path through ``render`` with
    every launch counter of the blend's wrapper zeroed (only the stochastic
    form moves, once per temporal sample), finite, T a multiple of 1 /
    samples, no bucket overflow, a bit-equal repeat; then sample 0's blend
    against its twin on every tile and the kept counter. Returns (name,
    report entry)."""
    label, pipeline, method, fmt, samples = frame
    cfg = stoch_cfg(with_format(gut_cfg(base, pipeline, method, caps), fmt), samples)
    fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
    model = ("gs2d" if pipeline == gt.Pipeline.MESH else "gut3d") + ("p" if fmt == "packed"
                                                                      else "")
    name, form = stoch_name(method, model), model + tr.STOCH
    tag = f"stochastic {label} {method} {fmt}"
    torch.cuda.synchronize()
    tr.zero_counters(fwd)
    out = render(prepared, cam, cfg)
    torch.cuda.synchronize()
    launches = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
    log(f"{tag} main path: 1 frame of {samples} samples, launches "
        f"{ {m: n for m, n in launches.items() if n} }")
    check(launches == {m: samples * (m == form) for m in launches},
          f"{tag}: launches {launches} for {samples} samples")
    trans = out.transmittance
    check(tuple(out.image.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(out.image).all()),
          f"{tag}: image shape or values")
    check(torch.equal(trans * samples, torch.round(trans * samples)),
          f"{tag}: T is not a multiple of 1 / {samples}")
    check(method == "pairs" or not bool(out.overflow), f"{tag}: a bucket frame overflowed")
    again = render(prepared, cam, cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(again, f), getattr(out, f))
               for f in ("image", "transmittance", "depth", "splat_id"))
    log(f"{tag} frame: covered_frac={(trans < 0.5).float().mean().item():.4f} "
        f"T levels={torch.unique(trans).numel()} repeat bit-equal: {same}")
    check(same, f"{tag}: the repeat frame differs")
    del out, again

    c, blend = stoch_blend_inputs(prepared, cam, cfg)
    out_k, id_k = blend()
    torch.cuda.synchronize()
    kept = int(getattr(fwd, tr.KEPT_COUNTER[form]))
    out_r, id_r = gut_twin(c, cfg, seed=STOCH_SEED)
    out_k = out_k.detach()
    same_px = (out_k == out_r).all(dim=1) & (id_k == id_r)
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item()
    levels = set(out_k[:, 3].unique().tolist())
    log(f"  {name} vs twin on all {same_px.numel() // tr.PIX} tiles (seed {STOCH_SEED}): "
        f"pixels bit-equal {same_px.float().mean().item():.6f} ({int((~same_px).sum())} "
        f"differ), max abs {err:.3e}, T values {sorted(levels)}")
    check(levels <= {0.0, 1.0}, f"{name}: T is not 0 or 1 in one sample")
    if model in ("gs2d", "gs2dp"):
        check(torch.equal(out_k, out_r) and torch.equal(id_k, id_r),
              f"{name} differs from its twin")
    else:
        check(same_px.float().mean().item() >= ID_AGREE, f"{name}: too many flipped pixels")
    kernel = "K3" if method == "bucket" else "K1"
    work = stoch_work(c, cfg, kernel)
    stoch_kept_gate(name, kept, work.kept if kernel == "K3" else work[3], bool(same_px.all()))
    log(f"  {name} stochastic sweep: {draw_counts(work)}")
    return name, dict(launches=launches[form], max_abs_err=err)


def stoch_train(dev, truth, base, caps, label, pipeline, method):
    """STOCH_TRAIN_STEPS stochastic train steps (one sample each) at 1080p:
    the launches of both wrappers' forms counted (only the stochastic ones
    move, once a step), finite losses, only colour-path gradients
    (opacities, scales and quaternions exactly 0); then the backward form
    against its twin with the loss's own cotangent at sample 0's blend on
    every tile and its kept counter. Returns (name, report entry)."""
    det = gut_cfg(base, pipeline, method, caps)
    cfg = stoch_cfg(det)
    model = "gs2d" if pipeline == gt.Pipeline.MESH else "gut3d"
    name, form = stoch_name(method, model, "bwd"), model + tr.STOCH
    fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
    bwd = rb.rasterize_buckets_bwd if method == "bucket" else tr.rasterize_tiles_bwd
    tag = f"stochastic {label} {method}"
    tc = gt.TrainConfig(scene_extent=4.0)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    with torch.no_grad():
        target = render(truth.prepare(), cam, det).image
    splats = jittered_start(truth, dev, 0)
    opt = gt.make_optimizer(splats, tc)
    torch.cuda.synchronize()
    tr.zero_counters(fwd)
    tr.zero_counters(bwd, tr.TRAINED)
    steps = [gt.train_step(splats, opt, cam, target, cfg, 0, tc)
             for _ in range(STOCH_TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = {w: {m: getattr(wr, tr.LAUNCH_COUNTER[m]) for m in counters}
                for w, wr, counters in (("fwd", fwd, tr.LAUNCH_COUNTER),
                                        ("bwd", bwd, ("gs2d", "gut3d", "gs2d_stoch",
                                                      "gut3d_stoch")))}
    losses = [loss.item() for loss, _ in steps]
    zero = {f: bool((getattr(splats, f).grad == 0).all()) for f in ("opacities", "scales", "quats")}
    log(f"{tag} training path: {STOCH_TRAIN_STEPS} steps, launches "
        f"{ {w: {m: n for m, n in d.items() if n} for w, d in launches.items()} }; losses "
        f"{' '.join(f'{x:.6f}' for x in losses)}; zero gradients {zero}")
    for w, d in launches.items():
        check(d == {m: STOCH_TRAIN_STEPS * (m == form) for m in d},
              f"{tag}: {w} launches {d} in {STOCH_TRAIN_STEPS} steps")
    check(all(math.isfinite(x) for x in losses), f"{tag}: non-finite loss")
    check(all(bool(torch.isfinite(x).all()) for x in grads_of(splats)),
          f"{tag}: non-finite gradient")
    check(all(zero.values()), f"{tag}: a gradient through alpha is not 0: {zero}")
    check(splats.sh_dc.grad.abs().max().item() > 0, f"{tag}: no colour gradient")

    c, blend = stoch_blend_inputs(splats.prepare(), cam, cfg)
    st = blend_st(c, cfg)
    out = blend()
    image = tr.assemble_image(*out, st.tiles_x, st.tiles_y, WIDTH, HEIGHT, cfg.background)[0]
    (g_out,) = torch.autograd.grad(gt.rgb_loss(image, target, tc.ssim_lambda), out[0])
    ctx = tr.bwd_context(out[0].detach(), g_out)
    del out, image, g_out
    d_k = gut_kernel_bwd(c, cfg, ctx, STOCH_SEED)
    torch.cuda.synchronize()
    kept = int(getattr(bwd, tr.KEPT_COUNTER[form]))
    d_r = gut_twin_bwd(c, cfg, ctx, seed=STOCH_SEED)
    cols = ((d_k != 0) | (d_r != 0)).any(dim=0)
    grad_rows = MODELS[model].grad_rows
    other = [r for r in range(d_k.shape[0]) if not COLOUR_ROWS.start <= r < COLOUR_ROWS.stop]
    check(bool((d_k[other] == 0).all()) and bool((d_r[other] == 0).all()),
          f"{name}: a row other than the colour rows is not 0")
    rtol = BWD_RTOL if model == "gs2d" else GUT_BWD_RTOL
    ok, abs_err, rel, share, p999 = bwd_gate(d_k[COLOUR_ROWS][:, cols], d_r[COLOUR_ROWS][:, cols],
                                             rtol)
    log(f"  {name} vs twin on {int(cols.sum())} columns of all tiles (seed {STOCH_SEED}): "
        f"colour rows "
        f"max err / row max {rel:.3e} (gate {rtol:g}), least share within {BWD_ELEM_RTOL:g} "
        f"{share:.6f} (gate {BWD_ELEM_SHARE}), p99.9 " + " ".join(f"{x:.2e}" for x in p999)
        + f"; the other {grad_rows - 3} gradient rows and the depth row exactly 0 in both")
    check(ok, f"{name} vs twin outside the gates: {rel} / {share}")
    kernel = "K4" if method == "bucket" else "K2"
    work = stoch_work(c, cfg, kernel)
    stoch_kept_gate(name, kept, work.kept if kernel == "K4" else work[3], model == "gs2d")
    log(f"  {name} stochastic sweep: {draw_counts(work)}")
    return name, dict(launches=launches["bwd"][form], max_abs_err=abs_err)


def stoch_convergence(dev, prepared, base):
    """3DGS pairs at 1080p: the PSNR of the stochastic frame against the
    deterministic one must rise from 1 to 4 to 16 samples per pixel; the
    a-trous pass at 4 samples through ``render`` equals ``denoise_output``
    of the undenoised frame bit for bit and is finite."""
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    with torch.no_grad():
        ref = render(prepared, cam, base).image.clamp(0, 1)
        psnr = [psnr_against(render(prepared, cam, stoch_cfg(base, spp)).image.clamp(0, 1), ref)
                for spp in STOCH_SPPS]
        cfg4 = stoch_cfg(base, 4)
        raw = render(prepared, cam, cfg4)
        den = render(prepared, cam, cfg4.replace(denoise="atrous")).image
        again = denoise_output(raw)
        torch.cuda.synchronize()
    log(f"stochastic convergence 1080p/1M 3dgs pairs: psnr_db vs the deterministic frame at "
        + " ".join(f"{spp} spp={p:.3f}" for spp, p in zip(STOCH_SPPS, psnr))
        + f"; atrous at 4 spp {psnr_against(den.clamp(0, 1), ref):.3f} (undenoised "
        f"{psnr[1]:.3f})")
    check(all(a < b for a, b in zip(psnr, psnr[1:])), f"PSNR does not rise with samples: {psnr}")
    check(bool(torch.isfinite(den).all()) and tuple(den.shape) == (HEIGHT, WIDTH, 3),
          "the a-trous frame's shape or values")
    check(torch.equal(den, again), "render's a-trous frame differs from denoise_output's")


def stochastic(dev, truth: gt.SplatSet, caps):
    """Phase 8: stochastic transparency at 1080p with 1M splats, SH 3, at
    the headline caps. Returns the report entries."""
    t0 = time.perf_counter()
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    prepared = truth.prepare()
    entries = {}
    for frame in STOCH_FRAMES:
        name, entry = stoch_frame(prepared, cam, base, caps, frame)
        if name in entries:  # K1gs again on the 3DGRT frame: its gates, no entry
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"],
                                               entry["max_abs_err"])
            continue
        entries[name] = entry
    for label, pipeline in (("3dgs", gt.Pipeline.MESH), ("3dgut", gt.Pipeline.MESH_3DGUT)):
        for method in ("pairs", "bucket"):
            name, entries[name] = stoch_train(dev, truth, base, caps, label, pipeline, method)
    stoch_convergence(dev, prepared, base)
    log(f"stochastic phase {time.perf_counter() - t0:.1f} s")
    return entries


# ---- the host-sorted path (SortMethod.HOST) and the IO: K3 and K4 _keyrow ---
#
# render_3dgs(host_order=...) blends in an order sorted on the host
# (io/async_loader.AsyncHostSorter: view-plane distances in f32, the native
# radix sort of native/fast_splats.cpp). On the bucket path with f32 rows
# the order's rank rides as the key row (ops/response.GS_KEY) on which the
# key-row forms of K3 and K4 merge. Their gates are K3's and K4's (the
# stochastic forward bit for bit); the key row's gradient is exactly 0; the
# kept counts are exact. The host keys dot(mean, view_dir) and the device
# view z, equal up to f32 rounding, so a fresh order may swap splats whose
# depths tie: against the device-sorted frame a share of pixels
# (BUCKET_VS_PAIR_*), the max and the PSNR.

KEYROW_FORM, STOCH_KEYROW_FORM = "gs2d" + tr.KEYROW, "gs2d" + tr.STOCH + tr.KEYROW
KEYROW_FWD, KEYROW_BWD = "raster_bucket_fwd" + tr.KEYROW, "raster_bucket_bwd" + tr.KEYROW
HOST_TRAIN_STEPS = 3
HOST_SAMPLES = 2           # the stochastic host-sorted frame's temporal samples
HOST_REVERSED_MIN = 1e-3   # a reversed order must move the frame by more


def view_dir(cam) -> np.ndarray:
    """The camera's forward row: the host sorter's plane normal."""
    return cam.viewmat[2, :3].detach().cpu().numpy().astype(np.float64)


def host_order(sorter, cam):
    """The order (numpy int32) of one sort for ``cam``, from the request to
    its consume."""
    sorter.sort_async(view_dir(cam))
    while (res := sorter.consume()) is None:
        time.sleep(2e-4)
    return res[0]


def counts(wrapper) -> dict:
    """Every launch counter the wrapper keeps (a backward's: the trained models')."""
    return {m: getattr(wrapper, name) for m, name in tr.LAUNCH_COUNTER.items()
            if hasattr(wrapper, name)}


def only(label: str, wrapper, form: str, n: int) -> dict:
    """Fail unless ``wrapper``'s launch counters show ``n`` launches of
    ``form`` and none of another form; returns the nonzero counts."""
    got = counts(wrapper)
    check(got == {m: n * (m == form) for m in got}, f"{label}: launches {got}")
    return {m: k for m, k in got.items() if k}


def host_stages(prepared, cam, cfg, order, seed: int = 0):
    """render_3dgs's stages of a host-sorted bucket frame with f32 rows, as
    ``frame_stages``: project; bin (the rank, appended as the key row, and
    the bucket bins sorted by it); blend (the key-row form); assemble.
    ``c["st"]`` holds the key-row statics (``blend_st`` adds the bucket
    chunk)."""
    c = {"st": dataclasses.replace(raster_statics(cfg), key_is_row=True), "pix": None}
    st = blend_st(c, cfg)

    def project():
        c["proj"] = project_splats(prepared, cam, cfg)

    def bin_():
        rows, ids = gs_attr_rows(c["proj"])
        rank = host_rank(order, rows.shape[1], rows.device)
        c["bins"] = bin_for_cfg(c["proj"], torch.cat([rows, rank[None]]), ids, cfg, 0, c["st"],
                                sort_depth=rank)

    def blend():
        c["out"] = rb.rasterize_buckets(c["bins"], st, cfg.raster.bucket_caps, None, seed)

    def assemble():
        c["image"] = tr.assemble_image(*c["out"], st.tiles_x, st.tiles_y, cfg.width,
                                       cfg.height, cfg.background)[0]

    return [("project", project), ("bin", bin_), ("blend", blend), ("assemble", assemble)], c


def agreement(label: str, got, ref) -> float:
    """Log and gate a host-sorted frame against a device-sorted one: the
    share of pixels within BUCKET_VS_PAIR_ATOL, the max and the PSNR; ids
    on ID_AGREE of the pixels, and the picked depth (the model's, not the
    rank) equal where the ids are. Returns the share."""
    diff = (got.image - ref.image).abs().amax(dim=-1)
    share = (diff <= BUCKET_VS_PAIR_ATOL).float().mean().item()
    same = got.splat_id == ref.splat_id
    agree = same.float().mean().item()
    log(f"  {label}: share of pixels within {BUCKET_VS_PAIR_ATOL:g} {share:.6f} (gate "
        f"{BUCKET_VS_PAIR_SHARE}), max abs {diff.max().item():.4e}, psnr_db "
        f"{psnr_against(got.image, ref.image):.3f}, id agreement {agree:.6f}")
    check(share >= BUCKET_VS_PAIR_SHARE and agree >= ID_AGREE, f"{label}: {share}, {agree}")
    check(torch.equal(got.depth[same], ref.depth[same]),
          f"{label}: the same splat picked at another depth")
    return share


def host_sort_checks(truth, cam):
    """The native library and the sorter at 1 M splats: the library built;
    its radix sort of the plane distances equal to numpy's stable argsort,
    and the sorter's order equal to it. Returns the sorter."""
    check(native.available(), "the native library did not build")
    log(f"native library: build/native/{native.library_path().name}")
    means = truth.means.detach()
    dist = means.cpu().numpy() @ view_dir(cam).astype(np.float32)
    radix = native.radix_argsort_f32(dist)
    check(np.array_equal(radix, np.argsort(dist, kind="stable")),
          "the radix sort differs from numpy's stable argsort")
    sorter = AsyncHostSorter(means)
    check(np.array_equal(host_order(sorter, cam), radix),
          "the sorter's order differs from the radix sort's")
    log(f"host sort 1M: radix equal to the stable argsort on {dist.size} distances "
        f"({int((dist == 0).sum())} zeros), the sorter's order equal to it")
    return sorter


def keyrow_forward(dev, prepared, cam, base, caps, sorter):
    """K3's key-row form at the headline cell: FRAMES jittered frames through
    ``render(..., host_order=)``, each with its own sort; only
    ``launches_keyrow`` moves, once a frame; no overflow; a bit-equal
    repeat; against the device-sorted bucket frame; a reversed order; K3
    _keyrow against its twin on every tile; the kept counters of K3 and K4
    _keyrow against ``tile_may_hit`` over the key-row merge and the audit.
    Then the pair path and the packed bucket config with a host order.
    Returns (K3 _keyrow's entry, frame 0's order)."""
    bcfg = bucket_cfg(base, caps)
    tr.zero_counters(rb.rasterize_buckets)
    outs, orders = [], []
    for i in range(FRAMES):
        orders.append(host_order(sorter, jitter(cam, i)))
        outs.append(render(prepared, jitter(cam, i), bcfg, host_order=orders[-1]))
    torch.cuda.synchronize()
    seen = only("host-sorted bucket main path", rb.rasterize_buckets, KEYROW_FORM, FRAMES)
    log(f"host-sorted bucket main path: {FRAMES} frames, each sorted on the host, "
        f"launches {seen}")
    for o in outs:
        check(tuple(o.image.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(o.image).all()),
              "host-sorted frame: image shape or values")
        check(not bool(o.overflow), "a host-sorted bucket frame overflowed at the headline caps")
    o0, order0 = outs[0], orders[0]
    del outs
    again = render(prepared, jitter(cam, 0), bcfg, host_order=order0)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(again, f), getattr(o0, f))
               for f in ("image", "transmittance", "depth", "splat_id"))
    log(f"host-sorted bucket frame: covered_frac={(o0.transmittance < 0.5).float().mean():.4f} "
        f"repeat bit-equal: {same}")
    check(same, "the repeat host-sorted frame differs")
    agreement("host-sorted bucket vs device-sorted bucket frame", o0,
              render(prepared, jitter(cam, 0), bcfg))
    rev = render(prepared, jitter(cam, 0), bcfg, host_order=order0[::-1].copy())
    moved = (rev.image - o0.image).abs().max().item()
    log(f"  reversed host order: max abs change {moved:.4e} (gate > {HOST_REVERSED_MIN:g})")
    check(moved > HOST_REVERSED_MIN, "a reversed host order left the frame unchanged")
    del again, rev

    # ---- K3 _keyrow against its twin on every tile; both kernels' culls
    stages, c = host_stages(prepared, cam, bcfg, order0)
    run_stages(stages[:2])
    bins, st = c["bins"], blend_st(c, bcfg)
    err, agree = compare_k3_with_twin(bins, st, caps)
    log(f"host-sorted bucket all {st.tiles_x * st.tiles_y} tiles: "
        f"K3_keyrow_vs_twin_max_abs={err:.3e} id_agree={agree:.6f}")
    check(err <= KERNEL_ATOL and agree >= ID_AGREE, f"K3 _keyrow vs twin: {err}, {agree}")
    work = bucket_work(bins, st, caps)
    kept = check_cull("K3 _keyrow, K4 _keyrow", work, lambda: rb.rasterize_buckets(bins, st, caps),
                      lambda ctx: rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx,
                                                           st, caps),
                      "gs2d", bins, st, caps, twin_tiles(st, dev), form=KEYROW_FORM)
    entry = dict(launches=seen[KEYROW_FORM], max_abs_err=err, kept_share=kept / work.live)
    del bins, c, stages

    # ---- the pair path, and packed rows on the bucket config, with the order
    tr.zero_counters(tr.rasterize_tiles)
    pair = render(prepared, cam, base, host_order=order0)
    torch.cuda.synchronize()
    log(f"host-sorted pair path: launches {only('host-sorted pairs', tr.rasterize_tiles, 'gs2d', 1)}")
    agreement("host-sorted pairs vs device-sorted pair frame", pair, render(prepared, cam, base))
    packed_bucket = with_format(bcfg, "packed")
    tr.zero_counters(tr.rasterize_tiles)
    tr.zero_counters(rb.rasterize_buckets)
    got = render(prepared, cam, packed_bucket, host_order=order0)
    torch.cuda.synchronize()
    k1p = only("packed bucket with a host order", tr.rasterize_tiles, "gs2dp", 1)
    only("packed bucket with a host order (K3)", rb.rasterize_buckets, "gs2dp", 0)
    want = render(prepared, cam, with_format(base, "packed"), host_order=order0)
    same = all(torch.equal(getattr(got, f), getattr(want, f))
               for f in ("image", "transmittance", "depth", "splat_id"))
    log(f"host-sorted packed, method=bucket: K1 launches {k1p}, K3 none; equal to the packed "
        f"pair frame: {same}")
    check(same, "the packed bucket host-sorted frame is not the packed pair frame")
    return entry, order0


def keyrow_backward(dev, truth, cam, base, caps):
    """K4's key-row form: HOST_TRAIN_STEPS fwd_bwd (render with the host
    order, rgb_loss, backward) from the jittered start, the order sorted
    for its means; only the key-row forms of K3 and K4 move, once a step;
    finite; a bit-equal repeat. K4 _keyrow against its twin with the loss's
    own cotangent on every tile and on 64 sampled tiles (``bwd_gate``) and
    the key row's gradient exactly 0. Returns its entry."""
    cfg = bucket_cfg(base, caps)
    tc = gt.TrainConfig(scene_extent=4.0)
    with torch.no_grad():
        target = render(truth.prepare(), cam, cfg).image
    splats = jittered_start(truth, dev, 0)
    order = host_order(AsyncHostSorter(splats.means), cam)

    def fwd_bwd():
        for f in FIELDS:
            getattr(splats, f).grad = None
        out = render(splats.prepare(), cam, cfg, host_order=order)
        loss = gt.rgb_loss(out.image, target, tc.ssim_lambda)
        loss.backward()
        return loss

    for f in FIELDS:
        getattr(splats, f).requires_grad_()
    torch.cuda.synchronize()
    tr.zero_counters(rb.rasterize_buckets)
    tr.zero_counters(rb.rasterize_buckets_bwd, tr.TRAINED)
    losses = [fwd_bwd().item() for _ in range(HOST_TRAIN_STEPS)]
    first = [g.clone() for g in grads_of(splats)]
    seen = {w: only(f"host-sorted training ({w})", wr, KEYROW_FORM, HOST_TRAIN_STEPS)
            for w, wr in (("fwd", rb.rasterize_buckets), ("bwd", rb.rasterize_buckets_bwd))}
    fwd_bwd()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, grads_of(splats)))
    log(f"host-sorted bucket training path: {HOST_TRAIN_STEPS} fwd_bwd, launches {seen}; "
        f"losses {' '.join(f'{x:.6f}' for x in losses)}; repeat backward bit-equal: {same}")
    check(all(math.isfinite(x) for x in losses), "non-finite host-sorted loss")
    check(all(bool(torch.isfinite(g).all()) for g in first), "non-finite host-sorted gradient")
    check(same, "the repeat host-sorted backward differs")
    del first

    stages, c = host_stages(splats.prepare(), cam, cfg, order)
    run_stages(stages)
    bins, st = c["bins"], blend_st(c, cfg)
    (g_out,) = torch.autograd.grad(gt.rgb_loss(c["image"], target, tc.ssim_lambda),
                                   c["out"][0])
    ctx = tr.bwd_context(c["out"][0].detach(), g_out)
    del c, stages, g_out
    d_k = rb.rasterize_buckets_bwd(bins.attrs.detach(), bins.bucket_starts, ctx, st, caps)
    torch.cuda.synchronize()
    key_zero = bool((d_k[GS_KEY] == 0).all())
    log(f"  K4 _keyrow d_attrs: {tuple(d_k.shape)}, the key row (row {GS_KEY}) exactly 0: "
        f"{key_zero}")
    check(d_k.shape[0] == GS_KEY + 1 and key_zero, "K4 _keyrow wrote the key row")
    del d_k
    abs_all, rel_all = compare_k4_with_twin(bins, st, caps, ctx)
    tiles = sample_bucket_tiles(bins, st, dev, 0)
    abs_s, rel_s = compare_k4_with_twin(bins, st, caps, ctx, tiles=tiles)
    log(f"host-sorted K4 _keyrow vs twin: every tile max_abs={abs_all:.3e} "
        f"max_rel_to_row_max={rel_all:.3e}; {tiles.numel()} sampled tiles max_abs={abs_s:.3e} "
        f"max_rel_to_row_max={rel_s:.3e}")
    return dict(launches=seen["bwd"][KEYROW_FORM], max_abs_err=max(abs_all, abs_s))


def keyrow_stochastic(dev, truth, cam, base, caps, order0):
    """The stochastic key-row forms: a HOST_SAMPLES-sample host-sorted
    bucket frame (only ``launches_stoch_keyrow`` moves, once a sample; T a
    multiple of 1 / samples; a bit-equal repeat), sample 0's blend equal to
    its twin bit for bit on every tile and its kept counter; one stochastic
    fwd_bwd with a host order (K4 _stoch_keyrow once), its backward form
    against its twin with the loss's cotangent on every tile (colour rows
    at K4's gates, every other row and the key row exactly 0) and its kept
    counter. Returns {name: entry}."""
    prepared = truth.prepare()
    cfg = stoch_cfg(bucket_cfg(base, caps), HOST_SAMPLES)
    fwd_name, bwd_name = (name + tr.STOCH + tr.KEYROW
                          for name in ("raster_bucket_fwd", "raster_bucket_bwd"))
    tr.zero_counters(rb.rasterize_buckets)
    out = render(prepared, cam, cfg, host_order=order0)
    torch.cuda.synchronize()
    seen = only("stochastic host-sorted frame", rb.rasterize_buckets, STOCH_KEYROW_FORM,
                HOST_SAMPLES)
    again = render(prepared, cam, cfg, host_order=order0)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(again, f), getattr(out, f))
               for f in ("image", "transmittance", "depth", "splat_id"))
    trans = out.transmittance
    log(f"stochastic host-sorted bucket frame ({HOST_SAMPLES} samples): launches {seen}, "
        f"T levels {torch.unique(trans).numel()}, repeat bit-equal: {same}")
    check(torch.equal(trans * HOST_SAMPLES, torch.round(trans * HOST_SAMPLES)),
          "stochastic host-sorted frame: T not a multiple of 1 / samples")
    check(not bool(out.overflow) and same, "stochastic host-sorted frame: overflow or repeat")
    del out, again

    entries = {}
    stages, c = host_stages(prepared, cam, cfg, order0, STOCH_SEED)
    run_stages(stages[:3])
    out_k, id_k = c["out"]
    torch.cuda.synchronize()
    kept = int(getattr(rb.rasterize_buckets, tr.KEPT_COUNTER[STOCH_KEYROW_FORM]))
    out_r, id_r = gut_twin(c, cfg, seed=STOCH_SEED)
    check(torch.equal(out_k, out_r) and torch.equal(id_k, id_r),
          f"{fwd_name} differs from its twin")
    work = stoch_work(c, cfg, "K3")
    log(f"  {fwd_name} vs twin on all {out_k.shape[0]} tiles (seed {STOCH_SEED}): bit-equal")
    stoch_kept_gate(fwd_name, kept, work.kept, True)
    log(f"  {fwd_name} stochastic sweep: {draw_counts(work)}")
    entries[fwd_name] = dict(launches=seen[STOCH_KEYROW_FORM], max_abs_err=0.0)
    del c, stages, out_k, out_r

    # ---- the backward form: one stochastic fwd_bwd with a host order
    tcfg = gt.TrainConfig(scene_extent=4.0)
    one = stoch_cfg(bucket_cfg(base, caps))
    with torch.no_grad():
        target = render(prepared, cam, bucket_cfg(base, caps)).image
    splats = jittered_start(truth, dev, 0)
    order = host_order(AsyncHostSorter(splats.means), cam)
    for f in FIELDS:
        getattr(splats, f).requires_grad_()
    tr.zero_counters(rb.rasterize_buckets_bwd, tr.TRAINED)
    loss = gt.rgb_loss(render(splats.prepare(), cam, one, host_order=order).image, target,
                       tcfg.ssim_lambda)
    loss.backward()
    torch.cuda.synchronize()
    seen_bwd = only("stochastic host-sorted fwd_bwd", rb.rasterize_buckets_bwd,
                    STOCH_KEYROW_FORM, 1)
    zero = {f: bool((getattr(splats, f).grad == 0).all()) for f in ("opacities", "scales", "quats")}
    log(f"stochastic host-sorted fwd_bwd: loss {loss.item():.6f}, K4 launches {seen_bwd}, zero "
        f"gradients {zero}")
    check(math.isfinite(loss.item()) and all(zero.values()),
          "stochastic host-sorted fwd_bwd: a non-finite loss or a gradient through alpha")
    stages, c = host_stages(splats.prepare(), cam, one, order, STOCH_SEED)
    run_stages(stages)
    (g_out,) = torch.autograd.grad(gt.rgb_loss(c["image"], target, tcfg.ssim_lambda),
                                   c["out"][0])
    ctx = tr.bwd_context(c["out"][0].detach(), g_out)
    d_k = gut_kernel_bwd(c, one, ctx, STOCH_SEED)
    torch.cuda.synchronize()
    kept = int(getattr(rb.rasterize_buckets_bwd, tr.KEPT_COUNTER[STOCH_KEYROW_FORM]))
    d_r = gut_twin_bwd(c, one, ctx, seed=STOCH_SEED)
    other = [r for r in range(d_k.shape[0]) if not COLOUR_ROWS.start <= r < COLOUR_ROWS.stop]
    check(bool((d_k[other] == 0).all()) and bool((d_r[other] == 0).all()),
          f"{bwd_name}: a row other than the colour rows (the key row included) is not 0")
    cols = ((d_k != 0) | (d_r != 0)).any(dim=0)
    ok, abs_err, rel, share, _ = bwd_gate(d_k[COLOUR_ROWS][:, cols], d_r[COLOUR_ROWS][:, cols])
    log(f"  {bwd_name} vs twin on {int(cols.sum())} columns of all tiles: colour rows max err "
        f"/ row max {rel:.3e} (gate {BWD_RTOL:g}), least share {share:.6f}; every other row "
        f"and the key row exactly 0 in both")
    check(ok, f"{bwd_name} vs twin outside the gates: {rel} / {share}")
    work = stoch_work(c, one, "K4")
    stoch_kept_gate(bwd_name, kept, work.kept, True)
    log(f"  {bwd_name} stochastic sweep: {draw_counts(work)}")
    entries[bwd_name] = dict(launches=seen_bwd[STOCH_KEYROW_FORM], max_abs_err=abs_err)
    return entries


def io_within(label: str, got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    err = (got - want).abs().max().item() if got.numel() else 0.0
    check(err <= atol, f"{label}: {err} > {atol}")
    return err


def sign_canonical(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions with the largest component positive (spz's storage)."""
    q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    big = q.gather(1, q.abs().argmax(dim=1, keepdim=True))
    return q * torch.where(big < 0, -1.0, 1.0)


def io_phase(dev, truth):
    """The 1 M scene through save_ply -> load_ply (the native extractor),
    save_spz -> load_spz and save_splat_file -> load_splat_file, each read
    by ``load_scene``, in a temporary directory: the PLY exact; spz and
    .splat within their quantisation (IO_TOL's reasons), values outside a
    format's range compared at its clamp."""
    with torch.no_grad():
        t = {f: getattr(truth, f).detach() for f in FIELDS}
        alpha = torch.sigmoid(t["opacities"])
        unit = t["quats"] / t["quats"].norm(dim=1, keepdim=True).clamp_min(1e-12)
    check(tply._groups_contiguous(["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2"]
                                  + [f"f_rest_{i}" for i in range(45)] + ["opacity"]
                                  + [f"scale_{i}" for i in range(3)]
                                  + [f"rot_{i}" for i in range(4)]) and native.available(),
          "save_ply's layout would not take the native reader")
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for ext, save in ((".ply", save_ply), (".spz", save_spz), (".splat", save_splat_file)):
            path = os.path.join(tmp, "scene" + ext)
            save(path, truth)
            got = load_scene(path, device=dev)
            g = {f: getattr(got, f) for f in FIELDS}
            a = torch.sigmoid(g["opacities"])
            if ext == ".ply":
                errs = {f: 0.0 for f in FIELDS}
                check(all(torch.equal(g[f], t[f]) for f in FIELDS), "the PLY round trip")
            elif ext == ".spz":
                errs = dict(
                    means=io_within("spz means", g["means"], t["means"], 2.0 ** -13 + 1e-7),
                    scales=io_within("spz scales", g["scales"], t["scales"], 1 / 32 + 1e-5),
                    quats=io_within("spz quats", g["quats"], sign_canonical(t["quats"]), 4e-3),
                    sh_dc=io_within("spz sh_dc", g["sh_dc"], t["sh_dc"].clamp(
                        -127.5 / 38.25, 127.5 / 38.25), 0.5 / 38.25 + 1e-5),
                    sh_rest=io_within("spz sh_rest", g["sh_rest"],
                                      t["sh_rest"].clamp(-1.0, 127 / 128), 0.5 / 128 + 1e-6),
                    opacities=io_within("spz alpha", a, alpha, 0.5 / 255 + 1e-5))
            else:
                errs = dict(
                    means=io_within("splat means", g["means"], t["means"], 0.0),
                    scales=io_within("splat scales", g["scales"], t["scales"], 2e-6),
                    quats=io_within("splat quats", g["quats"], unit, 1 / 128 + 1e-6),
                    sh_dc=io_within("splat sh_dc", g["sh_dc"], t["sh_dc"].clamp(
                        -0.5 / SH_C0, 0.5 / SH_C0), 0.5 / 255 / SH_C0 + 1e-5),
                    opacities=io_within("splat alpha", a, alpha, 0.5 / 255 + 1e-5))
                check(tuple(g["sh_rest"].shape) == (truth.means.shape[0], 0, 3),
                      ".splat carries SH degree 0")
            lines.append(f"{ext} {os.path.getsize(path) / 1e6:.1f} MB (load_scene, to the card) "
                         f"max errors " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
            del got, g
    log("io 1M splats SH 3: " + "; ".join(lines))


def host_sorted(dev, truth: gt.SplatSet, caps):
    """Phase 9: the host-sorted path and the IO at the headline cell and
    caps. Returns the report entries of the four key-row forms."""
    t0 = time.perf_counter()
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    prepared = truth.prepare()
    sorter = host_sort_checks(truth, cam)
    k3, order0 = keyrow_forward(dev, prepared, cam, base, caps, sorter)
    k4 = keyrow_backward(dev, truth, cam, base, caps)
    k4["kept_share"] = k3["kept_share"]  # the same lanes on the headline frame (check_cull)
    entries = {KEYROW_FWD: k3, KEYROW_BWD: k4}
    entries.update(keyrow_stochastic(dev, truth, cam, base, caps, order0))
    torch.cuda.empty_cache()
    io_phase(dev, truth)
    log(f"host-sorted phase {time.perf_counter() - t0:.1f} s")
    return entries


def bit_equal(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference of a probe kernel's output against its twin's, 0:
    fails unless they are equal bit for bit, NaN keys included (the probes
    only compare, select and copy)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32)),
          f"{label}: kernel and twin differ")
    return 0.0


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


def probe_roll_phase(dev):
    """P1: bit-equal to the twin at small sizes (3 sorts; ties, signed zeros
    and NaN keys), at the script's (one 16 x 2048 tile, 200 sorts) and at
    the frame's 8160 tiles sorted once."""
    small = probe_roll.tiles_of(3, 4, 128, dev)
    err = max(bit_equal(f"bench_roll small {name}", probe_roll.bitonic_sort(y, 3),
                        probe_roll.bitonic_sort_ref(y, 3))
              for name, y in (("", small), ("ties and NaN", ties_nan(small, 0))))
    one = probe_roll.tiles_of(1, 16, 2048, dev)
    err = max(err, bit_equal("bench_roll default", probe_roll.bitonic_sort(one, probe_roll.REPS),
                             probe_roll.bitonic_sort_ref(one, probe_roll.REPS)))
    x = probe_roll.tiles_of(probe_roll.FRAME_TILES, 16, 2048, dev, seed=1)
    err = max(err, bit_equal("bench_roll 8160 tiles", probe_roll.bitonic_sort(x, 1),
                             probe_roll.bitonic_sort_ref(x, 1)))
    log(f"probe bench_roll: bit-equal to its twin at 3 x (4, 128), 1 x (16, 2048) and "
        f"{x.shape[0]} x (16, 2048); max_abs_err={err}")
    return err


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


def probe_stage_phase(dev, variant: str):
    """P3, one variant: bit-equal to the twin at small sizes (a cut and a
    repeated schedule; ties, signed zeros and NaN keys; a mask table that
    duplicates columns) and at the script's default (16 rows, 55 stages, 2
    tiles in each of 4096 blocks)."""
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
    log(f"probe {variant}: bit-equal to its twin at two small sizes and at {steps} blocks x 2 x "
        f"({rows}, 1024), 55 stages; max_abs_err={err}")
    return err


def probe_radix_phase(dev):
    """P2: at the script's 256 steps x 64 copies, for each W, the output of
    one block and of 256 blocks against the block the last copy into ring
    slot 0 brought; at 4 steps x 64 copies, in one block and in two, every
    copied block against the twin's copies."""
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
    log(f"probe bench_radix_ab: every W {probe_radix.WIDTHS} bit-equal to its twin; "
        f"max_abs_err={err}")
    return err


def probes(dev):
    """Phase 15: the probes P1-P3. Returns their report entries."""
    t0 = time.perf_counter()
    launches = probe_main_paths()
    entries = {}
    phases = [("bench_roll", lambda: probe_roll_phase(dev))]
    phases += [(stage_name(v), lambda v=v: probe_stage_phase(dev, v))
               for v in probe_stage.VARIANTS]
    phases += [("bench_radix_ab", lambda: probe_radix_phase(dev))]
    for name, phase in phases:
        entries[name] = dict(launches=launches[name], max_abs_err=phase())
        torch.cuda.empty_cache()
    log(f"probes phase {time.perf_counter() - t0:.1f} s")
    return entries


# ---- the SH radiance pair and the EWA projection pair at the cells' sizes --
#
# Each kernel of csrc/sh_radiance.cu and csrc/ewa_project.cu against its plain
# version on the card, at the splat counts of the cells that run it; the
# gates are tests/test_torch_cuda.py's, whose sizes stop at 4,096 (SH) and
# 1,000,000 (EWA) splats.

SH_SPLATS = (6_130_000, 1_000_000)   # the 3DGS cells' scene; the 3DGUT trainer's
SH_FWD_ATOL = 2e-6   # tests/test_torch_cuda.py's SH_ATOL
SH_BWD_RTOL = 1e-5   # of each gradient's largest entry
EWA_SPLATS = (6_130_000, 15_300_000)  # the 3DGS cells' scene; the hybrid cell's
# tests/test_torch_cuda.py's gates: relative (xy, depth), of the largest
# entry (conic), relative (alpha), the share of flipped splats, of each
# leaf's norm (gradients)
EWA_REL, EWA_CONIC, EWA_ALPHA, EWA_FLIPS, EWA_GRAD = 1e-6, 1e-5, 1e-5, 1e-5, 1e-5


def sh_radiance_phase(dev):
    """Phase 16: the SH radiance kernels at each of SH_SPLATS (SH 3, f32)
    against ``sh_radiance_ref`` (forward) and against autograd through it
    and the closed-form ``sh_radiance_bwd_ref`` (backward). Returns the
    pair's report entries (the 6.13M-splat errors)."""
    t0 = time.perf_counter()
    entries = {}
    for n in SH_SPLATS:
        g = torch.Generator(device=dev).manual_seed(n)
        sh = torch.randn((n, 15, 3), generator=g, device=dev) * 0.3
        means = torch.rand((n, 3), generator=g, device=dev) * 6.0 - 3.0
        color = torch.rand((n, 4), generator=g, device=dev) * 1.3 - 0.3
        pos = torch.tensor([0.3, -0.2, -7.0], device=dev)
        d_rgb = torch.randn((n, 3), generator=g, device=dev)
        args = (sh, means, color, pos, 15, False)
        err_fwd = (tsh.sh_radiance_fwd(*args) - tsh.sh_radiance_ref(sh, means, color, pos, 3)
                   ).abs().max().item()
        leaves = [t.detach().clone().requires_grad_() for t in (sh, means, color)]
        plain = torch.autograd.grad(tsh.sh_radiance_ref(*leaves, pos, 3), leaves, d_rgb)
        got, twin = tsh.sh_radiance_bwd(*args, d_rgb), tsh.sh_radiance_bwd_ref(*args[:4], 3,
                                                                                False, d_rgb)
        err_bwd, abs_bwd = {}, 0.0
        for name, k, p, t in zip(("d_sh", "d_means", "d_color"), got, plain, twin):
            scale = p.abs().max().item()
            err = (k - p).abs().max().item()
            abs_bwd = max(abs_bwd, err)
            err_bwd[name] = (err / scale, (k - t).abs().max().item() / scale)
        log(f"sh_radiance n={n}: forward max abs err {err_fwd:.3e} against the plain version; "
            f"backward max abs err {abs_bwd:.3e} against autograd through it; "
            "backward, of each gradient's largest entry, against autograd / the twin: "
            + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in err_bwd.items()))
        check(err_fwd <= SH_FWD_ATOL, f"sh_radiance_fwd n={n}: {err_fwd} from the plain version")
        check(all(max(e) <= SH_BWD_RTOL for e in err_bwd.values()),
              f"sh_radiance_bwd n={n}: {err_bwd}")
        if n == SH_SPLATS[0]:
            entries["sh_radiance_fwd"] = dict(max_abs_err=err_fwd)
            entries["sh_radiance_bwd"] = dict(
                max_abs_err=abs_bwd, max_rel_err=max(max(e) for e in err_bwd.values()))
        del sh, means, color, d_rgb, leaves, plain, got, twin
        torch.cuda.empty_cache()
    log(f"sh_radiance phase {time.perf_counter() - t0:.1f} s")
    return entries


def ewa_project_phase(dev):
    """Phase 17: the EWA projection kernels at each of EWA_SPLATS, the
    headline 1080p camera over the headline mix, against
    ``project_splats_ref`` (forward) and against autograd through it and the
    closed-form ``project_splats_bwd_ref`` (backward). Returns the pair's
    report entries (the 6.13M-splat errors)."""
    t0 = time.perf_counter()
    entries = {}
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=0)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    for n in EWA_SPLATS:
        prep = bench_scene(dev, n, seed=1, sh_degree=0).prepare()
        means, cov3d, color, scales = prep.means, prep.cov3d, prep.color, prep.scales_log
        g = torch.Generator(device=dev).manual_seed(n)
        cots = [torch.randn(shape, generator=g, device=dev)
                for shape in ((n, 2), (n, 3), (n,), (n,))]
        leaves = [t.detach().clone().requires_grad_() for t in (means, cov3d, color)]
        lp = dataclasses.replace(prep, means=leaves[0], cov3d=leaves[1], color=leaves[2])

        xy, conic, depth, radius, alpha, valid = tproj.ewa_project(means, cov3d, color, scales,
                                                                   cam, cfg)
        want = tproj.project_splats_ref(prep, cam, cfg)
        flips = int(((valid != want.valid) | (radius != want.radius).any(-1)).sum())
        keep = valid & want.valid
        xy_scale = torch.maximum(want.xy[keep].abs(), torch.stack([cam.cx, cam.cy]).abs())
        err_fwd = {
            "xy": ((xy[keep] - want.xy[keep]).abs() / xy_scale).max().item(),
            "depth": ((depth[keep] - want.depth[keep]).abs() / want.depth[keep].abs()).max()
            .item(),
            "conic": ((conic[keep] - want.conic[keep]).abs().amax(-1)
                      / want.conic[keep].abs().amax(-1)).max().item(),
            "alpha": ((alpha[keep] - want.alpha[keep]).abs() / want.alpha[keep]).max().item()}
        gates = {"xy": EWA_REL, "depth": EWA_REL, "conic": EWA_CONIC, "alpha": EWA_ALPHA}
        log(f"ewa_project n={n}: {int(keep.sum())} splats kept by both, {flips} with another "
            f"valid or radius (gate {math.ceil(EWA_FLIPS * n)}); forward against the plain "
            "version: " + ", ".join(f"{k} {v:.3e}" for k, v in err_fwd.items()))
        check(flips <= math.ceil(EWA_FLIPS * n), f"ewa_project_fwd n={n}: {flips} flips")
        check(all(err_fwd[k] <= gates[k] for k in gates), f"ewa_project_fwd n={n}: {err_fwd}")
        del xy, conic, depth, radius, alpha, valid, want, keep, xy_scale
        got = tproj.ewa_project_bwd(means, cov3d, color, cam, cfg, *cots)
        out = tproj.project_splats_ref(lp, cam, cfg)
        plain = torch.autograd.grad([out.xy, out.conic, out.depth, out.alpha], leaves, cots)
        twin = tproj.project_splats_bwd_ref(means, cov3d, color, cam, cfg, *cots)
        err_bwd = {}
        for name, k, p, t in zip(("d_means", "d_cov3d", "d_color"), got, plain, twin):
            scale = p.norm().item()
            err_bwd[name] = ((k - p).norm().item() / scale, (k - t).norm().item() / scale)
        log(f"ewa_project_bwd n={n}: of each gradient's norm, against autograd through the "
            "plain version / the twin: "
            + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in err_bwd.items()))
        check(all(max(e) <= EWA_GRAD for e in err_bwd.values()),
              f"ewa_project_bwd n={n}: {err_bwd}")
        if n == EWA_SPLATS[0]:
            entries["ewa_project_fwd"] = dict(max_rel_err=max(err_fwd.values()), flips=flips)
            entries["ewa_project_bwd"] = dict(max_rel_err=max(max(e) for e in err_bwd.values()))
        del prep, lp, means, cov3d, color, scales, cots, leaves, got, out, plain, twin
        torch.cuda.empty_cache()
    log(f"ewa_project phase {time.perf_counter() - t0:.1f} s")
    return entries


# ---- meshes (render_mesh, render_3dgs_composed): K1 tri2d, tri2d_smooth,
# gs2d_clip (+ _stoch); K2 gs2d_clip (+ _stoch), tri2d -------------------------
#
# The mesh pass blends each pixel's depth-sorted faces with an opaque,
# unclamped alpha (T exactly 0 or 1); the composed frame's splat pass
# blends behind the mesh's per-pixel depth (pixel-context row 6). Each form
# against its twin on 64 sampled tiles (``sample_tiles``) at K1's and K2's
# gates; its kept counter against the plain per-warp or per-tile count over
# every tile, exactly, and the audit of every tile; gs2d_clip with the
# limit 0 everywhere equals gs2d bit for bit. The mesh: a ground grid and an
# octahedron sphere built in code (``headline_mesh``), lit by the headlight.

MESH_FRAMES = 4            # jittered frames per mesh main path
MESH_SPHERE_SUBDIV = 7     # 8 * 4^7 = 131,072 faces
MESH_GRID = (100, 100)     # cells of the ground grid, two faces each
# the composed frame bins by the exact expansion: the headline scene's slot
# expansion overflows by design (PERF.md §4), and neither pass may here
COMPOSED_MAX_PAIRS = 1 << 22
# The view sweep (``mesh_views``): (eye, target, up) that put faces on and
# just past the near plane, through the camera plane and edge-on, besides
# the headline view
MESH_VIEWS = {
    "headline": ([0, 0, -7], [0, 0, 0], [0, 1, 0]),
    "on the sphere": ([0, 0, -2.005], [0, 0, 0], [0, 1, 0]),
    "in the sphere": ([0, 0, 0.5], [0, 0, 5], [0, 1, 0]),
    "grazing the ground": ([0.5, -2.49, -6], [0, -2.49, 0], [0, 1, 0]),
    "in the ground plane": ([0, -2.5, -6], [0, -2.5, 0], [0, 1, 0]),
    "above": ([3, 8, -10], [0, 0, 0], [0, 1, 0]),
    "looking away": ([0, 0, -7], [0, 0, -8], [0, 1, 0]),
    "top down": ([0, 30, 0], [0, 0, 0], [0, 0, 1]),
}


def headline_mesh() -> ObjMesh:
    """The mesh of phase 10 in world units (the headline camera at z = -7
    looks at the origin, world +y up on screen): an octahedron subdivided
    MESH_SPHERE_SUBDIV times onto a sphere of radius 2 at the origin, exact
    normals; a ground grid at y = -2.5 over x in [-15, 15], z in [-4, 30],
    MESH_GRID cells, normals up. Splats of the 1 M scene (means in [-4, 4]^3)
    lie in front of the sphere, inside it and under the ground."""
    sphere = octa_sphere(MESH_SPHERE_SUBDIV, 2.0)
    unit, faces = sphere.normals, sphere.indices
    nx, nz = MESH_GRID
    gx, gz = np.meshgrid(np.linspace(-15, 15, nx + 1), np.linspace(-4, 30, nz + 1))
    ground = np.stack([gx.ravel(), np.full(gx.size, -2.5), gz.ravel()], 1).astype(np.float32)
    i = (np.arange(nz)[:, None] * (nx + 1) + np.arange(nx)[None, :]).ravel() + len(unit)
    quads = np.concatenate([np.stack([i, i + 1, i + nx + 2], 1),
                            np.stack([i, i + nx + 2, i + nx + 1], 1)])
    idx = np.concatenate([faces, quads.astype(np.int32)])
    mats = np.concatenate([np.zeros(len(faces), np.int32), np.ones(len(quads), np.int32)])
    return ObjMesh(np.concatenate([sphere.positions, ground]),
                   np.concatenate([unit, np.tile([[0, 1, 0]], (len(ground), 1))]).astype(
                       np.float32), idx, mats,
                   [ObjMaterial(diffuse=(0.85, 0.55, 0.35)), ObjMaterial(diffuse=(0.3, 0.6, 0.3))])


def mesh_cfg(cfg, shading):
    return cfg.replace(raster=dataclasses.replace(cfg.raster, mesh_shading=shading))


def sample_tiles(bins, st, dev, seed: int):
    """Up to 64 tiles of a pair frame, from a seeded generator: 48 with
    pairs and 16 of any, without repeats."""
    g = torch.Generator(device=dev).manual_seed(seed)
    busy = torch.nonzero(bins.tile_count > 0).flatten()
    pick = torch.cat([busy[torch.randperm(busy.numel(), generator=g, device=dev)[:48]],
                      torch.randperm(st.tiles_x * st.tiles_y, generator=g, device=dev)[:16]])
    return torch.unique(pick)


@torch.no_grad()
def mesh_fwd_gate(label, bins, st, pix, tiles):
    """K1 (the form of ``st``; seed 0) against its twin on ``tiles``: rgb
    and T within KERNEL_ATOL, ids on ID_AGREE, the same depth where the
    same id. Returns the max abs error."""
    out_k, id_k = tr.rasterize_bins(bins, st, pix, 0)
    out_r, id_r = tr.rasterize_tiles_ref(bins.attrs.detach(), bins.pair_id, bins.tile_start,
                                         bins.tile_count, st, tiles=tiles, pix_ctx=pix)
    out_k, id_k = out_k[tiles], id_k[tiles]
    torch.cuda.synchronize()
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item()
    same = id_k == id_r
    agree = same.float().mean().item()
    log(f"  {label} vs twin on {tiles.numel()} sampled tiles: max abs {err:.3e} (gate "
        f"{KERNEL_ATOL:g}), id agreement {agree:.6f}, bit-equal {torch.equal(out_k, out_r)}")
    check(err <= KERNEL_ATOL and agree >= ID_AGREE, f"{label} outside the gates: {err}, {agree}")
    check(torch.equal(out_k[:, 4][same], out_r[:, 4][same]),
          f"{label}: the same pair picked at another depth")
    return err


def colour_rows_gate(label, d_k, d_r):
    """A backward form whose alpha takes no gradient (a stochastic accept,
    tri2d's coverage) against its twin: every row but the colour rows
    exactly 0 in both, the colour rows at K2's gates (``bwd_gate``) on the
    columns either touches. Returns the max abs error."""
    other = [r for r in range(d_k.shape[0]) if not COLOUR_ROWS.start <= r < COLOUR_ROWS.stop]
    check(bool((d_k[other] == 0).all()) and bool((d_r[other] == 0).all()),
          f"{label}: a row other than the colour rows is not 0")
    cols = ((d_k != 0) | (d_r != 0)).any(dim=0)
    ok, abs_err, rel, share, p999 = bwd_gate(d_k[COLOUR_ROWS][:, cols], d_r[COLOUR_ROWS][:, cols])
    log(f"  {label} vs twin on {int(cols.sum())} columns: colour rows max err / row max "
        f"{rel:.3e} (gate {BWD_RTOL:g}), least share within {BWD_ELEM_RTOL:g} {share:.6f} (gate "
        f"{BWD_ELEM_SHARE}), p99.9 " + " ".join(f"{x:.2e}" for x in p999)
        + "; every other row exactly 0 in both")
    check(ok, f"{label} vs twin outside the gates: {rel} / {share}")
    return abs_err


def mesh_forward(dev, mesh, cam, base, shading):
    """render_mesh at the headline cell with ``shading``: MESH_FRAMES
    jittered frames with every launch counter zeroed (only the form's
    moves, once a frame); T exactly 0 or 1; the coverage; a bit-equal
    repeat; the pass's face, slot and pair counts, no overflow; K1's form
    against its twin on sampled tiles, its kept counter and audit over
    every tile. Returns its entry."""
    cfg = mesh_cfg(base, shading)
    form = mr.mesh_statics(cfg).model
    tr.zero_counters(tr.rasterize_tiles)
    outs = [mr.render_mesh(mesh, jitter(cam, i), cfg) for i in range(MESH_FRAMES)]
    torch.cuda.synchronize()
    seen = only(f"render_mesh {shading}", tr.rasterize_tiles, form, MESH_FRAMES)
    for img, trans, depth, fid in outs:
        check(tuple(img.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(img).all()),
              f"render_mesh {shading}: image shape or values")
        check(bool(((trans == 0) | (trans == 1)).all()), f"{shading}: T not exactly 0 or 1")
    _, trans, _, fid = outs[0]
    covered = (trans == 0).float().mean().item()
    again = mr.render_mesh(mesh, jitter(cam, 0), cfg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(again, outs[0]))
    del outs, again
    bins, st = mr.mesh_bins(mesh, cam, cfg)
    n_faces, n_pairs = mesh.indices.shape[0], int(bins.num_pairs)
    log(f"render_mesh {shading} 1080p: {n_faces} faces, {n_faces * mr.MESH_SLOTS_K} slots "
        f"before the sort, {n_pairs} pairs, overflow {bool(bins.overflow)}; "
        f"covered {covered:.4f}, faces picked {int(fid.unique().numel()) - 1}, launches {seen}, "
        f"repeat bit-equal {same}")
    check(not bool(bins.overflow), f"the {shading} mesh pass overflowed")
    check(0.2 <= covered <= 0.8, f"the mesh covers {covered} of the pixels")
    check(same, f"the repeat {shading} mesh frame differs")
    tiles = sample_tiles(bins, st, dev, seed=13)
    err = mesh_fwd_gate(f"K1 {form}", bins, st, None, tiles)
    work, kept = check_warp_cull(f"K1 {form}", bins, st, twin_tiles(st, dev))
    return dict(launches=seen[form], max_abs_err=err, kept_share=kept / (tr.WARPS * work[2]))


def composed_stages(prepared, cam, cfg, mesh, overflow_ok=False):
    """render_3dgs_composed's splat pass up to its blend, on a mesh pass run
    here: (bins, clip statics, the pixel context of the mesh depth). The
    mesh pass must not overflow unless ``overflow_ok``."""
    mesh_bins, _ = mr.mesh_bins(mesh, cam, cfg, COMPOSED_MAX_PAIRS)
    check(overflow_ok or not bool(mesh_bins.overflow), "the composed frame's mesh pass overflowed")
    depth = mr.render_mesh(mesh, cam, cfg, COMPOSED_MAX_PAIRS)[2]
    st = dataclasses.replace(raster_statics(cfg), model="gs2d_clip")
    return (bins_of(prepared, cam, cfg, COMPOSED_MAX_PAIRS), st,
            mr.depth_limit_pix_ctx(depth, cfg))


def composed_forward(dev, prepared, mesh, cam, base):
    """The composed frame, deterministic and stochastic (``cfg.stochastic``
    SPLAT: the splat pass's _stoch form, seed 0): FRAMES jittered frames
    each through ``render_3dgs_composed`` (only K1 tri2d_smooth and the
    splat pass's form move, once a frame each), finite, no overflow, a
    bit-equal repeat, the share of picks the mesh changed; K1's form
    against its twin on sampled tiles, its kept counter and audit, the
    limit 0 everywhere equal to gs2d's form bit for bit. Returns {name:
    entry}."""
    entries = {}
    for stoch in (False, True):
        cfg = base.replace(stochastic=gt.StochasticMode.SPLAT) if stoch else base
        p_st = raster_statics(cfg)
        s = dataclasses.replace(p_st, model="gs2d_clip")
        form, p_form, name = tr.form_of(s), tr.form_of(p_st), "rasterize_fwd_" + tr.form_of(s)
        tr.zero_counters(tr.rasterize_tiles)
        outs = [render_3dgs_composed(prepared, jitter(cam, i), cfg, COMPOSED_MAX_PAIRS, mesh)
                for i in range(FRAMES)]
        torch.cuda.synchronize()
        seen = counts(tr.rasterize_tiles)
        check(seen == {m: FRAMES * (m in ("tri2d_smooth", form)) for m in seen},
              f"composed main path ({form}): launches {seen}")
        for o in outs:
            check(tuple(o.image.shape) == (HEIGHT, WIDTH, 3)
                  and bool(torch.isfinite(o.image).all()), "composed frame: image shape or values")
            check(not bool(o.overflow), "the composed frame's splat pass overflowed")
        o0 = outs[0]
        del outs
        again = render_3dgs_composed(prepared, jitter(cam, 0), cfg, COMPOSED_MAX_PAIRS, mesh)
        plain = render(prepared, jitter(cam, 0), base, COMPOSED_MAX_PAIRS)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(again, f), getattr(o0, f))
                   for f in ("image", "transmittance", "depth", "splat_id"))
        moved = ((plain.splat_id >= 0) & (o0.splat_id != plain.splat_id)).float().mean().item()
        log(f"composed main path ({form}): {FRAMES} frames, launches "
            f"{ {m: n for m, n in seen.items() if n} }; num_pairs={int(o0.num_pairs)} T==0 share "
            f"{(o0.transmittance == 0).float().mean():.4f}, share of pixels whose splat pick the "
            f"mesh changed {moved:.4f}; repeat bit-equal {same}")
        check(same, f"the repeat composed frame ({form}) differs")
        check(moved > 0.01, "the mesh hides no splats")
        del again, plain, o0

        bins, _, pix = composed_stages(prepared, cam, cfg, mesh)
        err = mesh_fwd_gate(f"K1 {form}", bins, s, pix, sample_tiles(bins, s, dev, seed=17))
        work, kept = check_warp_cull(f"K1 {form}", bins, s, twin_tiles(s, dev), pix)
        off = tr.rasterize_bins(bins, s, torch.zeros_like(pix), 0)
        ref = tr.rasterize_bins(bins, p_st, None, 0)
        torch.cuda.synchronize()
        equal = torch.equal(off[0], ref[0]) and torch.equal(off[1], ref[1])
        log(f"  K1 {form} with the limit 0 everywhere equals K1 {p_form} bit for bit: {equal}")
        check(equal, f"{form} without a limit differs from {p_form}")
        entries[name] = dict(launches=seen[form], max_abs_err=err,
                             kept_share=kept / (tr.WARPS * work[2]))
        del bins, pix
    return entries


def composed_backward(dev, truth, mesh, cam, base):
    """One loss step through the composed frame from the jittered start,
    deterministic and stochastic: only K2's form of the splat pass moves,
    once; finite; a bit-equal repeat; K2's form against its twin with the
    loss's cotangent on sampled tiles (``bwd_gate``; the stochastic form's
    colour rows, every other row exactly 0), its kept counter and audit over
    every tile. Returns {name: entry}."""
    entries = {}
    for stoch in (False, True):
        cfg = base.replace(stochastic=gt.StochasticMode.SPLAT) if stoch else base
        s = dataclasses.replace(raster_statics(cfg), model="gs2d_clip")
        form, name = tr.form_of(s), "rasterize_bwd_" + tr.form_of(s)
        with torch.no_grad():
            target = render_3dgs_composed(truth.prepare(), cam, base, COMPOSED_MAX_PAIRS,
                                          mesh).image
        splats = jittered_start(truth, dev, seed=0)
        for f in FIELDS:
            getattr(splats, f).requires_grad_()

        def fwd_bwd():
            for f in FIELDS:
                getattr(splats, f).grad = None
            out = render_3dgs_composed(splats.prepare(), cam, cfg, COMPOSED_MAX_PAIRS, mesh)
            loss = gt.rgb_loss(out.image, target)
            loss.backward()
            return loss

        tr.zero_counters(tr.rasterize_tiles_bwd, tr.TRAINED)
        loss = fwd_bwd()
        torch.cuda.synchronize()
        seen = only(f"composed loss step ({form})", tr.rasterize_tiles_bwd, form, 1)
        first = [x.clone() for x in grads_of(splats)]
        fwd_bwd()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, grads_of(splats)))
        finite = all(bool(torch.isfinite(x).all()) for x in first)
        zero = [f for f, x in zip(FIELDS, first) if bool((x == 0).all())]
        log(f"composed loss step ({form}): loss={loss.item():.6f} launches {seen}, gradients "
            f"finite {finite}, fields exactly 0: {zero}, repeat backward bit-equal {same}")
        check(same and finite, f"the composed backward ({form}): not finite or not repeatable")
        del first

        bins, _, pix = composed_stages(splats.prepare(), cam, cfg, mesh)
        attrs = bins.attrs.detach()
        n_tiles = s.tiles_x * s.tiles_y
        out, out_id = tr.rasterize_bins(bins, s, pix, 0)
        out = out.detach().requires_grad_()
        img, trans = tr.assemble_image(out, out_id, s.tiles_x, s.tiles_y, WIDTH, HEIGHT)[:2]
        mesh_img = mr.render_mesh(mesh, cam, cfg, COMPOSED_MAX_PAIRS)[0]
        (g_out,) = torch.autograd.grad(gt.rgb_loss(img + trans[..., None] * mesh_img, target),
                                       out)
        full = tr.bwd_context(out.detach(), g_out)
        tiles = sample_tiles(bins, s, dev, seed=19)
        keep = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
        keep[tiles] = True
        ctx = full * keep[:, None, None]
        d_k = tr.rasterize_tiles_bwd(attrs, bins.tile_start, bins.tile_count, ctx, s, pix, 0)

        def twin(cx, s=s, pix=pix, tiles=tiles):
            return sum(tr.rasterize_tiles_bwd_ref(bins.attrs.detach(), bins.tile_start,
                                                  bins.tile_count, cx, s, tiles=t, pix_ctx=pix)
                       for t in twin_tiles(s, dev, tiles))

        if stoch:
            abs_err = colour_rows_gate(f"K2 {form}", d_k, twin(ctx))
        else:
            cols = ((d_k != 0) | (twin(ctx) != 0)).any(dim=0)
            abs_err, _ = gate_bwd_against_twin(f"K2 {form}", d_k, twin, ctx, cols)
        tr.rasterize_tiles_bwd(attrs, bins.tile_start, bins.tile_count, full, s, pix, 0)
        work, kept = check_pair_cull(f"K2 {form}", bins, s, twin_tiles(s, dev), pix)
        entries[name] = dict(launches=seen[form], max_abs_err=abs_err,
                             kept_share=kept / max(work[2], 1))
        del bins, attrs, pix, out, g_out, full, ctx, d_k, splats
    return entries


def flat_mesh_backward(dev, mesh_obj, cam, base):
    """One gradient of the flat mesh's image with respect to its face
    colours: K2 tri2d once; finite and repeatable; K2 tri2d against its twin
    on sampled tiles (``bwd_gate``, the colour rows; the vertex rows exactly
    0 in both) and its kept counter (every tested pair: it does not cull).
    Returns its entry."""
    cfg = mesh_cfg(base, "flat")
    w = torch.randn((HEIGHT, WIDTH, 3), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    def gradient():
        mesh = mr.mesh_buffers_from_obj(mesh_obj, device=dev)
        mesh.face_colors.requires_grad_()
        (mr.render_mesh(mesh, cam, cfg)[0] * w).sum().backward()
        return mesh.face_colors.grad

    tr.zero_counters(tr.rasterize_tiles_bwd, tr.TRAINED)
    grads = [gradient()]
    torch.cuda.synchronize()
    seen = only("flat mesh face-colour gradient (K2)", tr.rasterize_tiles_bwd, "tri2d", 1)
    grads.append(gradient())
    torch.cuda.synchronize()
    same = torch.equal(grads[0], grads[1])
    log(f"flat mesh face-colour gradient: launches {seen}, finite "
        f"{bool(torch.isfinite(grads[0]).all())}, nonzero faces "
        f"{int((grads[0] != 0).any(dim=1).sum())}, repeat bit-equal {same}")
    check(same and bool(torch.isfinite(grads[0]).all()), "the face-colour gradient")
    mesh = mr.mesh_buffers_from_obj(mesh_obj, device=dev)
    bins, st = mr.mesh_bins(mesh, cam, cfg)
    attrs = bins.attrs.detach()
    n_tiles = st.tiles_x * st.tiles_y
    out = tr.rasterize_bins(bins, st)[0]
    g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    full = tr.bwd_context(out, g)
    tiles = sample_tiles(bins, st, dev, seed=23)
    keep = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    keep[tiles] = True
    ctx = full * keep[:, None, None]
    d_k = tr.rasterize_tiles_bwd(attrs, bins.tile_start, bins.tile_count, ctx, st)

    def twin(cx):
        return sum(tr.rasterize_tiles_bwd_ref(attrs, bins.tile_start, bins.tile_count, cx, st,
                                              tiles=t) for t in twin_tiles(st, dev, tiles))

    abs_err = colour_rows_gate("K2 tri2d", d_k, twin(ctx))
    tr.rasterize_tiles_bwd(attrs, bins.tile_start, bins.tile_count, full, st)
    work, kept = check_pair_cull("K2 tri2d", bins, st, twin_tiles(st, dev))
    return dict(launches=seen["tri2d"], max_abs_err=abs_err, kept_share=kept / max(work[2], 1))


def bins_in_range(label, bins, sources: int):
    """The index invariants the kernels and the gathers rely on: every
    tile's range inside the pair arrays, the live pairs' ids in [0,
    sources) and their vertex or centre rows finite."""
    p, live = bins.attrs.shape[1], int(bins.num_pairs)
    start, count = bins.tile_start.long(), bins.tile_count.long()
    ids = bins.pair_id[:live]
    ok = (bool((count >= 0).all()) and bool((start >= 0).all())
          and bool((start + count <= p).all()) and live == int(count.sum())
          and bool(((ids >= 0) & (ids < sources)).all())
          and bool(torch.isfinite(bins.attrs[:2, :live]).all()))
    check(ok, f"{label}: a tile range or a pair index out of range")


def mesh_views(dev, mesh, prepared, base, rounds: int = 1):
    """render_mesh smooth and flat and the composed frame at every view of
    MESH_VIEWS, ``rounds`` times (round r nudged by ``jitter``), each frame
    synchronised and checked on its own: finite, T of the mesh exactly 0 or
    1, both passes' bins in range (``bins_in_range``). A device-side
    assertion surfaces at the view's synchronisation. Returns (frames, the
    passes that overflowed)."""
    frames, overflowed = 0, collections.Counter()
    exact = base.replace(raster=dataclasses.replace(base.raster, expansion="exact"))
    faces = mesh.indices.shape[0]
    for r in range(rounds):
        for label, (eye, target, up) in MESH_VIEWS.items():
            cam = jitter(gt.look_at(eye, target, up, WIDTH, HEIGHT, fov_y_rad=0.9, device=dev), r)
            for shading in ("smooth", "flat"):
                cfg = mesh_cfg(base, shading)
                bins, _ = mr.mesh_bins(mesh, cam, cfg)
                torch.cuda.synchronize()
                bins_in_range(f"{label} ({shading})", bins, faces)
                overflowed[f"mesh {shading}"] += bool(bins.overflow)
                img, trans, _, _ = mr.render_mesh(mesh, cam, cfg)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(img).all()) and bool(((trans == 0) | (trans == 1)).all()),
                      f"render_mesh {shading} at the view {label}: not finite or T not 0 or 1")
                frames += 1
            bins, _, _ = composed_stages(prepared, cam, exact, mesh, overflow_ok=True)
            torch.cuda.synchronize()
            bins_in_range(f"{label} (splat pass)", bins, prepared.means.shape[0])
            overflowed["splat pass"] += bool(bins.overflow)
            out = render_3dgs_composed(prepared, cam, exact, COMPOSED_MAX_PAIRS, mesh)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.image).all()),
                  f"the composed frame at the view {label}: not finite")
            frames += 1
    log(f"mesh views: {frames} frames at {len(MESH_VIEWS)} views x {rounds} rounds, each "
        f"synchronised and checked; passes that overflowed {dict(overflowed)}")
    return frames, overflowed


def meshes(dev, truth: gt.SplatSet):
    """Phase 10 at the headline cell: ``render_mesh`` smooth and flat, the
    composed frame forward and backward, the flat mesh's face-colour
    gradient (``mesh_forward``, ``composed_forward``, ``composed_backward``,
    ``flat_mesh_backward``). Returns {name: entry} of the seven mesh
    forms."""
    t0 = time.perf_counter()
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    obj = headline_mesh()
    mesh = mr.mesh_buffers_from_obj(obj, device=dev)
    log(f"meshes: {obj.indices.shape[0]} faces ({8 * 4 ** MESH_SPHERE_SUBDIV} sphere, "
        f"{2 * MESH_GRID[0] * MESH_GRID[1]} ground), {obj.positions.shape[0]} vertices")
    mesh_views(dev, mesh, truth.prepare(), base)
    entries = {}
    for shading in ("smooth", "flat"):
        name = "rasterize_fwd_" + mr.mesh_statics(mesh_cfg(base, shading)).model
        entries[name] = mesh_forward(dev, mesh, cam, base, shading)
    exact = base.replace(raster=dataclasses.replace(base.raster, expansion="exact"))
    entries.update(composed_forward(dev, truth.prepare(), mesh, cam, exact))
    entries.update(composed_backward(dev, truth, mesh, cam, exact))
    entries["rasterize_bwd_tri2d"] = flat_mesh_backward(dev, obj, cam, base)
    log(f"meshes phase {time.perf_counter() - t0:.1f} s")
    return entries


# ---- lighting and shadows (render_3dgs_lit, render_hybrid): K1's multi-iso
# form ------------------------------------------------------------------------
#
# The lit frame shades the 3DGS pass by its normal buffer (a second gs2d
# blend) and two per-set materials; the hybrid frames (HYBRID: gs2d,
# HYBRID_3DGUT: gut3d) add per-light deep shadow maps, each a gs2d blend by
# K1's multi-iso form from the light (make_shadow_fn: a 512^2 cone for the
# directional light, six 256^2 cube faces for the enclosed point light).
# K1's multi-iso form against its twin on sampled tiles, and on the card
# bit for bit against K1 gs2d: rows 0-3 its rgb and T, row 4 + k its pick at
# depth_iso = ISO_LEVELS[k]; its kept counter and the audit over every tile.

LIT_FRAMES = 8             # jittered frames per hybrid main path
SHADOW_RES = 512           # the cone map (make_shadow_fn's default)
CUBE_RES = 256             # each cube face (make_shadow_fn: min(res, 256))
BIG_SHADOW_RES = 2048      # one more cone map for K1's multi-iso form
ISO_FORM, ISO_NAME = "gs2d" + tr.ISO, "rasterize_fwd" + tr.ISO
LIT_MATERIALS = (DeferredMaterial(diffuse=(0.9, 0.85, 0.8), specular=(0.3, 0.3, 0.3),
                                  shininess=24.0),
                 DeferredMaterial(diffuse=(0.5, 0.7, 1.0), ambient=(0.15, 0.15, 0.2),
                                  specular=(0.6, 0.6, 0.6), shininess=8.0,
                                  emission=(0.02, 0.02, 0.0)))
CARD_CPU_SPLATS, CARD_CPU_SIZE = 2000, (128, 96)
# each hybrid frame: the main pass and the normal buffer (the blend's model)
# and seven shadow maps (one cone, six cube faces) by the multi-iso form
HYBRID_LAUNCHES = {gt.Pipeline.HYBRID: {"gs2d": 2, ISO_FORM: 7},
                   gt.Pipeline.HYBRID_3DGUT: {"gut3d": 2, ISO_FORM: 7}}


def headline_lights(dev):
    """A directional light from above (world +y is up on screen) and a point
    light inside the scene's bounding sphere (means in [-4, 4]^3)."""
    return (make_light(LightType.DIRECTIONAL, direction=(0.3, -1.0, 0.2), intensity=1.2,
                       device=dev),
            make_light(LightType.POINT, position=(0.5, 1.0, -0.5), intensity=3.0, device=dev))


def halves_scene(truth) -> SplatScene:
    """The headline splats as two assets, their halves, each placed once as
    it is: the flatten is the lit frame's scene, and its global index table
    routes the two per-instance materials."""
    n = truth.means.shape[0]
    scene = SplatScene()
    for part in (slice(0, n // 2), slice(n // 2, n)):
        scene.add_instance(scene.add_asset(gt.SplatSet(**{f: getattr(truth, f)[part]
                                                          for f in FIELDS})))
    return scene


def lit_frame(prepared, cam, base, lights, bases):
    """``render_3dgs_lit`` at the headline cell with two per-instance
    materials over the two halves of the splats (``halves_scene``'s
    flatten, routed by its table's ``bases``): only K1 gs2d moves (twice:
    the pass and its normal buffer), finite, a bit-equal repeat, covered
    pixels changed by the shade, both materials in view."""
    tr.zero_counters(tr.rasterize_tiles)
    out, shaded, normals = render_3dgs_lit(prepared, cam, base, 0, lights, LIT_MATERIALS, bases)
    torch.cuda.synchronize()
    seen = only("render_3dgs_lit", tr.rasterize_tiles, "gs2d", 2)
    again = render_3dgs_lit(prepared, cam, base, 0, lights, LIT_MATERIALS, bases)
    torch.cuda.synchronize()
    same = (torch.equal(again[0].image, out.image) and torch.equal(again[1], shaded)
            and torch.equal(again[2], normals))
    covered = out.depth > 0
    changed = ((shaded - out.image).abs().amax(dim=-1) > 1e-3)[covered].float().mean().item()
    sets = instance_index_image(out.splat_id, bases)[covered]
    share = (sets == 1).float().mean().item()
    finite = bool(torch.isfinite(shaded).all()) and bool(torch.isfinite(normals).all())
    log(f"render_3dgs_lit 1080p/1M: launches {seen}; covered {covered.float().mean():.4f}, "
        f"covered pixels the shade changes by > 1e-3 {changed:.4f}, share of covered pixels "
        f"with the second material {share:.4f}; finite {finite}; repeat bit-equal {same}")
    check(same and finite, "render_3dgs_lit: not finite or not repeatable")
    check(changed > 0.5 and 0.01 < share < 0.99, "render_3dgs_lit: the shade or the materials")


def shadow_lookups(prepared, cfg, lights, out, cam):
    """{light index: (H,W) its shadow lookups}, by ``make_shadow_fn`` (the
    maps rendered again) at the frame's picked depths (``surface_points``)."""
    fn = make_shadow_fn(prepared, lights, cfg, SHADOW_RES)
    world = surface_points(out.depth, cam)
    return {i: fn(world, light) for i, light in enumerate(lights)}


def shadow_levels(prepared, cfg, lights, out, cam):
    """{light index: the staircase levels its shadow lookups take over the
    frame's covered pixels}."""
    covered = out.depth > 0
    return {i: sorted(torch.unique(t[covered]).tolist())
            for i, t in shadow_lookups(prepared, cfg, lights, out, cam).items()}


def hybrid_main_path(prepared, cam, base, lights, pipeline):
    """LIT_FRAMES jittered frames through ``render_hybrid`` with every launch
    counter of K1's wrapper zeroed (HYBRID_LAUNCHES a frame), finite, a
    bit-equal repeat, the shaded frame unlike the one with no light, and
    each light's lookups over the covered pixels at two staircase levels or
    more. Returns the multi-iso form's launches."""
    cfg = base.replace(pipeline=pipeline)
    tr.zero_counters(tr.rasterize_tiles)
    outs = [render_hybrid(prepared, jitter(cam, i), cfg, 0, lights) for i in range(LIT_FRAMES)]
    torch.cuda.synchronize()
    seen = counts(tr.rasterize_tiles)
    want = {m: LIT_FRAMES * HYBRID_LAUNCHES[pipeline].get(m, 0) for m in seen}
    check(seen == want, f"render_hybrid {pipeline.name}: launches {seen}")
    for o, s, n in outs:
        check(tuple(s.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(s).all())
              and bool(torch.isfinite(n).all()), f"{pipeline.name}: shaded or normals")
    o0, s0, _ = outs[0]
    del outs
    again = render_hybrid(prepared, jitter(cam, 0), cfg, 0, lights)[1]
    unlit = render_hybrid(prepared, jitter(cam, 0), cfg, 0, ())[1]
    torch.cuda.synchronize()
    same = torch.equal(again, s0)
    moved = (s0 - unlit).abs().max().item()
    levels = shadow_levels(prepared, cfg, lights, o0, jitter(cam, 0))
    log(f"render_hybrid {pipeline.name} 1080p/1M: {LIT_FRAMES} frames, launches "
        f"{ {m: k for m, k in seen.items() if k} } ({HYBRID_LAUNCHES[pipeline]} a frame); main "
        f"pass num_pairs={int(o0.num_pairs)} overflow={bool(o0.overflow)}; shaded max change "
        f"from no light {moved:.4f}; staircase levels over the covered pixels {levels}; repeat "
        f"bit-equal {same}")
    check(same, f"the repeat {pipeline.name} frame differs")
    check(moved > 1e-3, f"{pipeline.name}: the lights change nothing")
    check(all(len(v) >= 2 for v in levels.values()), f"{pipeline.name}: one level only")
    return seen[ISO_FORM]


def shadow_map_sizes(prepared, base, lights):
    """Each map's num_pairs, overflow and longest tile list (the cone of
    lights[0], the cube faces of lights[1])."""
    center, radius = scene_bounds(prepared)
    max_pairs = max(4 * prepared.means.shape[0], 1 << 18)
    cams = [("cone", light_camera(lights[0], center, radius, SHADOW_RES), SHADOW_RES)]
    cams += [(f"cube face {k}", c, CUBE_RES)
             for k, c in enumerate(cube_cameras(lights[1], radius, CUBE_RES))]
    for label, cam, res in cams:
        bins, _ = shadow_map_bins(prepared, cam, base.replace(width=res, height=res), max_pairs)
        log(f"shadow map {label} {res}^2: num_pairs={int(bins.num_pairs)} "
            f"overflow={bool(bins.overflow)} longest tile list={int(bins.tile_count.max())}")


def iso_kernel(dev, prepared, base, light, res, seed):
    """K1's multi-iso form on the cone map of ``light`` at res^2: against
    its twin on sampled tiles (rgb and T at K1's gate, the picks equal on
    ID_AGREE of (pixel, level)s); on the card, every tile, rows 0-3 equal
    to K1 gs2d's and row 4 + k to its pick at depth_iso = ISO_LEVELS[k], bit
    for bit; its kept counter and audit over every tile. Returns (max abs
    err, the kept share of its cull); logs the map's pairs and longest tile
    list."""
    center, radius = scene_bounds(prepared)
    cam = light_camera(light, center, radius, res)
    bins, st = shadow_map_bins(prepared, cam, base.replace(width=res, height=res),
                               max(4 * prepared.means.shape[0], 1 << 18))
    tiles = sample_tiles(bins, st, dev, seed)
    out, out_id = tr.rasterize_bins(bins, st)
    ref, _ = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start, bins.tile_count,
                                    st, tiles=tiles)
    torch.cuda.synchronize()
    err = (out[tiles, :4] - ref[:, :4]).abs().max().item()
    agree = (out[tiles, 4:] == ref[:, 4:]).float().mean().item()
    picked = [(out[:, 4 + k] > 0).float().mean().item() for k in range(tr.ISO_PICKS)]
    log(f"  K1 iso {res}^2 vs twin on {tiles.numel()} sampled tiles: max abs {err:.3e} (gate "
        f"{KERNEL_ATOL:g}), picks equal {agree:.6f} (gate {ID_AGREE}); ids all -1 "
        f"{bool((out_id == -1).all())}; share of texels picked per level "
        + " ".join(f"{x:.4f}" for x in picked))
    check(err <= KERNEL_ATOL and agree >= ID_AGREE, f"K1 iso {res}^2 vs twin: {err}, {agree}")
    check(bool((out_id == -1).all()), "K1 iso wrote an id")
    gs2d = dataclasses.replace(st, multi_iso=False)
    rows = torch.equal(out[:, :4], tr.rasterize_bins(bins, gs2d)[0][:, :4])
    picks = [torch.equal(out[:, 4 + k], tr.rasterize_bins(
        bins, dataclasses.replace(gs2d, depth_iso=level))[0][:, 4])
        for k, level in enumerate(ISO_LEVELS)]
    torch.cuda.synchronize()
    log(f"  K1 iso {res}^2 on the card, every tile: rows 0-3 equal K1 gs2d's bit for bit "
        f"{rows}; row 4 + k equals K1 gs2d's pick at depth_iso = ISO_LEVELS[k] {picks}")
    check(rows and all(picks), f"K1 iso {res}^2 differs from K1 gs2d")
    tr.rasterize_bins(bins, st)  # the kept counter of this launch
    work, kept = check_warp_cull(f"K1 iso {res}^2", bins, st, twin_tiles(st, dev))
    log(f"shadow map {res}^2: num_pairs={int(bins.num_pairs)} "
        f"longest tile list={int(bins.tile_count.max())}")
    return err, kept / (tr.WARPS * work[2])


def card_against_cpu(dev):
    """render_hybrid, HYBRID and HYBRID_3DGUT, at CARD_CPU_SIZE with
    CARD_CPU_SPLATS of the headline mix, on the card and on the CPU (the
    twins), with the headline lights: image and T at the card-against-CPU
    gate (at most 0.1 % of channels beyond 5e-5, none beyond 2e-3), the
    normals where 1 - T > 1e-2 likewise, and a shaded pixel beyond 1e-4 of
    the CPU's must read another staircase level on one of the devices or
    sit on a raster flip (its image beyond 5e-5; at most 0.1 % of pixels
    neither). Returns the max abs error of the images."""
    w, h = CARD_CPU_SIZE
    cpu = torch.device("cpu")
    scene = bench_scene(dev, CARD_CPU_SPLATS, seed=1)
    worst = 0.0
    for pipeline in (gt.Pipeline.HYBRID, gt.Pipeline.HYBRID_3DGUT):
        cfg = gt.RenderConfig(width=w, height=h, sh_degree=3, pipeline=pipeline)
        got = []
        for d in (dev, cpu):
            prepared = dataclasses.replace(
                scene, **{f: getattr(scene, f).detach().to(d) for f in FIELDS}).prepare()
            cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=d)
            lights = headline_lights(d)
            out, shaded, normals = render_hybrid(prepared, cam, cfg, 0, lights)
            got.append([x.detach().cpu() for x in (out.image, out.transmittance, normals,
                                                    shaded)]
                       + [(prepared, cfg, lights, out, cam)])
        (img_k, t_k, n_k, s_k, args_k), (img_c, t_c, n_c, s_c, args_c) = got
        diffs = [(img_k - img_c).abs(), (t_k - t_c).abs()]
        cover = (1 - t_k > 1e-2) & (1 - t_c > 1e-2)
        diffs.append((n_k - n_c).abs()[cover])
        beyond = ((s_k - s_c).abs() > 1e-4).any(dim=-1)
        other = torch.zeros_like(beyond)
        if bool(beyond.any()):  # the lookups (each device's maps again), only where needed
            lk, lc = (torch.stack(list(shadow_lookups(*a).values()), dim=-1).cpu()
                      for a in (args_k, args_c))
            other = (lk != lc).any(dim=-1)
        flip = ((img_k - img_c).abs() > 5e-5).any(dim=-1)  # a flipped cutoff in the raster pass
        unexplained = int((beyond & ~other & ~flip).sum())
        shares = [(x > 5e-5).float().mean().item() for x in diffs]
        log(f"card against CPU, render_hybrid {pipeline.name} {w}x{h}, {CARD_CPU_SPLATS} "
            f"splats: share beyond 5e-5 (image, T, normals) "
            + " ".join(f"{x:.2e}" for x in shares) + ", max "
            + " ".join(f"{x.max().item():.2e}" for x in diffs)
            + f"; shaded pixels beyond 1e-4 {int(beyond.sum())}, with another staircase "
            f"level {int((beyond & other).sum())}, on a raster flip {int((beyond & flip).sum())}"
            f", unexplained {unexplained}")
        check(all(x <= 1e-3 for x in shares) and all(x.max().item() <= 2e-3 for x in diffs),
              f"card against CPU ({pipeline.name}) outside the gate")
        check(unexplained <= 1e-3 * beyond.numel(), f"{pipeline.name}: unexplained shade")
        worst = max(worst, diffs[0].max().item())
    return worst


def lit_backward(dev, truth, cam, base, lights, bases):
    """One gradient of the lit frame's shaded image (a seeded weighting)
    from the jittered start: only K2 gs2d moves, twice (the pass and its
    normal buffer); finite and repeatable; each launch's context rebuilt
    from the two passes (``normal_bins``, ``normals_from_blend``) and K2
    against its twin with it on sampled tiles (``gate_bwd_against_twin``).
    Returns the max abs error."""
    splats = jittered_start(truth, dev, seed=0)
    for f in FIELDS:
        getattr(splats, f).requires_grad_()
    w = torch.randn((HEIGHT, WIDTH, 3), generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev)

    def gradient():
        for f in FIELDS:
            getattr(splats, f).grad = None
        shaded = render_3dgs_lit(splats.prepare(), cam, base, 0, lights, LIT_MATERIALS, bases)[1]
        (shaded * w).sum().backward()
        return [x.clone() for x in grads_of(splats)]

    tr.zero_counters(tr.rasterize_tiles_bwd, tr.TRAINED)
    first = gradient()
    torch.cuda.synchronize()
    seen = only("the lit frame's gradient", tr.rasterize_tiles_bwd, "gs2d", 2)
    same = all(torch.equal(a, b) for a, b in zip(first, gradient()))
    finite = all(bool(torch.isfinite(x).all()) for x in first)
    log(f"lit frame gradient: launches {seen}, finite {finite}, repeat bit-equal {same}")
    check(same and finite, "the lit frame's gradient: not finite or not repeatable")
    del first

    prepared = splats.prepare()
    st = dataclasses.replace(raster_statics(base), model="gs2d")
    proj = project_splats(prepared, cam, base)
    rows, ids = gs_attr_rows(proj)
    main = bin_for_cfg(proj, rows, ids, pairs_cfg(base), 0, st)
    norm = normal_bins(prepared, proj, cam, base, st)
    out, out_id = tr.rasterize_bins(main, st)
    out_n, id_n = tr.rasterize_bins(norm, st)
    out, out_n = out.detach().requires_grad_(), out_n.detach().requires_grad_()
    img, trans, depth, sid = tr.assemble_image(out, out_id, st.tiles_x, st.tiles_y, WIDTH,
                                               HEIGHT, base.background)
    shaded = deferred_shade(img, trans, normals_from_blend(out_n, id_n, st, base), depth, cam,
                            base, list(lights), LIT_MATERIALS,
                            set_index_img=instance_index_image(sid, bases))
    grads = torch.autograd.grad((shaded * w).sum(), [out, out_n])
    worst = 0.0
    for (label, bins, o, g), seed in zip((("main pass", main, out, grads[0]),
                                          ("normal buffer", norm, out_n, grads[1])), (29, 31)):
        full = tr.bwd_context(o.detach(), g)
        tiles = sample_tiles(bins, st, dev, seed)
        keep = torch.zeros(st.tiles_x * st.tiles_y, dtype=torch.bool, device=dev)
        keep[tiles] = True
        ctx = full * keep[:, None, None]
        attrs = bins.attrs.detach()
        d_k = tr.rasterize_tiles_bwd(attrs, bins.tile_start, bins.tile_count, ctx, st)

        def twin(cx, bins=bins, attrs=attrs, tiles=tiles):
            return sum(tr.rasterize_tiles_bwd_ref(attrs, bins.tile_start, bins.tile_count, cx,
                                                  st, tiles=t)
                       for t in twin_tiles(st, dev, tiles))

        cols = ((d_k != 0) | (twin(ctx) != 0)).any(dim=0)
        s_total = full[:, 3].abs().max().item()
        log(f"  the {label}'s S_total: max |S_total| {s_total:.3e}")
        abs_err, _ = gate_bwd_against_twin(f"K2 ({label} of the lit frame)", d_k, twin, ctx,
                                           cols, swap_not_suffix=label == "normal buffer")
        worst = max(worst, abs_err)
    return worst


def lighting(dev, truth: gt.SplatSet):
    """Phase 11 at the headline cell: ``render_3dgs_lit`` (``lit_frame``),
    ``render_hybrid`` HYBRID and HYBRID_3DGUT (``hybrid_main_path``), the
    shadow maps' sizes, K1's multi-iso form on the cone map and a 2048^2
    map (``iso_kernel``), the card against the CPU (``card_against_cpu``)
    and the lit frame's gradient (``lit_backward``). Returns {name:
    entry}."""
    t0 = time.perf_counter()
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    lights = headline_lights(dev)
    prepared = truth.prepare()
    center, radius = scene_bounds(prepared)
    log(f"lighting: lights directional {lights[0].direction.tolist()} and point "
        f"{lights[1].position.tolist()} ({float(torch.linalg.norm(lights[1].position - center)):.3f}"
        f" from the centre of a bounding sphere of radius {float(radius):.3f})")
    lit_prepared, table = halves_scene(truth).flatten()
    lit_frame(lit_prepared, cam, base, lights, table.instance_base)
    del lit_prepared
    launches = sum(hybrid_main_path(prepared, cam, base, lights, p)
                   for p in (gt.Pipeline.HYBRID, gt.Pipeline.HYBRID_3DGUT))
    shadow_map_sizes(prepared, base, lights)
    err, share = iso_kernel(dev, prepared, base, lights[0], SHADOW_RES, 37)
    err_big, _ = iso_kernel(dev, prepared, base, lights[0], BIG_SHADOW_RES, 41)
    err_cpu = card_against_cpu(dev)
    err_bwd = lit_backward(dev, truth, cam, base, lights, table.instance_base)
    log(f"lighting phase {time.perf_counter() - t0:.1f} s; card against CPU max {err_cpu:.3e}, "
        f"K2 in the lit gradient max {err_bwd:.3e}")
    return {ISO_NAME: dict(launches=launches, max_abs_err=max(err, err_big), kept_share=share)}


# ---- ray tracing (render_3dgrt_exact, render_hybrid with rt.shadows="ray",
# render_composed_wavefront): the tracer of ops/raytrace.py -----------------------
#
# The tracer is plain torch (the JAX tracer reaches no Pallas call): each
# sweep step is some 50 elementwise launches over a (rays, splats of the
# chunk) tensor. A step runs at some 2.7e9 (ray, splat) evaluations a second
# on an H100 (21.1 s per light of 320x180 shadow rays through 1 M splats;
# PERF.md §6), so the phase cuts, each logged where it applies:
# - the ray-shadowed hybrid frames at RT_SHADE_SIZE, 160x90: the shade
#   points, not the splats (users load the whole scene; the cost grows with
#   both); at 320x180 a frame took 42.3 s;
# - the wavefront's secondary rays at stride RT_STRIDE, 16 (120 x 68 rays):
#   at stride 8 the frame took 37.9 s;
# - the wavefront's secondary rays in the radial order: rt.order "auto"
#   picks the windowed order on this batch (its origins spread over the
#   mirror and the glass), which costs rt.max_passes times as much;
# - the card against the port's CPU run on RT_CHECK_RAYS evenly spaced rays
#   of each batch: the CPU traces a million splats at some 3e7 (ray, splat)
#   evaluations a second.

RT_SHADE_SIZE = (160, 90)      # the ray-shadowed hybrid frames
RT_STRIDE, RT_BOUNCES = 16, 3  # the wavefront: 120 x 68 secondary rays, 3 bounces
RT_CHECK_RAYS = 128            # rays of each batch the CPU run checks
RT_TEST_SCENE = (13, 150)     # tests/test_grt.py:99-103's scene: seed, splats
RT_TEST_PASSES = 48
RT_PSNR_MIN = 35.0
RT_ATOL, RT_AGREE, RT_FLIP = 1e-4, 0.999, 1.2e-2  # tests/test_torch_raytrace.py's gates


def wavefront_mesh() -> ObjMesh:
    """Phase 10's ``headline_mesh`` with the sphere glass (illum 2, ior 1.5,
    transmittance 0.9) and the ground grid a mirror (illum 1, specular
    0.9): the materials of tests/test_raytrace.py."""
    glass = ObjMaterial(name="glass", diffuse=(0.02, 0.02, 0.02), specular=(0.1, 0.1, 0.1),
                        transmittance=(0.9, 0.9, 0.9), ior=1.5, illum=2)
    mirror = ObjMaterial(name="mirror", diffuse=(0.05, 0.05, 0.05), specular=(0.9, 0.9, 0.9),
                         illum=1)
    return dataclasses.replace(headline_mesh(), materials=[glass, mirror])


def every_nth(r: int) -> torch.Tensor:
    """RT_CHECK_RAYS evenly spaced indices of a batch of r rays."""
    return torch.linspace(0, r - 1, min(r, RT_CHECK_RAYS)).long()


def cpu_copy(obj):
    """A dataclass of tensors (splats, lights, meshes) on the CPU."""
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu()
                                       for f in dataclasses.fields(obj)})


def trace_agreement(label, got, want) -> float:
    """The tracer's gate on (rays, ...) values: within RT_ATOL on >= 99.9 %
    of rays, none beyond RT_FLIP. Returns the max."""
    per = (got.detach().cpu() - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    share = (per <= RT_ATOL).float().mean().item()
    log(f"{label}: card against CPU max {per.max().item():.3e}, share within {RT_ATOL} "
        f"{share:.6f} of {per.numel()} rays")
    check(share >= RT_AGREE and per.max().item() <= RT_FLIP, f"{label}: card against CPU")
    return per.max().item()


def check_splat_trace(label, prepared, o, d, tmin, tmax, cfg, **kw) -> float:
    """trace_splats on a batch's checked rays: the card against the CPU
    (radiance, T, the iso depth's pick), a bit-equal repeat, and the pass
    and any-hit estimators finite with T 0 or 1 (tests/test_torch_cuda.py
    repeats each estimator bit for bit). Returns the max difference."""
    pick = every_nth(o.shape[0]).to(o.device)
    args = [x[pick] for x in (o, d, tmin, tmax)]
    card = rt.trace_splats(prepared, *args, cfg, **kw)
    again = rt.trace_splats(prepared, *args, cfg, **kw)
    cpu = rt.trace_splats(cpu_copy(prepared), *[x.cpu() for x in args], cfg, **kw)
    same = all(torch.equal(getattr(card, f), getattr(again, f))
               for f in ("radiance", "transmittance", "depth"))
    err = max(trace_agreement(f"{label} radiance", card.radiance, cpu.radiance),
              trace_agreement(f"{label} T", card.transmittance, cpu.transmittance))
    dc = cpu.depth
    depth_same = ((card.depth.cpu() - dc).abs() <= 1e-5 * dc.abs().clamp(min=1.0)).float().mean()
    est = {}
    for mode in ("pass", "anyhit"):
        a = rt.trace_splats(prepared, *args, cfg, stochastic=mode, seed=3, **kw)
        t = a.transmittance
        est[mode] = (bool(torch.isfinite(a.radiance).all()) and bool(((t == 0) | (t == 1)).all()),
                     float((t == 0).float().mean()))
    log(f"{label}: {pick.numel()} rays, iso-depth picks equal {depth_same.item():.6f}, card repeat "
        f"bit-equal {same}; estimators finite with T in (0, 1) (share T = 0): "
        + ", ".join(f"{m} {ok} ({z:.4f})" for m, (ok, z) in est.items()))
    check(same and depth_same.item() >= RT_AGREE, f"{label}: repeat or iso depth")
    check(all(ok for ok, _ in est.values()), f"{label}: an estimator")
    return err


def exact_tier(dev):
    """``render_3dgrt_exact``: the 150-splat scene of tests/test_grt.py
    (max_passes 48) above RT_PSNR_MIN against the raster ``render_3dgrt``
    (gated); the golden scene at its 256x192 (max_passes 32), its PSNR
    against the raster frame logged (not gated), and its primary rays
    checked. Returns the max difference."""
    seed, n = RT_TEST_SCENE
    d = interop.random_splat_arrays(seed, n, sh_degree=0, scale_range=(-2.2, -1.2))
    small = interop.splat_set_from_numpy(d, dev).prepare()
    cfg = gt.RenderConfig(width=64, height=48, sh_degree=0)
    cfg = cfg.replace(rt=dataclasses.replace(cfg.rt, max_passes=RT_TEST_PASSES))
    cam = gt.look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], 64, 48, fov_y_rad=0.9, device=dev)
    tr.zero_counters(tr.rasterize_tiles)
    exact = render_3dgrt_exact(small, cam, cfg)
    torch.cuda.synchronize()
    seen = counts(tr.rasterize_tiles)
    check(not any(seen.values()), f"render_3dgrt_exact launched a blend: {seen}")
    raster = render_3dgrt(small, cam, cfg, 1 << 16)
    psnr = psnr_against(exact.image.clamp(0, 1), raster.image.clamp(0, 1))
    log(f"render_3dgrt_exact {n} splats 64x48 max_passes {RT_TEST_PASSES}: {psnr:.3f} dB "
        f"against render_3dgrt (gate > {RT_PSNR_MIN})")
    check(psnr > RT_PSNR_MIN, f"render_3dgrt_exact: {psnr} dB")

    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    gcfg = gt.RenderConfig(width=w, height=h, sh_degree=0)
    gcam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)
    golden = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device=dev).prepare()
    out = render_3dgrt_exact(golden, gcam, gcfg)
    raster = render_3dgrt(golden, gcam, gcfg)
    psnr = psnr_against(out.image.clamp(0, 1), raster.image.clamp(0, 1))
    finite = bool(torch.isfinite(out.image).all()) and bool(torch.isfinite(out.depth).all())
    log(f"render_3dgrt_exact golden {w}x{h}, {golden.means.shape[0]} splats, max_passes "
        f"{gcfg.rt.max_passes}: {psnr:.3f} dB against render_3dgrt (reported, not gated); "
        f"finite {finite}")
    check(finite, "render_3dgrt_exact golden: not finite")
    # its primary rays, as render_3dgrt_exact makes them
    ys, xs = torch.meshgrid(torch.arange(h, device=dev) + 0.5, torch.arange(w, device=dev) + 0.5,
                            indexing="ij")
    d_cam = torch.stack([(xs - gcam.cx) / gcam.fx, (ys - gcam.cy) / gcam.fy,
                         torch.ones_like(xs)], -1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    dirs = (d_cam.reshape(-1, 3)[:, :, None] * gcam.viewmat[None, :3, :3]).sum(dim=1)
    o = gcam.position.expand(dirs.shape)
    err = check_splat_trace("exact tier golden primary rays (windowed)", golden, o, dirs,
                            torch.zeros(w * h, device=dev),
                            torch.full((w * h,), float("inf"), device=dev), gcfg,
                            chunk=512, ray_block=4096, order="windowed")
    return err


def recorded_ray_shadows(records: list):
    """``render/shadows.make_ray_shadow_fn`` whose shadow functions append
    their answers to ``records`` (render_hybrid builds its shadow function
    when it is called, so the frame's own traces are recorded)."""
    real = shadows.make_ray_shadow_fn

    def make(*a, **kw):
        fn = real(*a, **kw)

        def shadow_fn(world_pos, light):
            out = fn(world_pos, light)
            records.append(out)
            return out
        return shadow_fn
    return make


def ray_shadowed_hybrid(dev, prepared, lights):
    """``render_hybrid`` with ``rt.shadows="ray"`` at RT_SHADE_SIZE, HYBRID
    and HYBRID_3DGUT, one frame each through ``render_hybrid`` with every
    launch counter of K1's wrapper zeroed (the blend's form twice: the
    pass and its normal buffer; no shadow map), each light's shadow trace
    within it recorded (``recorded_ray_shadows``), the shaded frame finite
    and unlike the one with no light; HYBRID's shadow rays of one light
    checked on the CPU. Returns the max difference."""
    w, h = RT_SHADE_SIZE
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)
    errs = []
    for pipeline, form in ((gt.Pipeline.HYBRID, "gs2d"), (gt.Pipeline.HYBRID_3DGUT, "gut3d")):
        cfg = gt.RenderConfig(width=w, height=h, sh_degree=3, pipeline=pipeline,
                              rt=gt.RtConfig(shadows="ray"))
        records = []
        shadows.make_ray_shadow_fn = recorded_ray_shadows(records)
        tr.zero_counters(tr.rasterize_tiles)
        try:
            out, shaded, normals = render_hybrid(prepared, cam, cfg, 0, lights)
        finally:
            shadows.make_ray_shadow_fn = make_ray_shadow_fn
        seen = only(f"render_hybrid {pipeline.name} ray shadows", tr.rasterize_tiles, form, 2)
        check(len(records) == len(lights), f"{len(records)} shadow traces")
        unlit = render_hybrid(prepared, cam, cfg, 0, ())[1]
        covered = out.depth > 0
        finite = bool(torch.isfinite(shaded).all()) and bool(torch.isfinite(normals).all())
        moved = (shaded - unlit).abs().max().item()
        log(f"render_hybrid {pipeline.name} rt.shadows=ray {w}x{h}, 1M splats, {len(lights)} "
            f"lights (the frame's {w * h} shade points, chunk 256, radial): launches {seen}; "
            f"covered {covered.float().mean():.4f}; "
            + ", ".join(f"light {i} shadowed (T < 0.5) share of covered pixels "
                        f"{(t[covered] < 0.5).float().mean():.4f}" for i, t in enumerate(records))
            + f"; shaded max change from no light {moved:.4f}; finite {finite}")
        check(finite and moved > 1e-3, f"render_hybrid {pipeline.name} ray shadows")
        if pipeline != gt.Pipeline.HYBRID:
            continue
        # the shadow rays of light 1 (the enclosed point light) on the CPU
        fn = make_ray_shadow_fn(prepared, cfg)
        p = surface_points(out.depth, cam).reshape(-1, 3)[every_nth(w * h).to(dev)]
        got = fn(p, lights[1])
        want = make_ray_shadow_fn(cpu_copy(prepared), cfg)(p.cpu(), cpu_copy(lights[1]))
        errs.append(trace_agreement(f"{pipeline.name} shadow rays of light 1", got, want))
        again = fn(p, lights[1])
        check(torch.equal(again, got), f"{pipeline.name} shadow rays: repeat")
    return max(errs)


def wavefront_frame(dev, prepared, lights):
    """``render_composed_wavefront`` at the headline cell: the mesh of
    ``wavefront_mesh``, stride RT_STRIDE, RT_BOUNCES bounces, the exact
    expansion at COMPOSED_MAX_PAIRS, one frame through the entry point with
    every launch counter of K1's wrapper zeroed (tri2d_smooth and
    gs2d_clip once each: the tracer launches no kernel); then the same
    frame's bounces step by step (spawn; per bounce trace_mesh,
    trace_splats, the rest), with the live rays per bounce; the
    step-by-step radiance equal to the entry point's bit for bit; the first
    bounce's rays checked on the CPU. Returns the max difference."""
    mesh = mr.mesh_buffers_from_obj(wavefront_mesh(), device=dev)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, expansion="exact"),
                      rt=dataclasses.replace(cfg.rt, order="radial"))
    tr.zero_counters(tr.rasterize_tiles)
    frame, final = render_composed_wavefront(prepared, cam, cfg, COMPOSED_MAX_PAIRS, mesh, lights,
                                             RT_BOUNCES, RT_STRIDE)
    seen = counts(tr.rasterize_tiles)
    check(seen == {m: int(m in ("tri2d_smooth", "gs2d_clip")) for m in seen},
          f"render_composed_wavefront: launches {seen}")
    finite = bool(torch.isfinite(final).all())
    added = (final - frame.image).amax(dim=-1)
    log(f"render_composed_wavefront {WIDTH}x{HEIGHT}, 1M splats, "
        f"{mesh.indices.shape[0]} faces (glass sphere, mirror ground), stride {RT_STRIDE}, "
        f"{RT_BOUNCES} bounces, rt.order radial: launches "
        f"{ {m: k for m, k in seen.items() if k} }; splat pass overflow {bool(frame.overflow)}; "
        f"pixels the bounces brighten by > 1e-3 "
        f"{(added > 1e-3).float().mean():.4f}; finite {finite}")
    check(finite and not bool(frame.overflow) and (added > 1e-3).any(),
          "render_composed_wavefront: not finite, overflowed or no bounce light")

    # the same frame step by step
    composed, splat_trans, face_id = pipelines._composed_frame(prepared, cam, cfg,
                                                               COMPOSED_MAX_PAIRS, mesh, lights)
    o, d, thr, mask, shape_lr = wavefront.secondary_spawn(cam, cfg, mesh, face_id, splat_trans,
                                                          RT_STRIDE)
    r = o.shape[0]
    auto = gt.RenderConfig(sh_degree=3)
    centroid = o.mean(dim=0)
    spread = torch.linalg.norm(o - centroid, dim=-1).mean().item()
    med = torch.linalg.norm(prepared.means - centroid, dim=-1).median().item()
    log(f"wavefront spawn: {r} secondary rays ({shape_lr[0]}x{shape_lr[1]}), "
        f"{int(mask.sum())} on mirror or glass; origin spread "
        f"{spread:.3f} against 0.1 x the splats' median distance {0.1 * med:.3f}: rt.order "
        f"{auto.rt.order!r} would trace them "
        f"{'windowed' if spread > 0.1 * med else 'radial'} (cut: radial)")
    face_nrm = wavefront._face_geometric_normals(mesh)
    radiance = torch.zeros_like(thr)
    err = 0.0
    for b in range(RT_BOUNCES):
        live = int((thr.amax(dim=-1) > 0).sum())
        eps = o.new_full((r,), wavefront.EPS_T)
        mh = rt.trace_mesh(mesh.positions, mesh.indices, o, d, eps)
        ts = rt.trace_splats(prepared, o, d, eps, mh.t, cfg)
        if b == 0:
            err = wavefront_check(prepared, mesh, o, d, eps, cfg)
        radiance = radiance + thr * ts.radiance
        thr = thr * ts.transmittance[:, None]
        face = torch.clamp(mh.face, min=0).long()
        hit_pos = o + d * torch.where(mh.hit, mh.t, 0.0)[:, None]
        nrm = face_nrm[face]
        shade = wavefront._shade_mesh_hit(hit_pos, nrm, d, mesh, face, lights, cam)
        radiance = radiance + torch.where(mh.hit[:, None], thr * shade, 0.0)
        new_d, factor, alive = wavefront._bounce_dispatch(d, nrm, mesh, face)
        cont = mh.hit & alive
        thr = torch.where(cont[:, None], thr * factor, 0.0)
        keep = torch.amax(thr, dim=-1) > cfg.rt.min_transmittance
        thr = torch.where(keep[:, None], thr, 0.0)
        o, d = hit_pos, torch.where(cont[:, None], new_d, d)
        log(f"wavefront bounce {b + 1}: live rays {live} of {r}, mesh hits "
            f"{int(mh.hit.sum())}")
    stepwise = wavefront.add_secondary_radiance(composed.image, radiance, shape_lr, cfg)
    same = torch.equal(stepwise, final)
    log(f"wavefront step by step equals the entry point's frame bit for bit: {same}")
    check(same, "wavefront: the step-by-step frame differs")
    return err


def wavefront_check(prepared, mesh, o, d, eps, cfg) -> float:
    """The first bounce's checked rays: trace_mesh (face ids equal, t within
    1e-5 relative, a bit-equal repeat) and trace_splats within the CPU's
    mesh hits, card against CPU."""
    pick = every_nth(o.shape[0]).to(o.device)
    args = [x[pick] for x in (o, d, eps)]
    card = rt.trace_mesh(mesh.positions, mesh.indices, *args)
    again = rt.trace_mesh(mesh.positions, mesh.indices, *args)
    cpu_mesh = cpu_copy(mesh)
    cpu = rt.trace_mesh(cpu_mesh.positions, cpu_mesh.indices, *[x.cpu() for x in args])
    hit = cpu.hit
    faces = torch.equal(card.face.cpu(), cpu.face) and torch.equal(card.hit.cpu(), hit)
    t_err = ((card.t.cpu()[hit] - cpu.t[hit]).abs() / cpu.t[hit].abs()).max().item() \
        if hit.any() else 0.0
    same = torch.equal(card.t, again.t) and torch.equal(card.face, again.face)
    log(f"wavefront bounce 1 trace_mesh: {pick.numel()} rays, {int(hit.sum())} hits, face ids "
        f"equal {faces}, t max relative difference {t_err:.3e}, repeat bit-equal {same}")
    check(faces and t_err <= 1e-5 and same, "wavefront trace_mesh: card against CPU")
    tmax = cpu.t.to(o.device)
    full = torch.full((o.shape[0],), float("inf"), device=o.device)
    full[pick] = tmax
    return check_splat_trace("wavefront bounce 1 splat rays (radial)", prepared, o, d, eps, full,
                             cfg, order="radial")


def raytracing(dev, truth: gt.SplatSet):
    """Phase 12: the exact tier (``exact_tier``), the ray-shadowed hybrid
    frames (``ray_shadowed_hybrid``) with phase 11's two lights, and the
    wavefront frame (``wavefront_frame``) with them, on the headline scene
    (1M splats, SH 3). Every image finite; each batch's checked rays on the
    card against the CPU; no kernel of this slice (the tracer is plain
    torch), so the report gains no entry."""
    t0 = time.perf_counter()
    lights = headline_lights(dev)
    prepared = truth.prepare()
    with torch.no_grad():
        err_exact = exact_tier(dev)
        err_shadow = ray_shadowed_hybrid(dev, prepared, lights)
        err_wave = wavefront_frame(dev, prepared, lights)
    log(f"ray tracing phase {time.perf_counter() - t0:.1f} s; card against CPU max: exact "
        f"{err_exact:.3e}, shadow rays {err_shadow:.3e}, wavefront {err_wave:.3e}")


# ---- instances, project files and the inspection tools (SplatScene.flatten,
# io/project, ops/metrics, ops/compare, render/helpers, debug) -------------
#
# Plain torch on top of the raster path: the instanced frames launch K1 gs2d
# (pairs, exact expansion), K3 gs2d (bucket) and, in the lit frame with one
# material per instance, K1 gs2d twice; the pixel-trace checks render 3DGUT
# and 3DGRT (K1g). The asset is the headline mix at a quarter of its splats,
# placed four times (identity, rigid, general, rigid with an opacity gain
# and a splat scale) and once invisibly: 1 M splats after the flatten. The
# card is held to the port on the CPU (the flatten at the CPU tests'
# tolerances; the metrics and the overlays on crops within INST_ATOL), the
# frames to the kernels' twins, the project round trip and the repeats bit
# for bit, the traces to the frames (pixels the blend never freezes).

INST_SPLATS = 250_000          # the asset; four visible instances flatten to 1 M
INST_MAX_PAIRS = 1 << 23       # the exact expansion's budget on the instanced frame
INST_ATOL = 1e-5               # card against CPU: metrics and overlays on crops
INST_RTOL = 1e-6               # card against CPU: the flatten, of a row's scale
METRIC_CROP, HELPER_SIZE = (256, 144), (320, 180)
TRACE_PIXELS, GUT_TRACE_PIXELS = 16, 4
TRACE_ATOL, GUT_TRACE_ATOL = 2e-5, 2e-2  # tests/test_torch_inspect.py's gates
TRACE_T_MIN = 1e-3             # 10x above the blend's freeze at T < 1e-4
INST_MATERIALS = LIT_MATERIALS + (
    DeferredMaterial(diffuse=(1.0, 0.4, 0.3), emission=(0.03, 0.0, 0.0)),
    DeferredMaterial(diffuse=(0.4, 1.0, 0.5), specular=(0.8, 0.8, 0.8), shininess=48.0))


def axis_angle(axis, angle) -> np.ndarray:
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def affine(linear, t) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = linear
    m[:3, 3] = t
    return m


def instance_specs():
    """The five instances (SplatScene.add_instance keywords): identity; a
    35 degree turn about an oblique axis, scale 0.8; diag(1.4, 0.7, 1.0)
    with a 0.25 shear (the general bake); a rigid one with opacity_gain 0.6
    and splat_scale 1.25; an invisible one. Each visible one shows in the
    headline camera (asset means in [-4, 4]^3)."""
    return [dict(name="identity"),
            dict(transform=affine(0.8 * axis_angle([1.0, 2.0, 0.5], np.radians(35.0)),
                                  (5.0, 1.5, 2.5)), name="rigid"),
            dict(transform=affine([[1.4, 0.25, 0.0], [0.0, 0.7, 0.0], [0.0, 0.0, 1.0]],
                                  (-5.5, -1.5, 2.5)), name="general"),
            dict(transform=affine(0.7 * axis_angle([0.0, 1.0, 0.3], 0.9), (0.5, 4.0, 5.0)),
                 opacity_gain=0.6, splat_scale=1.25, name="faded"),
            dict(transform=affine(np.eye(3), (0.0, -3.0, 0.0)), visible=False, name="hidden")]


def instanced_scene(asset) -> SplatScene:
    scene = SplatScene()
    a = scene.add_asset(asset, "headline quarter")
    for kw in instance_specs():
        scene.add_instance(a, **kw)
    return scene


def rows_rel(a: torch.Tensor, b: torch.Tensor, scale=None) -> float:
    """max |a - b| / scale row by row (scale: the row's largest |a|)."""
    a, b = a.reshape(a.shape[0], -1).double(), b.to(a.device).reshape(b.shape[0], -1).double()
    if scale is None:
        scale = a.abs().amax(dim=1, keepdim=True)
    return ((a - b).abs() / scale.clamp_min(1e-30)).max().item() if a.numel() else 0.0


def cov_rel_f64(prepared) -> float:
    """max over splats of |cov3d - its float64 value| / trace, the float64
    covariance formed from the same (scales_log, quats)."""
    c64 = covariance_from_scale_rot(prepared.scales_log.double(), prepared.quats.double())
    return rows_rel(c64, prepared.cov3d, c64[:, [0, 3, 5]].sum(dim=1, keepdim=True))


def flatten_on_card_and_cpu(scene, scene_cpu):
    """The flatten on the card against the port on the CPU: the table
    exactly; means, scales, quats, colour and SH within INST_RTOL of the
    row's scale (the general instance by its means, colour and SH: its
    scales and quats come from one host bake); cov3d on each device within
    INST_RTOL of its trace from the float64 covariance of its own scales
    and quats (tests/test_torch_scene.py's bound; the card's and the CPU's
    roundings of exp add up between them, so that difference is logged).
    Returns the card's (prepared, table)."""
    prepared, table = scene.flatten()
    p_cpu, t_cpu = scene_cpu.flatten()
    torch.cuda.synchronize()
    check(torch.equal(table.instance_id.cpu(), t_cpu.instance_id)
          and torch.equal(table.local_id.cpu(), t_cpu.local_id)
          and np.array_equal(table.instance_base, t_cpu.instance_base),
          "the global index table differs between the card and the CPU")
    worst = {}
    live = [i for i in scene.instances if i.visible]
    for k, inst in enumerate(live):
        rows = slice(int(table.instance_base[k]), int(table.instance_base[k + 1]))
        general = inst.name == "general"
        for f in ("means", "color", "sh") + (() if general else ("scales_log", "quats")):
            worst[f] = max(worst.get(f, 0.0), rows_rel(getattr(prepared, f)[rows],
                                                       getattr(p_cpu, f)[rows]))
    worst["cov3d_card_f64"] = cov_rel_f64(prepared)
    worst["cov3d_cpu_f64"] = cov_rel_f64(p_cpu)
    apart = rows_rel(prepared.cov3d, p_cpu.cov3d,
                     prepared.cov3d[:, [0, 3, 5]].sum(dim=1, keepdim=True).double())
    log(f"flatten card against CPU: table equal; worst of a row's scale "
        + " ".join(f"{f}={e:.3e}" for f, e in worst.items()) + f" (gate {INST_RTOL:g}); "
        f"cov3d card against CPU {apart:.3e} of the trace")
    check(max(worst.values()) <= INST_RTOL, f"the flatten on the card: {worst}")
    return prepared, table


def instance_shares(out, table) -> list[float]:
    """Each visible instance's share of the frame's pixels (its splats
    picked)."""
    sid = out.splat_id.flatten()
    picked = sid[sid >= 0].long()
    n = len(table.instance_base) - 1
    counts = torch.bincount(table.instance_id[picked], minlength=n)
    return (counts.double() / sid.numel()).tolist()


def instanced_frames(dev, prepared, table, cam, cfg):
    """INST frames on pairs (exact expansion) and on bucket (caps fitted over
    the jittered cameras): each main path with the wrapper's counters zeroed
    (one gs2d launch a frame), finite, no overflow, a bit-equal repeat;
    K1 and K3 against their twins on sampled tiles. Returns (pairs frame 0,
    K1's and K3's (launches, error))."""
    pcfg = cfg.replace(raster=gt.RasterConfig(expansion="exact"))
    cams = [jitter(cam, i) for i in range(FRAMES)]
    tr.zero_counters(tr.rasterize_tiles)
    outs = [render(prepared, c, pcfg, max_pairs=INST_MAX_PAIRS) for c in cams]
    torch.cuda.synchronize()
    seen1 = only("instanced pairs frames", tr.rasterize_tiles, "gs2d", FRAMES)
    for o in outs:
        check(bool(torch.isfinite(o.image).all()) and not bool(o.overflow),
              "an instanced pairs frame: not finite or overflowed")
    o0 = outs[0]
    del outs
    again = render(prepared, cams[0], pcfg, max_pairs=INST_MAX_PAIRS)
    same_p = all(torch.equal(getattr(again, f), getattr(o0, f))
                 for f in ("image", "transmittance", "depth", "splat_id"))
    shares = instance_shares(o0, table)
    log(f"instanced pairs 1080p/1M (exact, {INST_MAX_PAIRS} pairs): launches {seen1}, "
        f"num_pairs={int(o0.num_pairs)}, covered {(o0.transmittance < 0.5).float().mean():.4f}, "
        f"instances' shares of the pixels " + "/".join(f"{s:.4f}" for s in shares)
        + f", repeat bit-equal {same_p}")
    check(same_p, "the instanced pairs frame's repeat differs")
    check(all(s > 1e-3 for s in shares), f"an instance does not show: {shares}")

    caps, req = fitted_caps(prepared, cams, cfg)
    bcfg = bucket_cfg(cfg, caps)
    if any(bool(render(prepared, c, bcfg).overflow) for c in cams):
        caps = tuple(2 * c for c in caps)
        bcfg = bucket_cfg(cfg, caps)
    tr.zero_counters(rb.rasterize_buckets)
    outs = [render(prepared, c, bcfg) for c in cams]
    torch.cuda.synchronize()
    seen3 = only("instanced bucket frames", rb.rasterize_buckets, "gs2d", FRAMES)
    for o in outs:
        check(bool(torch.isfinite(o.image).all()) and not bool(o.overflow),
              "an instanced bucket frame: not finite or overflowed")
    b0 = outs[0]
    del outs
    again = render(prepared, cams[0], bcfg)
    same_b = all(torch.equal(getattr(again, f), getattr(b0, f))
                 for f in ("image", "transmittance", "depth", "splat_id"))
    diff = (b0.image - o0.image).abs().amax(dim=-1)
    share = (diff <= BUCKET_VS_PAIR_ATOL).float().mean().item()
    log(f"instanced bucket 1080p/1M: required caps {req}, caps {list(caps)}, launches {seen3}, "
        f"against the exact pair frame {share:.6f} of pixels within {BUCKET_VS_PAIR_ATOL:g}, "
        f"repeat bit-equal {same_b}")
    check(same_b and share >= BUCKET_VS_PAIR_SHARE, "the instanced bucket frame")
    del again, b0, diff

    st = raster_statics(pcfg)
    bins = bins_of(prepared, cam, pcfg, INST_MAX_PAIRS)
    err1 = mesh_fwd_gate("K1 gs2d, instanced frame", bins, st, None,
                         sample_tiles(bins, st, dev, 19))
    del bins
    bst = bucket_statics(bcfg)
    bbins = bins_of(prepared, cam, bcfg)
    tiles = sample_bucket_tiles(bbins, bst, dev, 19)
    err3, agree3 = compare_k3_with_twin(bbins, bst, caps, tiles=tiles)
    log(f"  K3 gs2d vs twin on {tiles.numel()} sampled tiles of the instanced frame: max abs "
        f"{err3:.3e}, id agreement {agree3:.6f}")
    check(err3 <= KERNEL_ATOL and agree3 >= ID_AGREE, f"instanced K3 vs twin {err3}, {agree3}")
    del bbins
    return o0, (seen1["gs2d"], err1), (seen3["gs2d"], err3)


def instanced_lit(prepared, table, cam, cfg, lights):
    """render_3dgs_lit with one material per instance, routed by the real
    table: only K1 gs2d moves (twice), finite, repeatable, every material
    in view, and the material index image equal to the table's instance of
    each picked splat. Returns K1's launches."""
    base = table.instance_base
    tr.zero_counters(tr.rasterize_tiles)
    out, shaded, normals = render_3dgs_lit(prepared, cam, cfg, 0, lights, INST_MATERIALS, base)
    torch.cuda.synchronize()
    seen = only("the instanced lit frame", tr.rasterize_tiles, "gs2d", 2)
    again = render_3dgs_lit(prepared, cam, cfg, 0, lights, INST_MATERIALS, base)
    same = torch.equal(again[1], shaded) and torch.equal(again[0].splat_id, out.splat_id)
    picked = out.splat_id >= 0
    sets = instance_index_image(out.splat_id, base)
    routed = torch.equal(sets[picked], table.instance_id[out.splat_id[picked].long()])
    used = torch.unique(sets[picked]).tolist()
    finite = bool(torch.isfinite(shaded).all()) and bool(torch.isfinite(normals).all())
    log(f"instanced render_3dgs_lit 1080p/1M: launches {seen}, materials in view {used}, "
        f"material index = the table's instance of the picked splat {routed}, finite {finite}, "
        f"repeat bit-equal {same}")
    check(routed and finite and same and used == list(range(len(INST_MATERIALS))),
          "the instanced lit frame")
    return seen["gs2d"]


def fisheye_camera(cam):
    """The headline camera as a fisheye rolling-shutter one: a distortion
    pack and an end pose 0.05 to the side."""
    arr = interop.camera_to_numpy(cam)
    arr["viewmat_end"][0, 3] += 0.05
    arr["distortion"][[0, 6, 12, 16]] = (0.1, -0.02, 0.3, 1.4)
    return interop.camera_from_numpy(arr, device=cam.viewmat.device)


def project_round_trip(dev, scene, cam, cfg, lights, frame):
    """Save the session (the asset as PLY, two cameras, two lights), reopen
    it on the card, flatten again: the frame bit-equal to the in-memory
    scene's, a second save the same JSON."""
    pcfg = cfg.replace(raster=gt.RasterConfig(expansion="exact"))
    with tempfile.TemporaryDirectory() as d:
        ply, path, path2 = (os.path.join(d, f) for f in ("asset.ply", "a.vkgs.json",
                                                          "b.vkgs.json"))
        save_ply(ply, scene.assets[0])
        cams = CameraSet()
        cams.add(cam, "headline")
        cams.add(fisheye_camera(cam), "fisheye rolling")
        save_project(path, Project(scene=scene, cameras=cams, lights=list(lights), config=cfg,
                                   asset_paths=[ply]))
        loaded = load_project(path, device=dev)
        prepared, _ = loaded.scene.flatten(loaded.config.sh_format)
        out = render(prepared, loaded.cameras.get(), pcfg, max_pairs=INST_MAX_PAIRS)
        apart = [f for f in ("image", "transmittance", "depth", "splat_id")
                 if not torch.equal(getattr(out, f), getattr(frame, f))]
        same = not apart
        save_project(path2, loaded)
        with open(path) as f, open(path2) as g:
            same_json = f.read() == g.read()
        fish = loaded.cameras.cameras[1]
        kept = (torch.equal(fish.distortion, cams.cameras[1].distortion)
                and torch.equal(fish.viewmat_end, cams.cameras[1].viewmat_end))
    log(f"project round trip (PLY of {scene.assets[0].num_splats} splats and the JSON): frame "
        f"bit-equal {same} {apart}, second save the same JSON {same_json}, fisheye distortion "
        f"and end pose kept {kept}")
    check(same and same_json and kept, "the project round trip")


def crop(x, size):
    """The centre crop (w, h) of an (H, W, ...) image."""
    w, h = size
    y0, x0 = (x.shape[0] - h) // 2, (x.shape[1] - w) // 2
    return x[y0:y0 + h, x0:x0 + w].contiguous()


METRICS = {"mse": metrics.mse, "psnr": metrics.psnr,
           "flip": metrics.flip, "flip_approx": lambda a, b: metrics.flip(a, b, approx=True),
           "flip_mean": metrics.flip_mean,
           "flip_mean_approx": lambda a, b: metrics.flip_mean(a, b, approx=True)}


def metrics_phase(a, b):
    """The metrics at 1080p between two frames, and on a METRIC_CROP centre
    crop the card against the CPU within INST_ATOL."""
    vals = {k: float(METRICS[k](a, b)) for k in ("mse", "psnr", "flip_mean", "flip_mean_approx")}
    ca, cb = crop(a, METRIC_CROP), crop(b, METRIC_CROP)
    worst = 0.0
    for k, f in METRICS.items():
        got, want = f(ca, cb), f(ca.cpu(), cb.cpu())
        err = (got.cpu() - want).abs().max().item()
        if k == "psnr":
            err /= max(abs(want.item()), 1.0)
        worst = max(worst, err)
    log(f"metrics 1080p, the instanced frame against the rigid instance moved 0.05: "
        + " ".join(f"{k}={v:.6g}" for k, v in vals.items())
        + f"; card against CPU on a {METRIC_CROP[0]}x{METRIC_CROP[1]} crop: worst {worst:.3e} "
        f"(gate {INST_ATOL:g}; psnr relative)")
    check(worst <= INST_ATOL and all(math.isfinite(v) for v in vals.values()),
          "the metrics: the card against the CPU")
    check(vals["mse"] > 0 and vals["flip_mean"] > 0, "the moved instance changes nothing")


def compare_phase(a, b):
    """ImageCompare: capture, three compute_metrics, all six modes at 1080p:
    finite, left of the split the capture exactly."""
    tool = ImageCompare()
    tool.capture(a)
    samples = [tool.compute_metrics(b) for _ in range(3)]
    for mode in CompareMode:
        out = tool.render(b, mode, split_x=0.5, amplify=4.0)
        cut = int(0.5 * a.shape[1])
        check(bool(torch.isfinite(out).all()) and torch.equal(out[:, :cut], a[:, :cut]),
              f"composite {mode.name}: not finite or the left side is not the capture")
    check(len(tool.history) == 3 and [s.frame for s in samples] == [0, 1, 2]
          and samples[0] == dataclasses.replace(samples[2], frame=0), "the history")
    log(f"ImageCompare 1080p: samples {samples[0]}; composites finite, left side the capture")


def helpers_phase(dev, frame, cam, cfg, anchor):
    """The grid and the three gizmo modes over the 1080p frame with its
    depth, the gizmo at ``anchor``; at HELPER_SIZE the card against the CPU
    within INST_ATOL."""
    img, depth = frame.image, frame.depth
    calls = {"grid": lambda: helpers.render_grid_overlay(img, depth, cam, cfg, plane_y=-4.0)}
    for mode in ("translate", "scale", "rotate"):
        calls[mode] = (lambda m=mode: helpers.render_gizmo_overlay(
            img, depth, cam, cfg, origin=anchor, size=1.5, mode=m))
    for k, f in calls.items():
        out = f()
        check(bool(torch.isfinite(out).all()) and (out - img).abs().max().item() > 0.1,
              f"the {k} overlay: not finite or not drawn")
    w, h = HELPER_SIZE
    small = gt.RenderConfig(width=w, height=h)
    worst = 0.0
    for device in (dev, torch.device("cpu")):
        c = gt.look_at([0, 2.0, -7], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=device)
        ci, cd = crop(img, HELPER_SIZE).to(device), crop(depth, HELPER_SIZE).to(device)
        outs = [helpers.render_grid_overlay(ci, cd, c, small, plane_y=-4.0)]
        outs += [helpers.render_gizmo_overlay(ci, cd, c, small, origin=anchor, size=1.5, mode=m)
                 for m in ("translate", "scale", "rotate")]
        if device == dev:
            card_outs = [o.cpu() for o in outs]
        else:
            worst = max((a - b).abs().max().item() for a, b in zip(card_outs, outs))
    log(f"overlays 1080p: drawn and finite; card against CPU at {w}x{h}: worst {worst:.3e} "
        f"(gate {INST_ATOL:g})")
    check(worst <= INST_ATOL, f"the overlays: card against CPU {worst}")


def pick_pixels(out, n, seed, t_min):
    """Up to 4n candidate pixels (x, y) of a frame with t_min < T < 0.9,
    from a seeded generator."""
    ok = torch.nonzero((out.transmittance > t_min) & (out.transmittance < 0.9))
    g = torch.Generator(device=ok.device).manual_seed(seed)
    pick = ok[torch.randperm(ok.shape[0], generator=g, device=ok.device)[:4 * n]]
    return [(int(x), int(y)) for y, x in pick.tolist()]


def traces_phase(prepared, cam, cfg, frame):
    """pixel_trace at TRACE_PIXELS pixels of the exact pairs frame (pixels
    whose T stays above TRACE_T_MIN, so the blend never froze them, and
    that have fewer than 200 contributors, the trace's cap) against the
    frame within TRACE_ATOL; pixel_trace_gut, depth and radial, at
    GUT_TRACE_PIXELS pixels each against render_3dgut / render_3dgrt
    (pairs, exact) within GUT_TRACE_ATOL."""
    pcfg = cfg.replace(raster=gt.RasterConfig(expansion="exact"))
    proj = project_splats(prepared, cam, pcfg)
    cand = pick_pixels(frame, TRACE_PIXELS, 23, TRACE_T_MIN)
    worst, used, examined = 0.0, [], 0
    for x, y in cand:
        tr_ = debug.pixel_trace(proj, x, y, pcfg)
        examined += 1
        if len(tr_.splat_id) >= 200:
            continue
        worst = max(worst, float(np.abs(tr_.final_color - frame.image[y, x].cpu().numpy()).max()),
                    abs(tr_.final_transmittance - frame.transmittance[y, x].item()))
        used.append(len(tr_.splat_id))
        if len(used) == TRACE_PIXELS:
            break
    log(f"pixel_trace: {len(used)} of {examined} examined pixels with T > {TRACE_T_MIN:g} had "
        f"fewer than 200 contributors ({used}); worst against the exact pairs frame {worst:.3e} (gate "
        f"{TRACE_ATOL:g})")
    check(len(used) == TRACE_PIXELS and worst <= TRACE_ATOL, "pixel_trace against the frame")
    worst_gut = {}
    for order, fn, pipeline in (("depth", render_3dgut, gt.Pipeline.MESH_3DGUT),
                                ("radial", render_3dgrt, gt.Pipeline.RTX)):
        gcfg = pcfg.replace(pipeline=pipeline)
        tr.zero_counters(tr.rasterize_tiles)
        out = fn(prepared, cam, gcfg, max_pairs=INST_MAX_PAIRS)
        check(not bool(out.overflow), f"the {order} trace's frame overflowed")
        seen = only(f"the {order} trace's frame", tr.rasterize_tiles, "gut3d", 1)
        errs, n = [], []
        for x, y in pick_pixels(out, GUT_TRACE_PIXELS, 29, 1e-2):
            tr_ = debug.pixel_trace_gut(prepared, cam, x, y, gcfg, order=order)
            if len(tr_.splat_id) >= 200:
                continue
            errs.append(float(np.abs(tr_.final_color - out.image[y, x].cpu().numpy()).max()))
            n.append(len(tr_.splat_id))
            if len(errs) == GUT_TRACE_PIXELS:
                break
        worst_gut[order] = max(errs) if errs else math.inf
        log(f"pixel_trace_gut {order}: launches {seen}; {len(errs)} pixels ({n} contributors), "
            f"worst against {fn.__name__} {worst_gut[order]:.3e} (gate {GUT_TRACE_ATOL:g})")
        check(len(errs) == GUT_TRACE_PIXELS and worst_gut[order] <= GUT_TRACE_ATOL,
              f"pixel_trace_gut {order}")


def instances(dev):
    """Phase 13: the instanced scene (``instanced_scene``, 1 M splats after
    the flatten) at the headline cell: the flatten on the card against the
    CPU, the instanced frames (``instanced_frames``), the lit frame with
    four per-instance materials, the project round trip, the metrics,
    ImageCompare and the overlays over the frames, and the pixel traces.
    Returns {kernel: phase-13 launches and error}."""
    t0 = time.perf_counter()
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    asset = bench_scene(dev, INST_SPLATS, seed=1)
    scene = instanced_scene(asset)
    scene_cpu = instanced_scene(gt.SplatSet(**{f: getattr(asset, f).cpu() for f in FIELDS}))
    prepared, table = flatten_on_card_and_cpu(scene, scene_cpu)
    del scene_cpu
    log(f"flatten of {scene.total_splats} splats ({len(scene.instances)} instances, "
        f"{len(table.instance_base) - 1} visible)")
    check(prepared.num_splats == 4 * INST_SPLATS, "the instanced scene's size")

    frame, k1, k3 = instanced_frames(dev, prepared, table, cam, cfg)
    lights = headline_lights(dev)
    k1_lit = instanced_lit(prepared, table, cam, cfg, lights)
    project_round_trip(dev, scene, cam, cfg, lights, frame)

    moved = scene.instances[1].transform.copy()
    moved[0, 3] += 0.05
    scene.instances[1].transform = moved
    prepared_moved, _ = scene.flatten()
    pcfg = cfg.replace(raster=gt.RasterConfig(expansion="exact"))
    frame_moved = render(prepared_moved, cam, pcfg, max_pairs=INST_MAX_PAIRS)
    del prepared_moved
    metrics_phase(frame.image, frame_moved.image)
    compare_phase(frame.image, frame_moved.image)
    helpers_phase(dev, frame, cam, cfg, scene.instances[1].transform[:3, 3])
    traces_phase(prepared, cam, cfg, frame)
    log(f"instances phase {time.perf_counter() - t0:.1f} s")
    return {"rasterize_fwd": dict(instances_launches=k1[0] + k1_lit,
                                  instances_max_abs_err=k1[1]),
            "raster_bucket_fwd": dict(instances_launches=k3[0], instances_max_abs_err=k3[1])}


# ---- phase 14: the sequencer, the viewers, the oracle and multi-device --------

TOOLS_SEQ_FRAMES = 8   # --sequenceframes, with --sequenceaverages 1: 8 frames a block
TOOLS_BLOCKS = (("Mesh pipeline fp32", 1, 0), ("Mesh pipeline fp16", 1, 1),
                ("Mesh pipeline uint8", 1, 2), ("3DGUT", 4, 0), ("3DGRT", 2, 0))
TOOLS_ORBIT_FRAMES = 4
TOOLS_WEB_QUERIES = (dict(pipeline=1, mode="rgb"), dict(pipeline=4, mode="depth"),
                     dict(pipeline=2, mode="trans"))
ORACLE_SIZE, ORACLE_SPLATS = (128, 96), 2000
MIN_TRANSMITTANCE = 1e-4     # the blenders freeze a pixel below it (rasterize.py)
ORACLE_ATOL = 3e-5           # 3DGS oracle on pixels the blender never froze
FREEZE_ATOL = 1.5e-4         # on frozen pixels, in the oracle's and the two ranks' checks: a
                             # pixel frozen a step earlier or later than its reference
                             # differs by its residual T < 1e-4 times its colour
                             # (tests/test_rasterize.py:34-39)
SHARD_TIMEOUT_S = 240        # each subprocess of the phase; each collective: TIMEOUT_S
SHARD_ATOL = 3e-5            # two ranks' bands against the single-device frame
SHARD_MAX_PAIRS = 1 << 22    # two ranks' pair frames: the exact expansion, which must not
                             # overflow (the slots expansion truncates each band's splats
                             # at other tiles than the whole frame's)


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG: by Pillow where it is installed, else the
    stdlib writer's form (one IDAT, filter 0 on every row) by zlib."""
    try:
        from PIL import Image
    except ImportError:
        import struct
        import zlib
        check(data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR", "not a PNG")
        w, h = struct.unpack(">II", data[16:24])
        n = struct.unpack(">I", data[33:37])[0]
        check(data[37:41] == b"IDAT", "the PNG's second chunk is not its image")
        raw = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(h, 1 + 3 * w)
        check(bool((raw[:, 0] == 0).all()), "a PNG row with a filter")
        return raw[:, 1:].reshape(h, w, 3)
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def quantised(img: torch.Tensor) -> np.ndarray:
    """The viewers' 8-bit image of a frame (``encode_png``'s truncation)."""
    return (img.clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)


def cli_camera(means: torch.Tensor, dev):
    """bench/__main__.py's camera without ``--camera``: 4 mean spreads in
    front of the means' centre."""
    m = means.cpu().numpy()
    center = m.mean(axis=0)
    spread = float(np.abs(m - center).mean()) or 1.0
    return gt.look_at(center + np.asarray([0.0, 0.0, -4.0 * spread]), center, [0, 1, 0],
                      WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)


def frame_counts() -> dict:
    """Every forward launch counter of the pair and bucket wrappers."""
    return {"K1": counts(tr.rasterize_tiles), "K3": counts(rb.rasterize_buckets)}


def zero_frame_counters():
    for w in (tr.rasterize_tiles, rb.rasterize_buckets, tr.rasterize_tiles_bwd,
              rb.rasterize_buckets_bwd):
        tr.zero_counters(w)


def expect_frames(label: str, want: dict):
    """Fail unless the forward counters show exactly ``want`` ({"K1": {form:
    n}, "K3": {...}}, missing forms 0); returns the launches by kernel name."""
    got = frame_counts()
    for k in ("K1", "K3"):
        exp = {m: want.get(k, {}).get(m, 0) for m in got[k]}
        check(got[k] == exp, f"{label}: {k} launches {got[k]}, want {exp}")
    names = {("K1", "gs2d"): "rasterize_fwd", ("K1", "gut3d"): "rasterize_fwd_gut3d",
             ("K3", "gs2d"): "raster_bucket_fwd", ("K3", "gut3d"): "raster_bucket_fwd_gut3d"}
    return {names[(k, m)]: n for k, forms in want.items() for m, n in forms.items() if n}


def add_launches(total: dict, more: dict):
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def sequencer_phase(dev, truth, ply, tmp):
    """``python -m vk_gaussian_splatting_tpu_torch.bench`` in-process on a
    cfg of the reference grammar (MESH at shformat 0, 1, 2, MESH_3DGUT,
    RTX, each with --updateData; one --screenshot), with --method pairs and
    bucket: its stdout parsed by ``bench.report``, every block's four
    timers named, one K1 / K3 (K1g / K3g) launch per frame it ran, the
    screenshot's PNG decoded equal to the 8-bit image of ``render``, the
    Rasterization bytes beside the rise of the allocator's peak over one
    frame. Returns the launches by kernel."""
    from vk_gaussian_splatting_tpu_torch.bench import report
    from vk_gaussian_splatting_tpu_torch.bench.__main__ import main as bench_main

    shot = os.path.join(tmp, "shot.png")
    lines = ['SEQUENCE "Load scene and common settings"',
             f"--sequenceframes {TOOLS_SEQ_FRAMES}", "--sequenceaverages 1", "--maxShDegree 3"]
    for name, pipe, fmt in TOOLS_BLOCKS:
        lines += [f'SEQUENCE "{name}"', f"--pipeline {pipe} --shformat {fmt}", "--updateData"]
        if name == TOOLS_BLOCKS[0][0]:
            lines.append(f'--screenshot "{shot}"')
    seq_file = os.path.join(tmp, "tools.cfg")
    with open(seq_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    n = TOOLS_SEQ_FRAMES
    per_block = 1 + 1 + n + max(n, 3)  # warm-up, the bytes' blend, the block's frames, "Frame"
    gs_blocks = sum(1 for b in TOOLS_BLOCKS if b[1] == 1)
    cam = cli_camera(truth.means, dev)
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    launches = {}
    for method in ("pairs", "bucket"):
        zero_frame_counters()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_main(["--size", str(WIDTH), str(HEIGHT), "--sequencefile", seq_file,
                        "--method", method, ply])
        torch.cuda.synchronize()
        text = buf.getvalue()
        k = "K1" if method == "pairs" else "K3"
        add_launches(launches, expect_frames(f"sequencer {method}", {k: {
            "gs2d": gs_blocks * per_block + 1, "gut3d": (len(TOOLS_BLOCKS) - gs_blocks)
            * per_block}}))
        recs = [r for r in report.parse_benchmark_output(text) if r["timers"]]
        check([r["name"] for r in recs] == [b[0] for b in TOOLS_BLOCKS],
              f"sequencer {method}: blocks {[r['name'] for r in recs]}")
        log(f"sequencer --method {method} {WIDTH}x{HEIGHT}/{SPLATS} ({n} frames a block; "
            f"{text.splitlines()[1]}):")
        for r, (name, pipe, _) in zip(recs, TOOLS_BLOCKS):
            stage = "Raytracing" if pipe == 2 else "Rasterization"
            check(list(r["timers"]) == ["GPU Dist", "GPU Sort", stage, "Frame"],
                  f"sequencer {method} {name}: timers {list(r['timers'])}")
            mem = r["memory"]
            log(f"  {name}: Scene {mem['Scene'][1]} B, Rasterization {mem['Rasterization'][1]} B")
        cfg = base if method == "pairs" else bucket_cfg(base, base.raster.bucket_caps)
        out = render(truth.prepare(), cam, cfg, max(4 * SPLATS, 1 << 20))
        with open(shot, "rb") as f:
            same = np.array_equal(decode_png(f.read()), quantised(out.image))
        os.remove(shot)
        log(f"  screenshot {os.path.basename(shot)} (decoded) equal to render's 8-bit image: "
            f"{same}")
        check(same, f"sequencer {method}: the screenshot differs from render")
        # the Rasterization bytes beside what the allocator's peak rises by over one frame
        prepared = truth.prepare()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        render(prepared, cam, cfg)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - before
        counted = recs[0]["memory"]["Rasterization"][1]
        log(f"  Mesh fp32 Rasterization bytes counted {counted}, allocator peak rise over "
            f"one frame {rise} ({counted / max(rise, 1):.3f} of it)")
    return launches


def viewers_phase(dev, truth, ply, tmp):
    """The orbit viewer (``viewer.main``, TOOLS_ORBIT_FRAMES frames at 1080p)
    and the web viewer served on 127.0.0.1, port 0, in a thread (the page,
    then TOOLS_WEB_QUERIES at 1080p): each PNG decoded equal to the 8-bit
    image of ``render`` / ``RenderSession.render`` of its camera, one K1 or
    K1g launch a frame. Returns the launches."""
    import threading
    import urllib.request

    from vk_gaussian_splatting_tpu_torch import viewer, viewer_web

    launches = {}
    out_dir = os.path.join(tmp, "orbit")
    zero_frame_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        viewer.main([ply, "-o", out_dir, "--frames", str(TOOLS_ORBIT_FRAMES), "--size",
                     str(WIDTH), str(HEIGHT)])
    torch.cuda.synchronize()
    add_launches(launches, expect_frames("orbit viewer", {"K1": {"gs2d": TOOLS_ORBIT_FRAMES}}))
    printed = buf.getvalue().splitlines()
    prepared = truth.prepare()
    means = prepared.means.cpu().numpy()
    center = means.mean(axis=0)
    radius = 4.0 * max(float(np.abs(means - center).mean()), 1e-3)
    cfg = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    for i in range(TOOLS_ORBIT_FRAMES):
        cam = viewer.orbit_camera(center, radius, 2 * np.pi * i / TOOLS_ORBIT_FRAMES, 0.3,
                                  WIDTH, HEIGHT, device=dev)
        want = quantised(render(prepared, cam, cfg, max(4 * SPLATS, 1 << 20)).image)
        png = open(os.path.join(out_dir, f"frame_{i:03d}.png"), "rb").read()
        check(np.array_equal(decode_png(png), want), f"orbit frame {i} differs from render")
    log(f"orbit viewer: {TOOLS_ORBIT_FRAMES} frames at {WIDTH}x{HEIGHT}, each PNG equal to render's "
        f"8-bit image; first line: {printed[0]}")

    means_t = truth.means.cpu().numpy()
    c = means_t.mean(axis=0)
    r = float(np.linalg.norm(means_t - c, axis=1).mean())
    httpd = viewer_web.serve(prepared, c, r, port=0, host="127.0.0.1", width=WIDTH,
                             height=HEIGHT)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/", timeout=SHARD_TIMEOUT_S) as resp:
            page = resp.read().decode()
        check("%RADIUS%" not in page and "frame.png" in page, "the viewer page")
        session = httpd.RequestHandlerClass.session
        for q in TOOLS_WEB_QUERIES:
            query = "&".join(f"{k}={v}" for k, v in dict(az=0.4, el=0.2, r=r * 2.2, sh=3,
                                                         **q).items())
            zero_frame_counters()
            with urllib.request.urlopen(f"{url}/frame.png?{query}",
                                        timeout=SHARD_TIMEOUT_S) as resp:
                check(resp.status == 200 and resp.headers["Content-Type"] == "image/png",
                      f"web frame {query}: {resp.status}")
                body = resp.read()
            form = "gs2d" if q["pipeline"] == 1 else "gut3d"
            add_launches(launches, expect_frames(f"web frame {query}", {"K1": {form: 1}}))
            want = session.render(0.4, 0.2, r * 2.2, sh=3, **q)
            check(np.array_equal(decode_png(body), (want * 255).astype(np.uint8)),
                  f"web frame {query} differs from RenderSession.render")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=SHARD_TIMEOUT_S)
    check(not thread.is_alive(), "the web viewer's thread did not stop")
    log(f"web viewer {WIDTH}x{HEIGHT} on 127.0.0.1: the page and "
        f"{len(TOOLS_WEB_QUERIES)} frames, each equal to RenderSession.render quantised")
    return launches


def oracle_phase(dev):
    """``ops/rasterize_ref``'s naive oracles against the frames on the card,
    ORACLE_SPLATS splats at ORACLE_SIZE (tests/test_rasterize.py's shapes):
    ``rasterize_naive`` against ``render_3dgs`` (K1) within ORACLE_ATOL where
    the blender never froze the pixel (T >= MIN_TRANSMITTANCE) and
    FREEZE_ATOL where it did; ``rasterize_naive_gut`` against
    ``render_3dgut`` (K1g) at the gut3d gates (p99.9 within KERNEL_ATOL,
    none beyond GUT_MAX). Returns {kernel: (launches, max abs err)}."""
    from vk_gaussian_splatting_tpu_torch.ops import rasterize_ref

    w, h = ORACLE_SIZE
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=1)
    cam = gt.look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)
    prepared = interop.splat_set_from_numpy(interop.random_splat_arrays(
        0, ORACLE_SPLATS, sh_degree=1, scale_range=(-3.0, -1.0)), dev).prepare()
    zero_frame_counters()
    out = render(prepared, cam, cfg)
    torch.cuda.synchronize()
    expect_frames("oracle 3DGS frame", {"K1": {"gs2d": 1}})
    img, t = rasterize_ref.rasterize_naive(project_splats(prepared, cam, cfg), w, h, cfg.raster)
    live = out.transmittance >= MIN_TRANSMITTANCE
    d = (out.image - img).abs()
    err_live, err_all = d[live].max().item(), d.max().item()
    t_err = (out.transmittance - t).abs()[live].max().item()
    log(f"oracle: render_3dgs (K1) against rasterize_naive, {ORACLE_SPLATS} splats at {w}x{h}: "
        f"max abs {err_live:.3e} on the {int(live.sum())} pixels never frozen (T {t_err:.3e}; "
        f"gate {ORACLE_ATOL:g}), {err_all:.3e} over all (gate {FREEZE_ATOL:g}: "
        f"{int((~live).sum())} pixels frozen at T < {MIN_TRANSMITTANCE:g})")
    check(err_live <= ORACLE_ATOL and t_err <= ORACLE_ATOL and err_all <= FREEZE_ATOL,
          "render_3dgs against rasterize_naive outside its gates")
    check(float(t.min()) < 0.9, "the oracle scene covers nothing")
    zero_frame_counters()
    out = render_3dgut(prepared, cam, cfg)
    torch.cuda.synchronize()
    expect_frames("oracle 3DGUT frame", {"K1": {"gut3d": 1}})
    rays = build_tile_rays(cam, cfg)
    full = rays.reshape(h // 16, w // 16, 8, 16, 16).permute(0, 3, 1, 4, 2).reshape(h, w, 8)
    img, t = rasterize_ref.rasterize_naive_gut(prepared, ut_project_splats(prepared, cam, cfg),
                                               full[..., 0:3], full[..., 3:6], cfg.raster,
                                               kernel_degree=cfg.rt.kernel_degree)
    d = torch.cat([(out.image - img).abs().flatten(), (out.transmittance - t).abs().flatten()])
    med, p999, gut_err = (d.median().item(), torch.quantile(d, 0.999).item(), d.max().item())
    log(f"oracle: render_3dgut (K1g) against rasterize_naive_gut: median {med:.3e}, p99.9 "
        f"{p999:.3e} (gate {KERNEL_ATOL:g}), max {gut_err:.3e} (gate {GUT_MAX:g})")
    check(p999 <= KERNEL_ATOL and gut_err <= GUT_MAX, "render_3dgut against the oracle")
    return {"rasterize_fwd": (1, err_all), "rasterize_fwd_gut3d": (1, gut_err)}


def frame_diff(label, got, want, gut: bool) -> float:
    """Max abs difference of a sharded frame against the single-device one;
    fails outside the f32 gate (KERNEL_ATOL) or, for gut3d, the gut3d gates."""
    d = (got - want).abs()
    err = d.max().item()
    share = (d <= KERNEL_ATOL).float().mean().item()
    log(f"  {label}: {'bit-equal' if err == 0 else f'max abs {err:.3e}, share within {KERNEL_ATOL:g} {share:.6f}'}")
    check(share >= GUT_SHARE and err <= GUT_MAX if gut else err <= KERNEL_ATOL,
          f"{label} outside its gates")
    return err


def world_one(dev, truth, caps):
    """World size 1 over NCCL (``parallel.distributed.initialize`` on
    tcp://127.0.0.1 and a free port): the sharded 3DGS (pairs, bucket),
    3DGUT and 3DGRT (both methods) frames at 1080p / 1 M against the
    single-device frames, one launch each; ``train_step_sharded`` against
    one single-device step (K2's gate, 1e-4 of each component's max
    gradient);
    then ``python -m ...parallel.distributed --num-processes 1`` in a
    subprocess. Returns {kernel: (launches, max abs err)}."""
    import socket

    import torch.distributed as dist

    from vk_gaussian_splatting_tpu_torch.parallel import distributed as pdist
    from vk_gaussian_splatting_tpu_torch.parallel import sharded_render as sr

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    res = {}
    pdist.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = sr.make_mesh(1)
        log(f"world size 1: {dist.get_backend()} group up, mesh {mesh}")
        base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
        cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9,
                         device=dev)
        prepared = truth.prepare()
        frames = (("3DGS", sr.render_3dgs_sharded, render, gt.Pipeline.MESH),
                  ("3DGUT", sr.render_3dgut_sharded, render_3dgut, gt.Pipeline.MESH_3DGUT),
                  ("3DGRT", sr.render_3dgrt_sharded, render_3dgrt, gt.Pipeline.RTX))
        for label, sharded, single, pipeline in frames:
            for method in ("pairs", "bucket"):
                cfg = gut_cfg(base, pipeline, method, caps)
                k, form = ("K1" if method == "pairs" else "K3",
                           "gs2d" if pipeline == gt.Pipeline.MESH else "gut3d")
                zero_frame_counters()
                img, trans, ov = sharded(truth, cam, cfg, 0, mesh)
                torch.cuda.synchronize()
                name = next(iter(expect_frames(f"sharded {label} {method}", {k: {form: 1}})))
                ref = single(prepared, cam, cfg)
                check(bool(ov) == bool(ref.overflow), f"sharded {label} {method} overflow")
                err = max(frame_diff(f"sharded {label} {method} image", img, ref.image,
                                     form == "gut3d"),
                          frame_diff(f"sharded {label} {method} transmittance", trans,
                                     ref.transmittance, form == "gut3d"))
                old = res.get(name, (0, 0.0))
                res[name] = (old[0] + 1, max(old[1], err))
        cfg = base
        target = render(prepared, jitter(cam, 3), cfg).image.detach()
        lr = 1.0
        zero_frame_counters()
        new, loss = sr.train_step_sharded(truth, cam, target, cfg, 0, mesh, lr=lr)
        torch.cuda.synchronize()
        step = expect_frames("sharded train step", {"K1": {"gs2d": 1}})
        check(only("sharded train step backward", tr.rasterize_tiles_bwd, "gs2d", 1),
              "sharded train step: K2 launches")
        old = res.get("rasterize_fwd", (0, 0.0))
        res["rasterize_fwd"] = (old[0] + step["rasterize_fwd"], old[1])
        params = {f: getattr(truth, f).detach().clone().requires_grad_(True) for f in FIELDS}
        img = render(gt.SplatSet(**params).prepare(), cam, cfg).image
        loss_ref = torch.sum((img - target) ** 2)
        loss_ref.backward()
        rel_loss = abs(loss.item() - loss_ref.item()) / abs(loss_ref.item())
        worst = 0.0
        for f in FIELDS:
            p, g = params[f].detach(), params[f].grad
            want = p - lr * g
            n = p.shape[0]
            rows = (lr * g).reshape(n, -1).abs().amax(dim=0)  # each component's max
            eps = torch.finfo(torch.float32).eps
            slack = 2 * eps * (p.abs() + (lr * g).abs())
            d = (getattr(new, f) - want).abs()
            over = (d - slack).reshape(n, -1) / rows.clamp_min(1e-30)
            worst = max(worst, over.max().item() if over.numel() else 0.0)
        log(f"train_step_sharded at world size 1 against one single-device step (lr {lr}): loss "
            f"{loss.item():.6e} vs {loss_ref.item():.6e} (rel {rel_loss:.2e}); the updated shard "
            f"within {worst:.3e} of each component's max step beyond rounding (gate {BWD_RTOL:g})")
        check(rel_loss <= 1e-5 and worst <= BWD_RTOL, "train_step_sharded against one step")
        res["rasterize_bwd"] = (1, worst)
    finally:
        dist.destroy_process_group()

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-m", "vk_gaussian_splatting_tpu_torch.parallel.distributed",
         "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
         "--process-id", "0"], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=SHARD_TIMEOUT_S)
    line = [s for s in run.stdout.splitlines() if s.startswith("MULTIHOST_")]
    log(f"parallel.distributed --num-processes 1 (NCCL; rc {run.returncode}): "
        f"{line[-1] if line else run.stdout[-500:] + run.stderr[-2000:]}")
    check(run.returncode == 0 and line and line[-1].startswith("MULTIHOST_OK process=0"),
          "the distributed main at world size 1")
    return res


def two_rank_cfg(base, method: str, caps):
    """The two-rank frames' config: pairs by the exact expansion
    (SHARD_MAX_PAIRS), or bucket at the headline caps."""
    if method == "pairs":
        return base.replace(raster=dataclasses.replace(base.raster, expansion="exact"))
    return bucket_cfg(base, caps)


def gloo_rank(argv, dev) -> int:
    """One rank of the two-rank run on the one card ``dev`` (a subprocess of
    ``two_ranks``): gloo on CUDA tensors, ``--gloo-rank R --port P --out DIR
    --caps a,b,c,d``. First the collectives the sharded frame needs, on
    small CUDA tensors (an error or a wrong result fails the rank), then the
    headline scene's half (``shard_leading``) through ``render_3dgs_sharded``
    on both methods; its bands to DIR/rank<R>.pt."""
    import datetime

    import torch.distributed as dist

    from vk_gaussian_splatting_tpu_torch.parallel import distributed as pdist
    from vk_gaussian_splatting_tpu_torch.parallel import sharded_render as sr

    rank = int(argv[argv.index("--gloo-rank") + 1])
    port = int(argv[argv.index("--port") + 1])
    out = argv[argv.index("--out") + 1]
    caps = tuple(int(c) for c in argv[argv.index("--caps") + 1].split(","))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=pdist.TIMEOUT_S))
    path = os.path.join(out, f"rank{rank}.pt")
    try:
        mesh = sr.make_mesh(2, device_type=dev.type)
        x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        g = sr.all_gather(x[:, None], mesh.get_group())
        ids = sr.all_gather(torch.arange(3, dtype=torch.int32, device=dev), mesh.get_group())
        flag = torch.tensor([rank], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, group=mesh.get_group())
        torch.cuda.synchronize()
        check(g.device == dev and ids.device == dev and flag.device == dev
              and g.shape == (8, 1) and g.flatten().tolist() == [0, 1, 2, 3, 10, 11, 12, 13]
              and ids.tolist() == [0, 1, 2, 0, 1, 2] and flag.item() == 1,
              f"gloo rank {rank}: the collectives on CUDA tensors gave {g.flatten().tolist()}, "
              f"{ids.tolist()}, {flag.item()}")
        truth = bench_scene(dev, SPLATS, seed=0)
        shard = gt.SplatSet(**pdist.shard_leading({f: getattr(truth, f) for f in FIELDS}, mesh))
        del truth
        cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9,
                         device=dev)
        base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
        res = {}
        for method in ("pairs", "bucket"):
            cfg = two_rank_cfg(base, method, caps)
            img, trans, ov = sr.render_3dgs_sharded(shard, cam, cfg, SHARD_MAX_PAIRS, mesh)
            res[method] = dict(img=img.cpu(), trans=trans.cpu(), ov=bool(ov))
        torch.save(res, path)
    finally:
        dist.destroy_process_group()
    return 0


def two_ranks(dev, truth, caps, tmp):
    """Two ranks on the one card: gloo carries CUDA tensors (NCCL refuses
    two ranks on one device), each rank a subprocess of this script
    (``gloo_rank``) with a timeout. Where gloo runs the collectives, the
    3DGS pairs (exact expansion) and bucket frames at 1080p / 1 M: the two
    bands against the single-device frame within SHARD_ATOL on every pixel
    the blender did not freeze (T >= MIN_TRANSMITTANCE) and within
    FREEZE_ATOL on frozen ones, no overflow. A band's tiles start at other
    places of its pair (or slot) array than in the whole frame's, and the
    freeze is checked at the steps of that array: a pixel may freeze a step
    apart. A rank that fails (its collectives included) fails the phase.
    Returns {kernel: max abs err}."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                               "--gloo-rank", str(r), "--port", str(port), "--out", tmp,
                               "--caps", ",".join(str(c) for c in caps)],
                              cwd=HERE, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SHARD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"gloo rank {r} failed (rc {p.returncode}): {o[-3000:]}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9, device=dev)
    base = gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)
    prepared = truth.prepare()
    errs = {}
    for method, name in (("pairs", "rasterize_fwd"), ("bucket", "raster_bucket_fwd")):
        ref = render(prepared, cam, two_rank_cfg(base, method, caps), SHARD_MAX_PAIRS)
        img = torch.cat([r[method]["img"] for r in ranks]).to(dev)
        trans = torch.cat([r[method]["trans"] for r in ranks]).to(dev)
        check(img.shape == ref.image.shape, f"two-rank bands {tuple(img.shape)}")
        d = torch.cat([(img - ref.image).abs(), (trans - ref.transmittance).abs()[..., None]], -1)
        live = ref.transmittance >= MIN_TRANSMITTANCE
        err, err_live = d.max().item(), d[live].max().item()
        off = d.amax(dim=-1) > SHARD_ATOL
        rows = off.nonzero()[:, 0]
        log(f"two ranks (gloo, CUDA tensors) 3DGS {method} {WIDTH}x{HEIGHT}/{SPLATS}: bands of "
            f"{[r[method]['img'].shape[0] for r in ranks]} rows, against the single-device "
            f"frame: max abs {err_live:.3e} on the pixels never frozen (gate {SHARD_ATOL:g}), "
            f"{err:.3e} over all (gate {FREEZE_ATOL:g}); {int(off.sum())} pixels beyond "
            f"{SHARD_ATOL:g}"
            + (f" (rows {int(rows.min())}-{int(rows.max())}, their T "
               f"{ref.transmittance[off].min().item():.3e}-"
               f"{ref.transmittance[off].max().item():.3e})" if off.any() else "")
            + f"; overflow {[r[method]['ov'] for r in ranks]} / {bool(ref.overflow)}")
        check(err_live <= SHARD_ATOL and err <= FREEZE_ATOL,
              f"two-rank {method} frame outside the gates ({err_live}, {err})")
        check(not bool(ref.overflow) and not any(r[method]["ov"] for r in ranks),
              "a two-rank frame or its reference overflowed")
        errs[name] = err
    return errs


def tools(dev, truth, caps):
    """Phase 14: the sequencer (``sequencer_phase``), the viewers
    (``viewers_phase``), the naive oracle (``oracle_phase``) and multi-device
    rendering on the one card (``world_one``, ``two_ranks``), on the
    headline scene written once as a PLY with ``save_ply``. ``caps``: the
    headline bucket caps. Returns {kernel: phase-14 fields}: ``tools_launches``
    counts the main paths' launches (the sequencer's, the viewers', the
    sharded frames' and step's), ``tools_max_abs_err`` the largest frame
    difference measured here through the kernel (oracle, sharded against
    single-device; the sequencer's and viewers' frames are bit-equal)."""
    t0 = time.perf_counter()
    launches = {}
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "headline.ply")
        save_ply(ply, truth)
        add_launches(launches, sequencer_phase(dev, truth, ply, tmp))
        add_launches(launches, viewers_phase(dev, truth, ply, tmp))
    for name, (n, err) in oracle_phase(dev).items():
        errs[name] = max(errs.get(name, 0.0), err)
    for name, (n, err) in world_one(dev, truth, caps).items():
        add_launches(launches, {name: n})
        errs[name] = max(errs.get(name, 0.0), err)
    with tempfile.TemporaryDirectory() as tmp:
        for name, err in two_ranks(dev, truth, caps, tmp).items():
            errs[name] = max(errs.get(name, 0.0), err)
    log(f"tools phase {time.perf_counter() - t0:.1f} s")
    return {name: dict(tools_launches=launches.get(name, 0), tools_max_abs_err=errs.get(name, 0.0))
            for name in sorted(set(launches) | set(errs))}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    views = int(argv[argv.index("--mesh-views") + 1]) if "--mesh-views" in argv else 0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a card")
    if "--gloo-rank" in argv:
        return gloo_rank(argv, torch.device("cuda", 0))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    was_built = {name: _build.library_path(name).exists() for name in _SOURCES}
    with concurrent.futures.ThreadPoolExecutor(len(_SOURCES) + 1) as pool:
        host_lib = pool.submit(native.available)  # c++ of native/fast_splats.cpp
        list(pool.map(_build.load, _SOURCES))  # one nvcc per source, all at once
        check(host_lib.result(), "the native host library did not build")
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
    if views:
        mesh = mr.mesh_buffers_from_obj(headline_mesh(), device=dev)
        mesh_views(dev, mesh, bench_scene(dev, SPLATS, seed=0).prepare(),
                   gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3), views)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if "--lighting" in argv:
        lighting(dev, bench_scene(dev, SPLATS, seed=0))
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if "--raytrace" in argv:
        raytracing(dev, bench_scene(dev, SPLATS, seed=0))
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if "--instances" in argv:
        instances(dev)
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    if "--tools" in argv:
        truth = bench_scene(dev, SPLATS, seed=0)
        cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], WIDTH, HEIGHT, fov_y_rad=0.9,
                         device=dev)
        tools(dev, truth, headline_caps(truth.prepare(), cam,
                                        gt.RenderConfig(width=WIDTH, height=HEIGHT, sh_degree=3)))
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0

    err_golden = golden_gate(dev)
    err_golden_bwd = golden_gradients(dev)
    truth = bench_scene(dev, SPLATS, seed=0)
    fwd, frame_launches = full_size(dev, truth.prepare())
    fwd["max_abs_err"] = max(fwd["max_abs_err"], err_golden)
    bwd, step_launches = train_full_size(dev, truth, seed=0)
    bwd["max_abs_err"] = max(bwd["max_abs_err"], err_golden_bwd)

    err_golden_k3 = golden_bucket(dev)
    err_golden_k4 = golden_bucket_gradients(dev)
    caps, k3 = bucket_full_size(dev, truth.prepare(), seed=0)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_golden_k3)
    k4 = bucket_train_full_size(dev, truth, caps, seed=0)
    k4["max_abs_err"] = max(k4["max_abs_err"], err_golden_k4)
    k4["kept_share"] = k3["kept_share"]  # the same lanes on the headline frame (check_cull)
    results = {"rasterize_fwd": fwd, "rasterize_bwd": bwd, "raster_bucket_fwd": k3,
               "raster_bucket_bwd": k4}

    golden_fwd, golden_bwd = golden_gut(dev)
    gut_camera_effects(dev)
    gut_fwd = gut_full_size(dev, truth.prepare(), caps, seed=0)
    gut_bwd = gut_train_full_size(dev, truth, caps, seed=0)
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

    golden_packed_errs = golden_packed(dev)
    packed_entries = packed_full_size(dev, truth.prepare(), caps, seed=0)
    for name, err in golden_packed_errs.items():
        packed_entries[name]["max_abs_err"] = max(packed_entries[name]["max_abs_err"], err)
    results.update(packed_entries)
    results.update(stochastic(dev, truth, caps))
    results.update(host_sorted(dev, truth, caps))
    results.update(meshes(dev, truth))
    results.update(lighting(dev, truth))
    raytracing(dev, truth)
    for name, extra in instances(dev).items():
        results[name].update(extra)
    for name, extra in tools(dev, truth, caps).items():
        results[name].update(extra)
    results.update(probes(dev))
    for entries in (sh_radiance_phase(dev), ewa_project_phase(dev)):
        for name, entry in entries.items():
            entry["launches"] = {**frame_launches, **step_launches}[name]
        results.update(entries)

    report = {"kernels": [{"name": name, "route": "cuda", "source": KERNELS[name][1],
                           "replaces": KERNELS[name][2], **results[name]} for name in KERNELS]}
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
