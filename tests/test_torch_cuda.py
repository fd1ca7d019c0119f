"""The CUDA tile blenders (pair blender K1, K2; bucket rasterizer K3, K4;
each for the gs2d and the gut3d response model, K1 and K2 also for the
mesh models gs2d_clip, tri2d and tri2d_smooth) and the probe kernels P1-P3
(vk_gaussian_splatting_tpu_torch/probes) on a card, against their plain
PyTorch twins.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

Tolerance, kernel against twin on one device: 1e-4 max abs on rgb and
transmittance. Both evaluate every alpha with the same f32 operations in the
same order (the kernel is built with -fmad=false and exact expf), so alphas
agree bit for bit; the running transmittance multiplies in another order
(sequential in the kernel, a cumprod times the step's start value in the
twin), and a pixel whose T lands within an ulp of min_transmittance (1e-4)
at a step start may freeze one step apart, which moves it by at most about
1e-4. Picked ids agree on at least 99.9% of pixels.

Backward kernel against the twin backward: each gradient row within 1e-4
of the row's max abs. Alphas agree bit for bit again; T, the running sum
s_run and the sums over the tile's pixels run in other orders. The suffix
S_total - s_run cancels to ~ulp(S_total) at a pixel's last pairs and is
divided by 1 - alpha, down to 1e-3: up to ~1.2e-4 of S_total per
pair-pixel. Measured on an H100: 1.5e-6 on this 128x96 scene with a random
cotangent, 1.9e-5 on the golden scene with the cotangent of sum(image^2).
As that bound cannot see a long-tailed row's ordinary values, in each row
at least 99.9 % of values must also lie within 1e-2 of their own size plus
the row's median nonzero size (measured on an H100: the 99.9th percentile
of that ratio up to 1.5e-3 on the golden frame). chip_smoke.py holds K2 to
the same two gates.

The per-tile cull of K2, K3 and K4 must change nothing: K3, K3g, K4 and
K4g against their twins (which sweep every lane), K2 and K2g against
theirs (which cull alike and equal the full sweep bit for bit,
tests/test_torch_rasterize.py), on scenes with rows at the predicate's
edges, and each kernel's kept counter against the plain predicate's count,
K3's equal to K4's. K1's and K1g's per-warp cull likewise: the kernels
against their twins (which sweep every pair) on the edge rows at every
chunk the tests use, the kept (warp, pair) counter equal to the plain
count, no culled (warp, pair) that hits, repeats bit-equal.

The probe kernels only compare, select and copy, so each must equal its
twin bit for bit.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.render import render
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    bin_for_cfg,
    gs_attr_rows,
    raster_statics,
)

ATOL = 1e-4
ID_AGREE = 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the blender kernel runs only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bins_on(device, cfg, seed=0, n=4000, scale_range=(-3.5, -1.5)):
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], cfg.width,
                     cfg.height, fov_y_rad=0.9, device=device)
    proj = project_splats(interop.splat_set_from_numpy(d, device).prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    return bin_for_cfg(proj, rows, ids, cfg, 0)


def assert_kernel_matches_twin(bins, st):
    out_k, id_k = tr.rasterize_bins(bins, st)
    out_r, id_r = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                         bins.tile_count, st)
    torch.cuda.synchronize()
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item()
    assert err <= ATOL, err
    same = id_k == id_r
    assert same.float().mean().item() >= ID_AGREE
    assert torch.equal(out_k[:, 4][same], out_r[:, 4][same])  # same splat, same depth
    return out_k, id_k


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [128, 64, 256])
def test_kernel_matches_twin(cuda, chunk):
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=1,
                          raster=gt.RasterConfig(chunk=chunk))
    bins = bins_on(cuda, cfg)
    st = raster_statics(cfg)
    out_k, _ = assert_kernel_matches_twin(bins, st)
    assert out_k[:, 3].min().item() < st.min_transmittance  # pixels froze


@pytest.mark.cuda
def test_kernel_counts_launches_and_repeats_bit_equal(cuda):
    cfg = gt.RenderConfig(width=120, height=90, sh_degree=1)
    bins = bins_on(cuda, cfg, seed=1, n=1500)
    st = raster_statics(cfg)
    before = tr.rasterize_tiles.launches
    a = tr.rasterize_bins(bins, st)
    b = tr.rasterize_bins(bins, st)
    torch.cuda.synchronize()
    assert tr.rasterize_tiles.launches == before + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_kernel_empty_tiles(cuda):
    cfg = gt.RenderConfig(width=64, height=48)
    st = raster_statics(cfg)
    n_t = st.tiles_x * st.tiles_y
    z = torch.zeros((n_t,), dtype=torch.int32, device=cuda)
    out, out_id = tr.rasterize_tiles(torch.zeros((10, 0), device=cuda),
                                     torch.zeros((0,), dtype=torch.int32, device=cuda),
                                     z, z, st)
    assert (out[:, :3] == 0).all() and (out[:, 3] == 1).all()
    assert (out[:, 4] == 0).all() and (out_id == -1).all()


@pytest.mark.cuda
def test_kernel_rejects_oversized_chunk(cuda):
    cfg = gt.RenderConfig(width=64, height=48, raster=gt.RasterConfig(chunk=512))
    bins = bins_on(cuda, cfg, n=100)
    with pytest.raises(ValueError, match="chunk"):
        tr.rasterize_bins(bins, raster_statics(cfg))


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda):
    """The whole frame on the card against the same frame on the CPU, where
    the twin blends. The two devices' exp, sigmoid and matmul libraries
    differ in the last ulp, which can flip a splat-pixel across the
    d <= qmax or alpha >= alpha_min cutoff and move that one contribution by
    up to opacity * exp(-qmax / 2) * color. So the gate is flip-aware: at
    most 0.1% of pixel channels (36 of 36,864) beyond 5e-5, and none beyond
    2e-3 (measured on an H100: max 3.2e-4, ids all equal)."""
    d = interop.random_splat_arrays(2, 3000, sh_degree=3, scale_range=(-3.5, -1.5))
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=3)
    outs = []
    for dev in ("cpu", cuda):
        cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 128, 96,
                         fov_y_rad=0.9, device=dev)
        outs.append(render(interop.splat_set_from_numpy(d, dev).prepare(), cam, cfg))
    c, g = outs
    assert bool(c.overflow) == bool(g.overflow)
    diff = (g.image.cpu() - c.image).abs().flatten()
    n_far = int((diff > 5e-5).sum())
    assert n_far <= diff.numel() // 1000, n_far
    assert diff.max().item() <= 2e-3, diff.max().item()
    agree = (g.splat_id.cpu() == c.splat_id).float().mean().item()
    assert agree >= ID_AGREE, agree


BWD_RTOL = 1e-4


def splats_on(device, seed=0, n=4000, sh_degree=1, scale_range=(-3.5, -1.5)):
    d = interop.random_splat_arrays(seed, n, sh_degree=sh_degree, scale_range=scale_range)
    s = interop.splat_set_from_numpy(d, device)
    for f in interop.SPLAT_FIELDS:
        getattr(s, f).requires_grad_()
    return s


@pytest.mark.cuda
def test_bwd_kernel_matches_twin(cuda):
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=1)
    bins = bins_on(cuda, cfg)
    st = raster_statics(cfg)
    out, _ = tr.rasterize_bins(bins, st)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    before = tr.rasterize_tiles_bwd.launches
    d_k = tr.rasterize_tiles_bwd(bins.attrs, bins.tile_start, bins.tile_count, ctx, st)
    d_r = tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start, bins.tile_count, ctx, st)
    torch.cuda.synchronize()
    assert tr.rasterize_tiles_bwd.launches == before + 1
    for r in range(tr.GRAD_ROWS):
        scale = d_r[r].abs().max().item()
        assert scale > 0
        assert (d_k[r] - d_r[r]).abs().max().item() <= BWD_RTOL * scale, r
    for k, ref in zip(d_k[:tr.GRAD_ROWS], d_r[:tr.GRAD_ROWS]):
        limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
        assert ((k - ref).abs() <= limit).float().mean().item() >= 0.999
    assert (d_k[tr.GRAD_ROWS] == 0).all()  # the depth row
    assert out[:, 3].min().item() < st.min_transmittance  # pixels froze


@pytest.mark.cuda
def test_render_backward_on_card_repeats_bit_equal(cuda):
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=1)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 128, 96, fov_y_rad=0.9,
                     device=cuda)
    s = splats_on(cuda)
    grads = []
    for _ in range(2):
        for f in interop.SPLAT_FIELDS:
            getattr(s, f).grad = None
        image = render(s.prepare(), cam, cfg).image
        gt.rgb_loss(image, torch.full_like(image, 0.5)).backward()  # through SSIM too
        grads.append([getattr(s, f).grad.clone() for f in interop.SPLAT_FIELDS])
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_render_on_card_has_grad_fn_and_launches_bwd_once(cuda):
    cfg = gt.RenderConfig(width=120, height=90, sh_degree=1)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 120, 90, fov_y_rad=0.9,
                     device=cuda)
    s = splats_on(cuda, seed=1, n=1500)
    out = render(s.prepare(), cam, cfg)
    assert out.image.grad_fn is not None
    before = tr.rasterize_tiles_bwd.launches
    out.image.sum().backward()
    torch.cuda.synchronize()
    assert tr.rasterize_tiles_bwd.launches == before + 1
    assert all(bool(torch.isfinite(getattr(s, f).grad).all()) for f in interop.SPLAT_FIELDS)
    assert s.opacities.grad.abs().max().item() > 0


# ---- the bucket-grid rasterizer: K3 (forward) and K4 (backward) ----------
#
# K3 against its twin: the same gates as K1 (1e-4 max abs on rgb and T, ids
# on at least 99.9 % of pixels): both merge the spans by (depth, span,
# position), alphas agree bit for bit, and T multiplies in another order.
# K4 against its twin: 1e-4 of each row's max, plus the per-row elementwise
# gate, as K2; the twin sums a shared column over its tiles through a
# float64 prefix sum, the kernel in f32 in a fixed order.

from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import bucket_splats  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import bucket_statics  # noqa: E402


def bucket_bins_on(device, cfg, seed=0, n=3000, scale_range=(-5.0, 0.0)):
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], cfg.width,
                     cfg.height, fov_y_rad=0.9, device=device)
    proj = project_splats(interop.splat_set_from_numpy(d, device).prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    st = bucket_statics(cfg)
    return bucket_splats(proj, rows, ids, tiles_x=st.tiles_x, tiles_y=st.tiles_y,
                         caps=cfg.raster.bucket_caps), st


def bucket_cfg(w=128, h=96, caps=(512, 256, 512, 256), chunk=384):
    return gt.RenderConfig(width=w, height=h, sh_degree=1, raster=gt.RasterConfig(
        method="bucket", bucket_caps=caps, bucket_chunk=chunk))


def assert_k3_matches_twin(bins, st, caps):
    out_k, id_k = rb.rasterize_buckets(bins, st, caps)
    out_r, id_r = rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, caps)
    torch.cuda.synchronize()
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item()
    assert err <= ATOL, err
    same = id_k == id_r
    assert same.float().mean().item() >= ID_AGREE
    assert torch.equal(out_k[:, 4][same], out_r[:, 4][same])
    return out_k


@pytest.mark.cuda
@pytest.mark.parametrize("caps, chunk", [((512, 256, 512, 256), 384),
                                         ((384, 256, 384, 128), 128),
                                         ((256, 128, 128, 128), 1024)])
def test_bucket_kernel_matches_twin(cuda, caps, chunk):
    cfg = bucket_cfg(caps=caps, chunk=chunk)
    bins, st = bucket_bins_on(cuda, cfg)
    out = assert_k3_matches_twin(bins, st, caps)
    assert out[:, 3].min().item() < st.min_transmittance  # pixels froze


@pytest.mark.cuda
def test_bucket_kernels_count_launches_and_repeat_bit_equal(cuda):
    cfg = bucket_cfg(w=120, h=90)
    caps = cfg.raster.bucket_caps
    bins, st = bucket_bins_on(cuda, cfg, seed=1, n=1500)
    before = (rb.rasterize_buckets.launches, rb.rasterize_buckets_bwd.launches)
    a = rb.rasterize_buckets(bins, st, caps)
    b = rb.rasterize_buckets(bins, st, caps)
    g = torch.randn(a[0].shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(a[0], g)
    da = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps)
    db = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps)
    torch.cuda.synchronize()
    assert (rb.rasterize_buckets.launches, rb.rasterize_buckets_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(da, db)


@pytest.mark.cuda
def test_bucket_bwd_kernel_matches_twin(cuda):
    cfg = bucket_cfg(caps=(384, 256, 384, 128))
    caps = cfg.raster.bucket_caps
    bins, st = bucket_bins_on(cuda, cfg)
    out, _ = rb.rasterize_buckets(bins, st, caps)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    d_k = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps)
    d_r = rb.rasterize_buckets_bwd_ref(bins.attrs, bins.bucket_starts, ctx, st, caps)
    torch.cuda.synchronize()
    for r in range(tr.GRAD_ROWS):
        scale = d_r[r].abs().max().item()
        assert scale > 0
        assert (d_k[r] - d_r[r]).abs().max().item() <= BWD_RTOL * scale, r
    for k, ref in zip(d_k[:tr.GRAD_ROWS], d_r[:tr.GRAD_ROWS]):
        limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
        assert ((k - ref).abs() <= limit).float().mean().item() >= 0.999
    assert (d_k[tr.GRAD_ROWS:] == 0).all()
    assert out[:, 3].min().item() < st.min_transmittance  # pixels froze


@pytest.mark.cuda
def test_bucket_kernels_empty_tiles(cuda):
    cfg = bucket_cfg(w=64, h=48)
    st = bucket_statics(cfg)
    caps = cfg.raster.bucket_caps
    spec = rb.BucketGridSpec.build(st.tiles_x, st.tiles_y)
    attrs = torch.zeros((10, 0), device=cuda)
    starts = torch.zeros((spec.num_buckets + 1,), dtype=torch.int32, device=cuda)
    bins = rb.BucketBins(attrs, torch.zeros((0,), dtype=torch.int32, device=cuda), starts,
                         torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.bool))
    out, out_id = rb.rasterize_buckets(bins, st, caps)
    assert (out[:, :3] == 0).all() and (out[:, 3] == 1).all()
    assert (out[:, 4] == 0).all() and (out_id == -1).all()
    ctx = torch.ones((st.tiles_x * st.tiles_y, tr.CTX_ROWS, tr.PIX), device=cuda)
    assert rb.rasterize_buckets_bwd(attrs, starts, ctx, st, caps).shape == (10, 0)


@pytest.mark.cuda
def test_bucket_caps_above_48kb_of_shared_memory(cuda):
    """Golden-tiled caps: 8,448 lanes, 67.6 KB of keys and lane indices."""
    caps = (4608, 1536, 256, 256)
    cfg = bucket_cfg(caps=caps)
    bins, st = bucket_bins_on(cuda, cfg)
    assert rb._fn("raster_bucket_fwd", "_smem")(sum(rb._span_sizes(caps)), st.chunk) > 48 << 10
    out = assert_k3_matches_twin(bins, st, caps)
    ctx = tr.bwd_context(out, torch.ones_like(out))
    d_k = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps)
    d_r = rb.rasterize_buckets_bwd_ref(bins.attrs, bins.bucket_starts, ctx, st, caps)
    for r in range(tr.GRAD_ROWS):
        assert (d_k[r] - d_r[r]).abs().max().item() <= BWD_RTOL * d_r[r].abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("caps, match", [((65536, 128, 128, 128), "shared memory"),
                                         ((500, 256, 512, 256), "multiples of 128"),
                                         ((512, 256, 0, 256), "multiples of 128")])
def test_bucket_caps_the_card_cannot_take_raise(cuda, caps, match):
    cfg = bucket_cfg(w=64, h=48, caps=(512, 256, 512, 256))
    bins, st = bucket_bins_on(cuda, cfg, n=200)
    with pytest.raises(ValueError, match=match):
        rb.rasterize_buckets(bins, st, caps)
    ctx = torch.zeros((st.tiles_x * st.tiles_y, tr.CTX_ROWS, tr.PIX), device=cuda)
    with pytest.raises(ValueError, match=match):
        rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps)


@pytest.mark.cuda
def test_bucket_render_on_card_launches_k3_and_k4_once(cuda):
    cfg = bucket_cfg(w=120, h=90)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 120, 90, fov_y_rad=0.9,
                     device=cuda)
    s = splats_on(cuda, seed=1, n=1500)
    before = (rb.rasterize_buckets.launches, rb.rasterize_buckets_bwd.launches)
    out = render(s.prepare(), cam, cfg)
    gt.rgb_loss(out.image, torch.full_like(out.image, 0.5)).backward()
    torch.cuda.synchronize()
    assert (rb.rasterize_buckets.launches, rb.rasterize_buckets_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(bool(torch.isfinite(getattr(s, f).grad).all()) for f in interop.SPLAT_FIELDS)


# ---- the gut3d model (3DGUT, 3DGRT): K1-K4 with the per-tile rays ----------
#
# Kernel against twin on one card, flip-aware: the kernels round each alpha
# as the twins do (-fmad=false, rsqrtf and expf as torch's CUDA ops), but a
# ray-response cutoff (resp > kernel_min_response) that one side's rounding
# flips drops a whole pair-pixel, moving a pixel by up to about
# kernel_min_response * opacity ~ 1.1e-2 (verify SKILL). So: rgb and T
# within 1e-4 on >= 99.9 % of values and none beyond 1.2e-2, ids on >= 99.9
# % of pixels; each gradient row >= 99.9 % within 1e-2 (|ref| + the row's
# median nonzero |ref|) and none beyond 2e-3 of the row's max.

from vk_gaussian_splatting_tpu_torch.ops.projection import ut_project_splats  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    gut_attr_rows,
    gut_statics,
)
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays  # noqa: E402

GUT_SHARE, GUT_MAX, GUT_BWD_MAX = 0.999, 1.2e-2, 2e-3


def gut_setup(device, method="pairs", degree=2, fisheye=False, w=128, h=96, seed=0, n=1500,
              camera="pinhole", scale_range=(-3.5, -1.5)):
    """Bins, statics, caps and rays of a 3DGUT frame on ``device``; camera
    "fisheye", "rolling" (top to bottom, the end pose 0.4 to the right) or
    "dof" (aperture 0.3 focused at 9) instead of the pinhole."""
    fisheye = fisheye or camera == "fisheye"
    raster = gt.RasterConfig(method=method, bucket_caps=(512, 256, 512, 256))
    shutter = (gt.ShutterType.ROLLING_TOP_TO_BOTTOM if camera == "rolling"
               else gt.ShutterType.GLOBAL)
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=1, pipeline=gt.Pipeline.MESH_3DGUT,
                          camera_type=gt.CameraType.FISHEYE if fisheye else gt.CameraType.PINHOLE,
                          shutter=shutter, rt=gt.RtConfig(kernel_degree=degree), raster=raster)
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                     device=device)
    if camera == "rolling":
        vm_end = cam.viewmat.clone()
        vm_end[0, 3] -= 0.4
        cam = dataclasses.replace(cam, viewmat_end=vm_end)
    if camera == "dof":
        cam = dataclasses.replace(cam, aperture=torch.tensor(0.3, device=device),
                                  focus_dist=torch.tensor(9.0, device=device))
    prep = interop.splat_set_from_numpy(d, device).prepare()
    proj = ut_project_splats(prep, cam, cfg)
    rows, ids = gut_attr_rows(prep, proj, cfg)
    st = gut_statics(raster_statics(cfg), cfg)
    if method == "bucket":
        st = dataclasses.replace(st, chunk=cfg.raster.bucket_chunk)
        bins = bucket_splats(proj, rows.detach(), ids, tiles_x=st.tiles_x, tiles_y=st.tiles_y,
                             caps=raster.bucket_caps, grad_rows=14)
    else:
        bins = bin_for_cfg(proj, rows.detach(), ids, cfg, 0, st)
    return bins, st, raster.bucket_caps, build_tile_rays(cam, cfg)


def gut_fwd(bins, st, caps, pix, twin=False, seed=0):
    if isinstance(bins, rb.BucketBins):
        if twin:
            return rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, caps,
                                            pix_ctx=pix, seed=seed)
        return rb.rasterize_buckets(bins, st, caps, pix, seed)
    if twin:
        return tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                      bins.tile_count, st, pix_ctx=pix, seed=seed)
    return tr.rasterize_bins(bins, st, pix, seed)


def gut_bwd(bins, st, caps, ctx, pix, twin=False, seed=0):
    if isinstance(bins, rb.BucketBins):
        fn = rb.rasterize_buckets_bwd_ref if twin else rb.rasterize_buckets_bwd
        return fn(bins.attrs, bins.bucket_starts, ctx, st, caps, pix_ctx=pix, seed=seed)
    fn = tr.rasterize_tiles_bwd_ref if twin else tr.rasterize_tiles_bwd
    return fn(bins.attrs, bins.tile_start, bins.tile_count, ctx, st, pix_ctx=pix, seed=seed)


def assert_gut_fwd_matches(out_k, id_k, out_r, id_r):
    diff = (out_k[:, :4] - out_r[:, :4]).abs()
    assert (diff <= ATOL).float().mean().item() >= GUT_SHARE
    assert diff.max().item() <= GUT_MAX, diff.max().item()
    assert (id_k == id_r).float().mean().item() >= ID_AGREE


def assert_gut_bwd_matches(d_k, d_r, share=0.999):
    for r in range(14):
        k, ref = d_k[r], d_r[r]
        scale = ref.abs().max().item()
        assert scale > 0, r
        assert (k - ref).abs().max().item() <= GUT_BWD_MAX * scale, r
        limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
        assert ((k - ref).abs() <= limit).float().mean().item() >= share, r
    assert (d_k[14] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("method, degree, fisheye", [
    ("pairs", 2, False), ("pairs", 3, False), ("pairs", 2, True),
    ("bucket", 2, False), ("bucket", 8, False), ("bucket", 2, True)])
def test_gut3d_kernels_match_twins(cuda, method, degree, fisheye):
    bins, st, caps, pix = gut_setup(cuda, method, degree, fisheye)
    out_k, id_k = gut_fwd(bins, st, caps, pix)
    out_r, id_r = gut_fwd(bins, st, caps, pix, twin=True)
    torch.cuda.synchronize()
    assert_gut_fwd_matches(out_k, id_k, out_r, id_r)
    assert out_k[:, 3].min().item() < 1e-3  # opaque pixels
    g = torch.randn(out_k.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out_k, g)
    d_k = gut_bwd(bins, st, caps, ctx, pix)
    d_r = gut_bwd(bins, st, caps, ctx, pix, twin=True)
    torch.cuda.synchronize()
    assert_gut_bwd_matches(d_k, d_r)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_gut3d_kernels_count_launches_and_repeat_bit_equal(cuda, method):
    bins, st, caps, pix = gut_setup(cuda, method, w=120, h=90, seed=1)
    fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
    bwd = rb.rasterize_buckets_bwd if method == "bucket" else tr.rasterize_tiles_bwd
    before = (fwd.launches, fwd.launches_gut3d, bwd.launches, bwd.launches_gut3d)
    a = gut_fwd(bins, st, caps, pix)
    b = gut_fwd(bins, st, caps, pix)
    ctx = tr.bwd_context(a[0], torch.ones_like(a[0]))
    da = gut_bwd(bins, st, caps, ctx, pix)
    db = gut_bwd(bins, st, caps, ctx, pix)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.launches_gut3d, bwd.launches, bwd.launches_gut3d) == (
        before[0], before[1] + 2, before[2], before[3] + 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(da, db)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline, method", [("MESH_3DGUT", "pairs"), ("MESH_3DGUT", "bucket"),
                                              ("RTX", "pairs"), ("RTX", "bucket")])
def test_gut_render_on_card_launches_once_per_sample(cuda, pipeline, method):
    cfg = gt.RenderConfig(width=120, height=90, sh_degree=1, pipeline=gt.Pipeline[pipeline],
                          temporal_samples=2, raster=gt.RasterConfig(method=method))
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 120, 90, fov_y_rad=0.9,
                     device=cuda)
    cam = dataclasses.replace(cam, aperture=torch.tensor(0.2, device=cuda),
                              focus_dist=torch.tensor(9.0, device=cuda))
    s = splats_on(cuda, seed=1, n=1500)
    fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
    bwd = rb.rasterize_buckets_bwd if method == "bucket" else tr.rasterize_tiles_bwd
    before = (fwd.launches_gut3d, bwd.launches_gut3d, fwd.launches)
    out = render(s.prepare(), cam, cfg)
    gt.rgb_loss(out.image, torch.full_like(out.image, 0.5)).backward()
    torch.cuda.synchronize()
    assert (fwd.launches_gut3d, bwd.launches_gut3d, fwd.launches) == (
        before[0] + 2, before[1] + 2, before[2])
    assert all(bool(torch.isfinite(getattr(s, f).grad).all()) for f in interop.SPLAT_FIELDS)
    assert s.means.grad.abs().max().item() > 0 and s.quats.grad.abs().max().item() > 0


# ---- K4's per-tile cull (csrc/response.cuh may_hit) on the card ------------
#
# K4 and K4g against their twins, which sweep every lane, on scenes with
# rows at the predicate's edges; the kept counter against the plain
# predicate (ops/raster_bucket.bucket_work) exactly, as K1's and K2's
# (the predicate runs in double with margins for the card's roundings); the repeat
# bit-equal, counter included. Rows stay finite where a hit could turn the
# VJP's arithmetic into NaN in both (tests/test_torch_bucket.py and
# tests/test_torch_gut.py hold the predicate on inf rows).


def f32_next(x, toward):
    return float(np.nextafter(np.float32(x), np.float32(toward)))


def with_rows(bins, st, caps, edits, pix=None):
    """``bins`` with the first live columns' rows rewritten, one ``edits``
    dict {row: value} per column; a "centre" key puts the column's x, y on
    a pixel centre of a tile that reads it."""
    tiles = torch.arange(st.tiles_x * st.tiles_y, device=bins.attrs.device)
    lists = rb._tile_lists(bins.attrs, bins.bucket_starts, st, caps, tiles)
    lanes = lists.cols.view(tiles.shape[0], -1)
    attrs = bins.attrs.clone()
    picked = torch.unique(lists.cols[lists.cols >= 0])[:len(edits)]
    for col, edit in zip(picked.tolist(), edits):
        edit = dict(edit)
        if edit.pop("centre", False):
            t = int(torch.nonzero((lanes == col).any(dim=1))[0])
            attrs[0, col] = (t % st.tiles_x) * 16 + 3.5
            attrs[1, col] = (t // st.tiles_x) * 16 + 5.5
        for row, value in edit.items():
            attrs[row, col] = value
    return dataclasses.replace(bins, attrs=attrs)


def gs2d_edge_rows(st):
    """(rows that may hit, rows that cannot) at the gs2d predicate's edges,
    each centred on a pixel of a tile that reads it."""
    amin, nan = float(np.float32(st.alpha_min)), float("nan")
    rows = [{5: amin}, {5: f32_next(amin, 1)}, {5: f32_next(amin, 0)},
            {2: 0.5, 3: 0.4999999, 4: 0.5}, {2: 0.5, 3: 0.8, 4: 0.5},
            {2: -0.01, 3: 0.0, 4: -0.01}, {2: 0.0, 3: 0.0, 4: 0.0}, {5: 3e38}]
    never = [{0: nan}, {5: nan}, {3: nan}]
    return [dict(r, centre=True) for r in rows], [dict(r, centre=True) for r in never]


def quiet(edits, never, opacity_row):
    """``edits`` followed by the rows ``never``, which cannot hit (NaN, or a
    scale at the 1e-12 floor), each replaced by its column's own row with
    opacity 0, which cannot hit either. The kernel runs the VJP on hits
    alone and stores zeros for such a row; the twin's masked VJP can give
    NaN there (0 x NaN, 0 x inf), and its float64 prefix sum over the
    columns carries that into every later column. So the twin runs on the
    quiet rows."""
    return list(edits) + [{opacity_row: 0.0} for _ in never]


def assert_kept_matches_plain(model, work, live, wrapper=rb.rasterize_buckets_bwd):
    """The kept count of ``wrapper``'s last launch (K4's by default) against
    the plain predicate's; returns it."""
    kept = int(getattr(wrapper, rb.KEPT_COUNTER[model]))
    assert 0 < kept < live
    assert kept == work.kept, (kept, work.kept)
    return kept


@pytest.mark.cuda
@pytest.mark.parametrize("scale_range", [(-5.0, 0.0), (-3.0, 0.5)])
def test_bucket_bwd_kernel_culls_exactly_on_edge_rows(cuda, scale_range):
    """Both gates of K4 against its twin on the scene of
    test_bucket_bwd_kernel_matches_twin's density; on the denser one
    (splats up to e^0.5, most lanes mid or coarse) the row gate alone: its
    opacity row has 0.13 % of values beyond the elementwise limit, with
    the kernel before the cull too, bit for bit (an H100, PERF.md §6)."""
    cfg = bucket_cfg(caps=(512, 256, 512, 256))
    caps = cfg.raster.bucket_caps
    plain, st = bucket_bins_on(cuda, cfg, n=1500, scale_range=scale_range)
    edits, never = gs2d_edge_rows(st)
    bins = with_rows(plain, st, caps, edits + never)
    quiet_attrs = with_rows(plain, st, caps, quiet(edits, never, 5)).attrs
    out, _ = rb.rasterize_buckets(bins, st, caps)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    d_k = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps)
    d_r = rb.rasterize_buckets_bwd_ref(quiet_attrs, bins.bucket_starts, ctx, st, caps)
    torch.cuda.synchronize()
    assert torch.isfinite(d_k).all() and torch.isfinite(d_r).all()
    for r in range(tr.GRAD_ROWS):
        scale = d_r[r].abs().max().item()
        assert (d_k[r] - d_r[r]).abs().max().item() <= BWD_RTOL * scale, r
        if scale_range[1] <= 0.0:
            limit = 1e-2 * (d_r[r].abs() + d_r[r].abs()[d_r[r] != 0].median())
            assert ((d_k[r] - d_r[r]).abs() <= limit).float().mean().item() >= 0.999, r
    work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps)
    kept = assert_kept_matches_plain("gs2d", work, work.live)
    hit = rb.tile_lane_hits(bins.attrs, bins.bucket_starts, st, caps)
    may = rb.tile_may_hit(bins.attrs, bins.bucket_starts, st, caps)
    assert int((hit & ~may).sum()) == 0
    again = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps)
    torch.cuda.synchronize()
    assert torch.equal(d_k, again) and int(rb.rasterize_buckets_bwd.kept) == kept


@pytest.mark.cuda
@pytest.mark.parametrize("degree, camera", [(0, "pinhole"), (1, "fisheye"), (2, "rolling"),
                                            (3, "dof"), (4, "pinhole"), (5, "rolling"),
                                            (8, "dof")])
def test_gut3d_bwd_kernel_culls_exactly(cuda, degree, camera):
    plain, st, caps, pix = gut_setup(cuda, "bucket", degree, camera=camera, n=1200,
                                     scale_range=(-3.5, -0.5))
    amin = float(np.float32(st.alpha_min))
    nan = float("nan")
    edits = [{13: amin}, {13: f32_next(amin, 1)}, {13: f32_next(amin, 0)}, {9: 1.5}]
    never = [{3: 1e-12}, {3: 1e-12, 4: 1e-12, 5: 1e-12}, {0: nan}, {13: nan}]
    bins = with_rows(plain, st, caps, edits + never)
    quiet_bins = with_rows(plain, st, caps, quiet(edits, never, 13))
    out, _ = rb.rasterize_buckets(bins, st, caps, pix)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    d_k = gut_bwd(bins, st, caps, ctx, pix)
    d_r = gut_bwd(quiet_bins, st, caps, ctx, pix, twin=True)
    torch.cuda.synchronize()
    assert torch.isfinite(d_k).all() and torch.isfinite(d_r).all()
    assert_gut_bwd_matches(d_k, d_r)
    work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix)
    kept = assert_kept_matches_plain("gut3d", work, work.live)
    hit = rb.tile_lane_hits(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix)
    may = rb.tile_may_hit(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix)
    assert int((hit & ~may).sum()) == 0
    again = gut_bwd(bins, st, caps, ctx, pix)
    torch.cuda.synchronize()
    assert torch.equal(d_k, again) and int(rb.rasterize_buckets_bwd.kept_gut3d) == kept


# ---- K3's per-tile cull on the card -------------------------------------------
#
# K3 and K3g, which stage only the lanes the cull keeps, against their twins
# (which sweep every lane) on the edge-row scenes above, with the forward
# gates; K3's kept counter against the plain predicate's count (exactly, as
# K4's) and equal to K4's on the same bins (one
# predicate, csrc/response.cuh may_hit, over the same steps and freeze,
# since the compaction both use lives in csrc/raster_bucket.cuh); repeats
# bit-equal, counters included.


def assert_fwd_cull(bins, st, caps, work, model, pix=None):
    """K3's kept count against the plain predicate's, its repeat and K4's
    count on the same bins; returns K3's count."""
    out, out_id = rb.rasterize_buckets(bins, st, caps, pix)
    torch.cuda.synchronize()
    kept = assert_kept_matches_plain(model, work, work.live, rb.rasterize_buckets)
    again, again_id = rb.rasterize_buckets(bins, st, caps, pix)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out_id, again_id)
    assert int(getattr(rb.rasterize_buckets, rb.KEPT_COUNTER[model])) == kept
    ctx = tr.bwd_context(out, torch.ones_like(out))
    rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps, pix)
    torch.cuda.synchronize()
    assert int(getattr(rb.rasterize_buckets_bwd, rb.KEPT_COUNTER[model])) == kept
    return kept


@pytest.mark.cuda
@pytest.mark.parametrize("scale_range", [(-5.0, 0.0), (-3.0, 0.5)])
def test_bucket_fwd_kernel_culls_exactly_on_edge_rows(cuda, scale_range):
    cfg = bucket_cfg(caps=(512, 256, 512, 256))
    caps = cfg.raster.bucket_caps
    plain, st = bucket_bins_on(cuda, cfg, n=1500, scale_range=scale_range)
    edits, never = gs2d_edge_rows(st)
    bins = with_rows(plain, st, caps, edits + never)
    out = assert_k3_matches_twin(bins, st, caps)
    assert out[:, 3].min().item() < st.min_transmittance  # pixels froze
    work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps)
    assert_fwd_cull(bins, st, caps, work, "gs2d")


@pytest.mark.cuda
@pytest.mark.parametrize("degree, camera", [(0, "pinhole"), (1, "fisheye"), (2, "rolling"),
                                            (3, "dof"), (8, "pinhole")])
def test_gut3d_fwd_kernel_culls_exactly(cuda, degree, camera):
    plain, st, caps, pix = gut_setup(cuda, "bucket", degree, camera=camera, n=1200,
                                     scale_range=(-3.5, -0.5))
    amin = float(np.float32(st.alpha_min))
    nan = float("nan")
    edits = [{13: amin}, {13: f32_next(amin, 1)}, {13: f32_next(amin, 0)}, {9: 1.5},
             {3: 1e-12}, {3: 1e-12, 4: 1e-12, 5: 1e-12}, {0: nan}, {13: nan}]
    bins = with_rows(plain, st, caps, edits)
    out_k, id_k = gut_fwd(bins, st, caps, pix)
    out_r, id_r = gut_fwd(bins, st, caps, pix, twin=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out_k).all() and torch.isfinite(out_r).all()
    assert_gut_fwd_matches(out_k, id_k, out_r, id_r)
    work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix)
    assert_fwd_cull(bins, st, caps, work, "gut3d", pix)


# ---- K2's per-tile cull of the pair lists on the card -----------------------
#
# K2 and K2g sweep only the pairs their cull keeps (csrc/response.cuh
# may_hit) and reduce each group of kept pairs' rows at once: against their
# twins on the edge rows above, put on pair columns, at chunk 1, 32, 128 and
# 256 (a reduction group then ends at a shared-memory batch's or a step's
# end); the kept counter against the plain predicate's count (blend_work
# over the pairs pair_may_hit keeps, or every tested pair where the model
# does not cull) exactly; no culled pair that hits (pair_hits); repeats bit-equal,
# counter included. The twin runs on the quiet rows, as K4's tests do.


def with_pair_rows(bins, st, edits):
    """``bins`` (pair lists) with the first pair of each of the first busy
    tiles rewritten, one ``edits`` dict {row: value} per pair; a "centre"
    key puts the pair's x, y on a pixel centre of its own tile."""
    busy = torch.nonzero(bins.tile_count > 0).flatten()[:len(edits)]
    attrs = bins.attrs.clone()
    for t, edit in zip(busy.tolist(), edits):
        col, edit = int(bins.tile_start[t]), dict(edit)
        if edit.pop("centre", False):
            attrs[0, col] = (t % st.tiles_x) * 16 + 3.5
            attrs[1, col] = (t // st.tiles_x) * 16 + 5.5
        for row, value in edit.items():
            attrs[row, col] = value
    return dataclasses.replace(bins, attrs=attrs)


def assert_pair_kept_matches_plain(bins, st, model, pix=None):
    """K2's kept count of its last launch against the plain predicate's
    (every tested pair where the model does not cull), and no culled pair
    that hits; returns the count."""
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    may = tr.pair_may_hit(*args, pix_ctx=pix)
    _, _, tested, kept_plain, _, _ = tr.blend_work(*args, pix_ctx=pix, keep=may)
    want = kept_plain if tr.model_of(st).cull_pairs else tested
    kept = int(getattr(tr.rasterize_tiles_bwd, tr.KEPT_COUNTER[model]))
    assert 0 < kept <= tested
    assert kept == want, (kept, want)
    assert int((tr.pair_hits(*args, pix_ctx=pix) & ~may).sum()) == 0
    return kept


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32, 128, 256])
def test_pair_bwd_kernel_culls_exactly_on_edge_rows(cuda, chunk):
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=1,
                          raster=gt.RasterConfig(chunk=chunk))
    st = raster_statics(cfg)
    plain = bins_on(cuda, cfg, n=3000)
    edits, never = gs2d_edge_rows(st)
    bins = with_pair_rows(plain, st, edits + never)
    quiet_attrs = with_pair_rows(plain, st, quiet(edits, never, 5)).attrs
    out, _ = tr.rasterize_bins(bins, st)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    args = (bins.tile_start, bins.tile_count, tr.bwd_context(out, g), st)
    d_k = tr.rasterize_tiles_bwd(bins.attrs, *args)
    d_r = tr.rasterize_tiles_bwd_ref(quiet_attrs, *args)
    torch.cuda.synchronize()
    assert torch.isfinite(d_k).all() and torch.isfinite(d_r).all()
    for r in range(tr.GRAD_ROWS):
        k, ref = d_k[r], d_r[r]
        assert (k - ref).abs().max().item() <= BWD_RTOL * ref.abs().max().item(), r
        limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
        assert ((k - ref).abs() <= limit).float().mean().item() >= 0.999, r
    assert (d_k[tr.GRAD_ROWS] == 0).all()
    kept = assert_pair_kept_matches_plain(bins, st, "gs2d")
    again = tr.rasterize_tiles_bwd(bins.attrs, *args)
    torch.cuda.synchronize()
    assert torch.equal(d_k, again) and int(tr.rasterize_tiles_bwd.kept) == kept


@pytest.mark.cuda
@pytest.mark.parametrize("degree, camera, chunk", [(0, "pinhole", 1), (1, "fisheye", 32),
                                                   (2, "rolling", 128), (3, "dof", 256),
                                                   (8, "pinhole", 128)])
def test_gut3d_pair_bwd_kernel_culls_exactly(cuda, degree, camera, chunk):
    """K2g culls no pair (csrc/response.cuh Gut3d::CULL_PAIRS): its counter
    holds every tested pair. At degree 8 the opacity row has 0.14 % of its
    values beyond the elementwise limit, with the kernel before the batched
    reduction too, bit for bit (an H100, PERF.md §6): the degree-8 response
    raises D to the fourth power, so the card's and the twin's roundings
    flip more cutoffs. That case holds 99.8 %."""
    plain, st, caps, pix = gut_setup(cuda, "pairs", degree, camera=camera, n=1200,
                                     scale_range=(-3.5, -0.5))
    st = dataclasses.replace(st, chunk=chunk)  # slots binning does not depend on it
    # scales at the 1e-12 floor are left out: on a pair list such a splat
    # can hit, and the twin's masked VJP of it overflows to NaN at degree 8
    amin = float(np.float32(st.alpha_min))
    nan = float("nan")
    edits = [{13: amin}, {13: f32_next(amin, 1)}, {13: f32_next(amin, 0)}, {9: 1.5}]
    never = [{0: nan}, {13: nan}]
    bins = with_pair_rows(plain, st, edits + never)
    quiet_bins = with_pair_rows(plain, st, quiet(edits, never, 13))
    out, _ = gut_fwd(bins, st, caps, pix)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    d_k = gut_bwd(bins, st, caps, ctx, pix)
    d_r = gut_bwd(quiet_bins, st, caps, ctx, pix, twin=True)
    torch.cuda.synchronize()
    assert torch.isfinite(d_k).all() and torch.isfinite(d_r).all()
    assert_gut_bwd_matches(d_k, d_r, share=0.998 if degree == 8 else 0.999)
    kept = assert_pair_kept_matches_plain(bins, st, "gut3d", pix)
    again = gut_bwd(bins, st, caps, ctx, pix)
    torch.cuda.synchronize()
    assert torch.equal(d_k, again) and int(tr.rasterize_tiles_bwd.kept_gut3d) == kept


# ---- the two cases below the elementwise gate, against float64 ---------------
#
# K4 on the dense edge-row scene and K2g at degree 8 hold less than 99.9 % of
# their opacity row within the elementwise limit of the f32 twin. Which side
# is off: the kernel's f32 rows and the f32 twin's, each against the twins
# run in float64 on the CPU (the forward twin in float64 gives the
# context). Measured on an H100: the opacity row's share within the limit
# of float64 is 0.99800 for K4 and 0.99833 for its f32 twin, 0.99759 for
# K2g and 0.99787 for its twin: f32 itself lies that far from exact
# arithmetic, the kernel no further than the twin. So the cases keep their
# gates (ROADMAP queue 3, a divergence), and the test holds the kernel's
# share of float64 to the twin's, less 5e-4, in every row.


def elementwise_share(k, ref):
    """The share of ``k`` within 1e-2 (|ref| + the row's median nonzero
    |ref|) of ``ref``, the per-row gate of K2 and K4."""
    limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
    return ((k - ref).abs() <= limit).double().mean().item()


def low_case(dev, name):
    """(bins, the twin's bins, statics, caps, pixel context, gradient rows,
    opacity row) of the K4 dense scene ("k4_dense") or the K2g degree-8
    scene ("k2g_deg8") on ``dev``, as the edge-row tests above build them."""
    if name == "k4_dense":
        cfg = bucket_cfg(caps=(512, 256, 512, 256))
        caps = cfg.raster.bucket_caps
        plain, st = bucket_bins_on(dev, cfg, n=1500, scale_range=(-3.0, 0.5))
        edits, never = gs2d_edge_rows(st)
        bins = with_rows(plain, st, caps, edits + never)
        return (bins, with_rows(plain, st, caps, quiet(edits, never, 5)), st, caps, None,
                tr.GRAD_ROWS, 5)
    plain, st, caps, pix = gut_setup(dev, "pairs", 8, camera="pinhole", n=1200,
                                     scale_range=(-3.5, -0.5))
    amin = float(np.float32(st.alpha_min))
    edits = [{13: amin}, {13: f32_next(amin, 1)}, {13: f32_next(amin, 0)}, {9: 1.5}]
    never = [{0: float("nan")}, {13: float("nan")}]
    bins = with_pair_rows(plain, st, edits + never)
    return (bins, with_pair_rows(plain, st, quiet(edits, never, 13)), st, caps, pix, 14, 13)


def float64_twin_bwd(bins, st, caps, pix, g):
    """The twins' d_attrs of ``bins`` in float64 on the CPU, the context
    from the float64 forward twin and the cotangent ``g``."""
    cpu = dataclasses.replace(bins, **{f.name: getattr(bins, f.name).cpu()
                                       for f in dataclasses.fields(bins)
                                       if torch.is_tensor(getattr(bins, f.name))})
    cpu = dataclasses.replace(cpu, attrs=cpu.attrs.double())
    pix64 = None if pix is None else pix.cpu().double()
    out64, _ = gut_fwd(cpu, st, caps, pix64, twin=True)
    return gut_bwd(cpu, st, caps, tr.bwd_context(out64, g.cpu().double()), pix64, twin=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["k4_dense", "k2g_deg8"])
def test_low_gradient_cases_against_float64(cuda, name):
    bins, quiet_bins, st, caps, pix, grad_rows, opacity = low_case(cuda, name)
    out, _ = gut_fwd(bins, st, caps, pix)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    d_k = gut_bwd(bins, st, caps, ctx, pix).cpu().double()
    d_r = gut_bwd(quiet_bins, st, caps, ctx, pix, twin=True).cpu().double()
    d64 = float64_twin_bwd(quiet_bins, st, caps, pix, g)
    assert torch.isfinite(d_k).all() and torch.isfinite(d64).all()
    for r in range(grad_rows):
        k64, r64 = elementwise_share(d_k[r], d64[r]), elementwise_share(d_r[r], d64[r])
        scale = d64[r].abs().max().item()
        err_k = (d_k[r] - d64[r]).abs().max().item() / scale
        err_r = (d_r[r] - d64[r]).abs().max().item() / scale
        print(f"{name} row {r}: share of float64: kernel {k64:.5f}, f32 twin {r64:.5f}; "
              f"max |diff| / row max: kernel {err_k:.3e}, f32 twin {err_r:.3e}")
        assert k64 >= r64 - 5e-4, (r, k64, r64)
        assert max(err_k, err_r) <= BWD_RTOL, (r, err_k, err_r)
    assert elementwise_share(d_r[opacity], d64[opacity]) < 0.999


# ---- K1's per-warp cull of the pair lists on the card ------------------------
#
# K1 and K1g skip, per warp, the pairs their cull drops (csrc/response.cuh
# reach against each warp's bound): against their twins, which sweep every
# pair, on the edge rows above put on pair columns, at chunk 1, 32, 64, 128
# and 256; the kept (warp, pair) counter equal to the plain count
# (blend_work over pair_warp_may_hit's mask); no culled (warp, pair) that
# hits (pair_hits per warp); repeats bit-equal, counter included.


def assert_warp_kept_matches_plain(bins, st, model, pix=None):
    """K1's kept (warp, pair) count of its last launch against the plain
    count, and no culled (warp, pair) that hits; returns the count."""
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    may = tr.pair_warp_may_hit(*args, pix_ctx=pix)
    _, _, tested, kept_plain, _, _ = tr.blend_work(*args, pix_ctx=pix, keep=may)
    kept = int(getattr(tr.rasterize_tiles, tr.KEPT_COUNTER[model]))
    assert 0 < kept < tr.WARPS * tested
    assert kept == kept_plain, (kept, kept_plain)
    assert int((tr.pair_hits(*args, pix_ctx=pix, per_warp=True) & ~may).sum()) == 0
    return kept


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 32, 64, 128, 256])
def test_pair_fwd_kernel_culls_exactly_on_edge_rows(cuda, chunk):
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=1,
                          raster=gt.RasterConfig(chunk=chunk))
    st = raster_statics(cfg)
    edits, never = gs2d_edge_rows(st)
    bins = with_pair_rows(bins_on(cuda, cfg, n=3000), st, edits + never)
    out, out_id = assert_kernel_matches_twin(bins, st)
    assert out[:, 3].min().item() < st.min_transmittance  # pixels froze
    kept = assert_warp_kept_matches_plain(bins, st, "gs2d")
    again, again_id = tr.rasterize_bins(bins, st)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out_id, again_id)
    assert int(tr.rasterize_tiles.kept) == kept


@pytest.mark.cuda
@pytest.mark.parametrize("degree, camera, chunk", [(0, "pinhole", 1), (1, "fisheye", 32),
                                                   (2, "rolling", 128), (3, "dof", 256),
                                                   (8, "pinhole", 64)])
def test_gut3d_pair_fwd_kernel_culls_exactly(cuda, degree, camera, chunk):
    plain, st, caps, pix = gut_setup(cuda, "pairs", degree, camera=camera, n=1200,
                                     scale_range=(-3.5, -0.5))
    st = dataclasses.replace(st, chunk=chunk)  # slots binning does not depend on it
    amin = float(np.float32(st.alpha_min))
    nan = float("nan")
    edits = [{13: amin}, {13: f32_next(amin, 1)}, {13: f32_next(amin, 0)}, {9: 1.5},
             {3: 1e-12}, {3: 1e-12, 4: 1e-12, 5: 1e-12}, {0: nan}, {13: nan}]
    bins = with_pair_rows(plain, st, edits)
    out_k, id_k = gut_fwd(bins, st, caps, pix)
    out_r, id_r = gut_fwd(bins, st, caps, pix, twin=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out_k).all() and torch.isfinite(out_r).all()
    assert_gut_fwd_matches(out_k, id_k, out_r, id_r)
    kept = assert_warp_kept_matches_plain(bins, st, "gut3d", pix)
    again, again_id = gut_fwd(bins, st, caps, pix)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again) and torch.equal(id_k, again_id)
    assert int(tr.rasterize_tiles.kept_gut3d) == kept


# ---- the packed tier: K1 and K3 for gs2dp and gut3dp (forward only) -----
#
# Each packed kernel against its twin (the f32 twin after ops/response
# unpack_rows) on the golden scene and on an adversarial one: mixed scales
# exp(-5 .. 0.5) and splats whose packed words are f32 subnormals (a red or
# blue of 0, a quaternion x or z of 0: the word's high bf16 half is +-0), at
# K1's and K3's gates (gut3dp: the flip-aware gut3d gates); the kept count
# equal to the plain predicate's, no culled (warp, pair) or lane that hits;
# repeats bit-equal; the packed launch counter, and no other, up by one per
# launch. Through ``render``: one packed launch per frame, packed rows made
# on the card bit-equal to those made on the CPU from the same f32 rows, and
# a backward that raises NotImplementedError.

from vk_gaussian_splatting_tpu_torch.io import load_ply  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import (  # noqa: E402
    BucketGridSpec,
    fit_caps,
    measure_required_caps,
)
from vk_gaussian_splatting_tpu_torch.ops.response import pack_rows  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    gs_attr_rows_packed,
    gut_bin,
)

GOLDEN_PLY = os.path.join(os.path.dirname(__file__), "..", "assets", "golden",
                          "golden_scene.ply")
PACKED_MODELS = {"gs2dp": gt.Pipeline.MESH, "gut3dp": gt.Pipeline.MESH_3DGUT}


def adversarial_arrays(seed=3, n=3000):
    """Mixed scales, and a third of the splats with packed words that are
    f32 subnormals: red or blue clamped to 0, quaternion x or z 0."""
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-5.0, 0.5))
    d["sh_dc"][0::3, 0] = -6.0
    d["sh_dc"][1::3, 2] = -6.0
    d["sh_rest"][0::3, :, 0] = 0.0
    d["sh_rest"][1::3, :, 2] = 0.0
    d["quats"][0::4, 1] = 0.0
    d["quats"][1::4, 3] = 0.0
    return d


def packed_setup(device, model, method, scene, w=128, h=96):
    """(cfg, prepared, camera) of a packed frame on ``device``: the golden
    scene (SH 0) or ``adversarial_arrays``; bucket caps fitted to the frame."""
    if scene == "golden":
        prep = load_ply(GOLDEN_PLY, device=device).prepare()
        cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                         device=device)
        sh = 0
    else:
        prep = interop.splat_set_from_numpy(adversarial_arrays(), device).prepare()
        cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                         device=device)
        sh = 1
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=sh, pipeline=PACKED_MODELS[model],
                          raster=gt.RasterConfig(method=method, pair_format="packed"))
    if method == "bucket":
        spec = BucketGridSpec.build(-(-w // 16), -(-h // 16))
        proj = (ut_project_splats if model == "gut3dp" else project_splats)(prep, cam, cfg)
        caps = fit_caps(measure_required_caps(proj, spec))
        cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, bucket_caps=caps))
    return cfg, prep, cam


def packed_bins(cfg, prep, cam):
    """(bins, blend statics, caps, pixel context) of ``packed_setup``'s frame,
    as render() makes them."""
    if cfg.pipeline == gt.Pipeline.MESH_3DGUT:
        bins, st = gut_bin(prep, ut_project_splats(prep, cam, cfg), cam, cfg)
        pix = build_tile_rays(cam, cfg)
    else:
        proj = project_splats(prep, cam, cfg)
        rows, ids = gs_attr_rows_packed(proj)
        st = raster_statics(cfg)
        bins = bin_for_cfg(proj, rows, ids, cfg, 0, st)
        pix = None
    if cfg.raster.method == "bucket":
        st = dataclasses.replace(st, chunk=cfg.raster.bucket_chunk)
    return bins, st, cfg.raster.bucket_caps, pix


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["golden", "adversarial"])
@pytest.mark.parametrize("model, method", [("gs2dp", "pairs"), ("gs2dp", "bucket"),
                                           ("gut3dp", "pairs"), ("gut3dp", "bucket")])
def test_packed_kernels_match_twins(cuda, model, method, scene):
    bins, st, caps, pix = packed_bins(*packed_setup(cuda, model, method, scene))
    assert st.model == model and not bool(bins.overflow) or method == "pairs"
    bucket = method == "bucket"
    fwd = rb.rasterize_buckets if bucket else tr.rasterize_tiles
    before = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
    out_k, id_k = gut_fwd(bins, st, caps, pix)
    kept = int(getattr(fwd, tr.KEPT_COUNTER[model]))
    again, again_id = gut_fwd(bins, st, caps, pix)
    out_r, id_r = gut_fwd(bins, st, caps, pix, twin=True)
    torch.cuda.synchronize()
    after = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
    assert after == {m: before[m] + 2 * (m == model) for m in before}
    assert torch.equal(out_k, again) and torch.equal(id_k, again_id)
    assert int(getattr(fwd, tr.KEPT_COUNTER[model])) == kept
    if model == "gs2dp":
        assert (out_k[:, :4] - out_r[:, :4]).abs().max().item() <= ATOL
        same = id_k == id_r
        assert same.float().mean().item() >= ID_AGREE
        assert torch.equal(out_k[:, 4][same], out_r[:, 4][same])
    else:
        assert_gut_fwd_matches(out_k, id_k, out_r, id_r)
    assert out_k[:, 3].min().item() < 1e-3  # opaque pixels
    if bucket:
        work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix)
        assert kept == work.kept and 0 < kept < work.live, (kept, work)
        may = rb.tile_may_hit(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix)
        hits = rb.tile_lane_hits(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix)
        assert int((hits & ~may).sum()) == 0
    else:
        assert_warp_kept_matches_plain(bins, st, model, pix)


@pytest.mark.cuda
@pytest.mark.parametrize("model, method", [("gs2dp", "pairs"), ("gs2dp", "bucket"),
                                           ("gut3dp", "pairs"), ("gut3dp", "bucket")])
def test_packed_render_on_card_launches_once_and_refuses_backward(cuda, model, method):
    cfg, _, cam = packed_setup(cuda, model, method, "adversarial", w=120, h=90)
    splats = interop.splat_set_from_numpy(adversarial_arrays(), cuda)
    for f in interop.SPLAT_FIELDS:
        getattr(splats, f).requires_grad_()
    fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
    before = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
    out = render(splats.prepare(), cam, cfg)
    torch.cuda.synchronize()
    after = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
    assert after == {m: before[m] + (m == model) for m in before}
    assert torch.isfinite(out.image).all() and float(out.transmittance.min()) < 0.5
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.image.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("model", list(PACKED_MODELS))
def test_packed_rows_on_card_equal_cpu_rows(cuda, model):
    """The same f32 rows packed on the card and on the CPU
    (``ops/response.pack_rows``): bit-equal words (bf16 rounding to nearest
    even and the u16 round half to even on both), the subnormal words of
    the adversarial scene included."""
    cfg, prep, cam = packed_setup(cuda, model, "pairs", "adversarial")
    if model == "gut3dp":
        rows = gut_attr_rows(prep, ut_project_splats(prep, cam, cfg), cfg)[0].detach()
    else:
        rows = gs_attr_rows(project_splats(prep, cam, cfg))[0].detach()
    words = [pack_rows(model, r).cpu().view(torch.int32) for r in (rows, rows.cpu())]
    assert torch.equal(words[0], words[1])
    high = words[1] & -65536
    assert int(((high == 0) | (high == -2**31)).sum()) > 100  # subnormal words were there


# ---- the stochastic forms of K1-K4 (RasterStatics.stochastic) -------------
#
# Each against its twin on one card. An accepted pair is opaque, so T is
# exactly 0 or 1 and each pixel is one splat's colour, depth and id. gs2d
# and gs2dp alphas equal the twins' bit for bit (-fmad=false, expf as
# torch's), so their frames are bit-equal; a gut3d accept flips where an
# alpha the two round apart straddles its uniform, so >= 99.9 % of pixels
# bit-equal (all five rows and the id), the others counted. The backward
# forms give the colour rows their sums (K2's and K4's gates, the gut3d
# ones for gut3d) and every other row exactly 0, and repeat bit for bit.
# The kept counters equal the plain counts over the same stochastic sweep
# (the culls keep what they keep in the deterministic form; a stochastic
# tile freezes sooner, so it enters fewer steps).

STOCH_SEED = 7920
STOCH_FORMS = [("gs2d", "pairs"), ("gs2d", "bucket"), ("gs2dp", "pairs"), ("gs2dp", "bucket"),
               ("gut3d", "pairs"), ("gut3d", "bucket"), ("gut3dp", "pairs"),
               ("gut3dp", "bucket")]


def stoch_setup(device, model, method, w=128, h=96):
    """(bins, stochastic statics, caps, pixel context) of a frame of ``model``."""
    caps = pix = None
    if model in PACKED_MODELS:
        bins, st, caps, pix = packed_bins(*packed_setup(device, model, method, "adversarial",
                                                        w, h))
    elif model == "gut3d":
        bins, st, caps, pix = gut_setup(device, method, w=w, h=h)
    elif method == "bucket":
        cfg = bucket_cfg(w, h)
        bins, st = bucket_bins_on(device, cfg)
        caps = cfg.raster.bucket_caps
    else:
        cfg = gt.RenderConfig(width=w, height=h, sh_degree=1)
        bins, st = bins_on(device, cfg), raster_statics(cfg)
    return bins, dataclasses.replace(st, stochastic=True), caps, pix


def stoch_kept_plain(bins, st, caps, pix, kernel):
    """The plain kept count of ``kernel`` ("K1" to "K4") over the
    stochastic sweep of STOCH_SEED."""
    if kernel in ("K3", "K4"):
        return rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps, pix_ctx=pix,
                              seed=STOCH_SEED).kept
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    may = (tr.pair_warp_may_hit if kernel == "K1" else tr.pair_may_hit)(*args, pix_ctx=pix)
    _, _, tested, kept, _, _ = tr.blend_work(*args, pix_ctx=pix, keep=may, seed=STOCH_SEED)
    return kept if kernel == "K1" or tr.model_of(st).cull_pairs else tested


@pytest.mark.cuda
@pytest.mark.parametrize("model, method", STOCH_FORMS)
def test_stochastic_fwd_kernels_match_twins(cuda, model, method):
    bins, st, caps, pix = stoch_setup(cuda, model, method)
    bucket = method == "bucket"
    fwd = rb.rasterize_buckets if bucket else tr.rasterize_tiles
    form = model + tr.STOCH
    before = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
    out_k, id_k = gut_fwd(bins, st, caps, pix, seed=STOCH_SEED)
    kept = int(getattr(fwd, tr.KEPT_COUNTER[form]))
    again, again_id = gut_fwd(bins, st, caps, pix, seed=STOCH_SEED)
    other, _ = gut_fwd(bins, st, caps, pix, seed=STOCH_SEED + 1)
    out_r, id_r = gut_fwd(bins, st, caps, pix, twin=True, seed=STOCH_SEED)
    torch.cuda.synchronize()
    after = {m: getattr(fwd, tr.LAUNCH_COUNTER[m]) for m in tr.LAUNCH_COUNTER}
    assert after == {m: before[m] + 3 * (m == form) for m in before}
    assert torch.equal(out_k, again) and torch.equal(id_k, again_id)
    assert not torch.equal(out_k, other)  # another seed, another frame
    assert set(out_k[:, 3].unique().tolist()) == {0.0, 1.0}  # opaque accepts, T exact
    same = (out_k == out_r).all(dim=1) & (id_k == id_r)            # (T, 256) pixels
    if model in ("gs2d", "gs2dp"):
        assert torch.equal(out_k, out_r) and torch.equal(id_k, id_r)
    else:
        assert same.float().mean().item() >= ID_AGREE, int((~same).sum())
    plain = stoch_kept_plain(bins, st, caps, pix, "K3" if bucket else "K1")
    if bool(same.all()):
        assert kept == plain, (kept, plain)
    else:  # a flipped accept may keep a tile live for a step more or less
        assert abs(kept - plain) <= 0.01 * plain, (kept, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("model, method", [("gs2d", "pairs"), ("gs2d", "bucket"),
                                           ("gut3d", "pairs"), ("gut3d", "bucket")])
def test_stochastic_bwd_kernels_match_twins(cuda, model, method):
    bins, st, caps, pix = stoch_setup(cuda, model, method)
    bucket = method == "bucket"
    bwd = rb.rasterize_buckets_bwd if bucket else tr.rasterize_tiles_bwd
    form = model + tr.STOCH
    out, _ = gut_fwd(bins, st, caps, pix, twin=True, seed=STOCH_SEED)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    before = {m: getattr(bwd, tr.LAUNCH_COUNTER[m]) for m in ("gs2d", "gut3d", "gs2d_stoch",
                                                              "gut3d_stoch")}
    d_k = gut_bwd(bins, st, caps, ctx, pix, seed=STOCH_SEED)
    kept = int(getattr(bwd, tr.KEPT_COUNTER[form]))
    again = gut_bwd(bins, st, caps, ctx, pix, seed=STOCH_SEED)
    d_r = gut_bwd(bins, st, caps, ctx, pix, twin=True, seed=STOCH_SEED)
    torch.cuda.synchronize()
    after = {m: getattr(bwd, tr.LAUNCH_COUNTER[m]) for m in before}
    assert after == {m: before[m] + 2 * (m == form) for m in before}
    assert torch.equal(d_k, again)
    assert bool(torch.isfinite(d_k).all())
    colour = range(tr.ATTR_R, tr.ATTR_B + 1)
    for r in range(d_k.shape[0]):
        if r not in colour:
            assert (d_k[r] == 0).all() and (d_r[r] == 0).all(), r
            continue
        k, ref = d_k[r], d_r[r]
        scale = ref.abs().max().item()
        assert scale > 0, r
        rtol = BWD_RTOL if model == "gs2d" else GUT_BWD_MAX
        assert (k - ref).abs().max().item() <= rtol * scale, r
        limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
        assert ((k - ref).abs() <= limit).float().mean().item() >= 0.999, r
    plain = stoch_kept_plain(bins, st, caps, pix, "K4" if bucket else "K2")
    assert abs(kept - plain) <= (0 if model == "gs2d" else 0.01 * plain), (kept, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline, method", [("MESH", "pairs"), ("MESH", "bucket"),
                                              ("MESH_3DGUT", "pairs"), ("RTX", "bucket")])
def test_stochastic_render_and_train_step_on_card(cuda, pipeline, method):
    """A 2-sample stochastic frame launches the stochastic forward and
    backward forms once per sample and no other form; only the colour path
    carries gradients (opacities, scales and quaternions exactly 0); it
    repeats bit for bit; a train step on it is finite."""
    cfg = gt.RenderConfig(width=120, height=90, sh_degree=1, pipeline=gt.Pipeline[pipeline],
                          stochastic=gt.StochasticMode.SPLAT, temporal_samples=2,
                          raster=gt.RasterConfig(method=method))
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 120, 90, fov_y_rad=0.9,
                     device=cuda)
    form = ("gs2d" if pipeline == "MESH" else "gut3d") + tr.STOCH
    fwd = rb.rasterize_buckets if method == "bucket" else tr.rasterize_tiles
    bwd = rb.rasterize_buckets_bwd if method == "bucket" else tr.rasterize_tiles_bwd
    counters = ("gs2d", "gut3d", "gs2d_stoch", "gut3d_stoch")
    grads = []
    for _ in range(2):
        s = splats_on(cuda, seed=1, n=1500)
        before = [getattr(w, tr.LAUNCH_COUNTER[m]) for w in (fwd, bwd) for m in counters]
        out = render(s.prepare(), cam, cfg)
        gt.rgb_loss(out.image, torch.full_like(out.image, 0.5)).backward()
        torch.cuda.synchronize()
        after = [getattr(w, tr.LAUNCH_COUNTER[m]) for w in (fwd, bwd) for m in counters]
        assert after == [b + 2 * (m == form) for b, m in zip(before, counters * 2)]
        grads.append([getattr(s, f).grad for f in interop.SPLAT_FIELDS])
    for f, a, b in zip(interop.SPLAT_FIELDS, *grads):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all()), f
        if f in ("opacities", "scales", "quats"):
            assert (a == 0).all(), f
    assert grads[0][interop.SPLAT_FIELDS.index("sh_dc")].abs().max().item() > 0
    tcfg = gt.TrainConfig(scene_extent=3.0)
    opt = gt.make_optimizer(s, tcfg)
    loss, _ = gt.train_step(s, opt, cam, torch.full((90, 120, 3), 0.5, device=cuda), cfg, 0, tcfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(getattr(s, f)).all()) for f in interop.SPLAT_FIELDS)


# ---- the probes P1-P3: bitonic sort (csrc/bench_roll.cu), sort stages
# (csrc/bench_sort_stage.cu), pipelined bulk copies (csrc/bench_radix_ab.cu)

from vk_gaussian_splatting_tpu_torch.probes import bench_radix_ab as pa  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_roll as pr  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_sort_stage as ps  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import l2_fill as lf  # noqa: E402


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def with_keys(x, key_row, keys):
    """x with the key row replaced: "equal" keys, "binary" keys from {0, 1},
    or "zeros_nan" keys from {+0, -0, NaN, 1}."""
    x = x.clone()
    g = torch.Generator(device=x.device).manual_seed(4)
    shape = x[:, key_row].shape
    if keys == "equal":
        x[:, key_row] = 0.25
    elif keys == "binary":
        x[:, key_row] = torch.randint(0, 2, shape, generator=g, device=x.device).float()
    else:
        vals = torch.tensor([0.0, -0.0, float("nan"), 1.0], device=x.device)
        x[:, key_row] = vals[torch.randint(0, 4, shape, generator=g, device=x.device)]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("t, r, c, reps", [(3, 4, 128, 3), (1, 16, 2048, 2), (5, 3, 2, 1),
                                           (2, 5, 4096, 1), (0, 4, 64, 1), (133, 16, 2048, 1),
                                           (2, 4, 128, 200), (7, 3, 2, 3), (4, 1, 256, 3),
                                           (1, 16, 2048, 200), (5, 6, 16384, 1)])
def test_probe_bitonic_sort_matches_twin(cuda, t, r, c, reps):
    """P1 against its twin: reps 1, 3 and 200 (the index carried across the
    reps), T = 133 (not a multiple of the blocks on an SM), C from 2 (rows
    loaded by hand) to 16384 (16 pairs a thread), one row (no payload)."""
    x = pr.tiles_of(t, r, c, cuda)
    before = pr.bitonic_sort.launches
    out = pr.bitonic_sort(x, reps)
    torch.cuda.synchronize()
    assert pr.bitonic_sort.launches == before + (t > 0)
    assert torch.equal(out, pr.bitonic_sort_ref(x, reps))
    if t:
        assert torch.equal(out[:, 0], torch.sort(x[:, 0], dim=-1).values)


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["floor", "equal", "binary", "zeros_nan"])
def test_probe_bitonic_sort_with_ties_and_limits(cuda, keys):
    x = pr.tiles_of(4, 6, 256, cuda)
    x = torch.floor(x * 5) if keys == "floor" else with_keys(x, 0, keys)  # ties, NaN
    for reps in (1, 3):
        assert same_bits(pr.bitonic_sort(x, reps), pr.bitonic_sort_ref(x, reps))
    with pytest.raises(ValueError, match="shared memory"):   # 12 C bytes: 384 KB
        pr.bitonic_sort(pr.tiles_of(1, 2, 32768, cuda))
    with pytest.raises(ValueError, match="power of two"):
        pr.bitonic_sort(pr.tiles_of(1, 4, 96, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ps.VARIANTS)
@pytest.mark.parametrize("rows, n_stages, tpt", [(4, 55, 2), (16, 20, 2), (8, 70, 5),
                                                 (1, 55, 3), (16, 55, 2), (2, 20, 2),
                                                 (32, 70, 2), (4, 55, 1)])
def test_probe_sort_stages_match_twin(cuda, variant, rows, n_stages, tpt):
    x, m, sched = ps.inputs(variant, rows, n_stages, tpt, cuda)
    before = ps.sort_stages.launches[variant]
    out = ps.sort_stages(x, m, variant, sched, rows - 1, blocks=7)
    torch.cuda.synchronize()
    assert ps.sort_stages.launches[variant] == before + 1
    assert torch.equal(out, ps.sort_stages_ref(x, m, variant, sched, rows - 1))


def duplicating(masks, sched):
    """The table with want_min(e ^ j) = want_min(e) for the low columns e
    with e % 3 == 0: such a pair's two columns want one side, so one may
    take the other's column (a duplicate) or neither takes."""
    m = masks.clone().reshape(2 * len(sched), -1)
    e = torch.arange(m.shape[1], device=m.device)
    for s, (_, j) in enumerate(sched):
        lo = e[((e & j) == 0) & (e % 3 == 0)]
        m[2 * s + 1, lo | j] = m[2 * s + 1, lo]
    return m.reshape(masks.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ps.VARIANTS)
def test_probe_sort_stages_ties_and_limits(cuda, variant):
    x, m, sched = ps.inputs(variant, 4, 55, 2, cuda)
    for y in (torch.floor(x * 2), *(with_keys(x, 3, k) for k in ("equal", "binary",
                                                                  "zeros_nan"))):
        assert same_bits(ps.sort_stages(y, m, variant, sched, 3, blocks=3),
                         ps.sort_stages_ref(y, m, variant, sched, 3))
    if variant != "lane-iota":   # a table whose pairs may both take, or neither
        dup = duplicating(m, sched)
        out = ps.sort_stages(x, dup, variant, sched, 3, blocks=3)
        assert same_bits(out, ps.sort_stages_ref(x, dup, variant, sched, 3))
        assert len(torch.unique(out.reshape(2, 4, -1)[0, 3])) < 1024   # duplicated columns
    big, bm, bs = ps.inputs(variant, 4 if variant == "sub8" else 3, 5, 32, cuda)
    with pytest.raises(ValueError, match="shared memory"):   # 32 tiles' pairs: 256 KB
        ps.sort_stages(big, bm, variant, bs, big.shape[1] - 1)
    if variant == "sub8":
        with pytest.raises(ValueError, match="registers"):
            ps.sort_stages(*ps.inputs(variant, 3, 5, 1, cuda)[:2], variant, sched[:5], 2)
    else:
        y = ps.inputs(variant, 5, 55, 3, cuda)[0]
        assert torch.equal(ps.sort_stages(y, m, variant, sched, 0),
                           ps.sort_stages_ref(y, m, variant, sched, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("w", sorted(pa.WIDTHS + (3, 5, 17)))   # 17: uneven pieces
@pytest.mark.parametrize("n_steps, n_copies, steps_per_block", [
    (2, 9, None), (3, 20, 1), (1, 5, 1), (4, 64, 3),
    (300, 9, 1),                   # more blocks than the plan's two an SM on 132 SMs
    (6, 1, None), (5, 1, 2)])      # one copy a step
def test_probe_copies_match_twin(cuda, w, n_steps, n_copies, steps_per_block):
    g = torch.Generator(device=cuda).manual_seed(w)
    src = torch.randn((pa.SRC_BLOCKS, *pa.BLOCK), generator=g, device=cuda)
    before = pa.dma_copies.launches
    out, copies = pa.dma_copies(src, n_steps, n_copies, w, steps_per_block, trace=True)
    out_only = pa.dma_copies(src, n_steps, n_copies, w, steps_per_block)
    torch.cuda.synchronize()
    assert pa.dma_copies.launches == before + 2
    ref_out, ref_copies = pa.dma_copies_ref(src, n_steps, n_copies, w, trace=True)
    assert torch.equal(out, ref_out) and torch.equal(out_only, ref_out)
    assert torch.equal(copies, ref_copies)


@pytest.mark.cuda
def test_l2_fill_launches_and_refuses(cuda):
    src = torch.randn((pa.SRC_BLOCKS, *pa.BLOCK), device=cuda)
    for cfg in (dict(method="bulk", grid=4, per_sm=2, copies=64, w=16, piece=2, depth=3),
                dict(method="bulk", grid=1, per_sm=1, copies=64, w=1, depth=16, lanes=8),
                dict(method="vector", grid=4, per_sm=2, copies=64, w=16, u=8),
                dict(method="cpasync", grid=4, per_sm=3, copies=64, w=16, u=2, stages=4)):
        lf.fill(src, **cfg)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="cudaError"):   # a 512 KB ring
        lf.fill(src, method="bulk", grid=4, per_sm=1, copies=64, w=16, piece=8, depth=8)


# ---- the key-row forms of K3 and K4 (RasterStatics.key_is_row, gs2d): the
# host-sorted bucket frame, render_3dgs(host_order=...). The bins carry the
# host order's rank as the key row (ops/response.GS_KEY) and are sorted by
# it; the kernels merge on that row. Gates: K3's and K4's (the deterministic
# forms), bit for bit for the stochastic forward; the key row's gradient
# exactly 0; the kept counters equal to the plain predicate's count over
# the key-row merge; only the key-row form's launch counter moves.

from vk_gaussian_splatting_tpu_torch.io.async_loader import sort_order  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops.response import GS_KEY  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import host_rank, render_3dgs  # noqa: E402

KEYROW_FORMS = ("gs2d" + tr.KEYROW, "gs2d" + tr.STOCH + tr.KEYROW)


def keyrow_setup(device, reverse=False, seed=0, n=3000):
    """(bins, key-row statics, caps) of a host-sorted bucket frame: the order
    of the host sorter (``sort_order``) for the camera's view direction,
    reversed with ``reverse`` (a back-to-front blend)."""
    cfg = bucket_cfg()
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-5.0, 0.0))
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device=device)
    order = sort_order(d["means"], cam.viewmat.cpu().numpy()[2, :3])
    if reverse:
        order = order[::-1].copy()
    proj = project_splats(interop.splat_set_from_numpy(d, device).prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    rank = host_rank(order, rows.shape[1], device)
    st = dataclasses.replace(bucket_statics(cfg), key_is_row=True)
    bins = bucket_splats(proj, torch.cat([rows, rank[None]]), ids, tiles_x=st.tiles_x,
                         tiles_y=st.tiles_y, caps=cfg.raster.bucket_caps, sort_depth=rank)
    return bins, st, cfg.raster.bucket_caps


def launch_counts(wrapper):
    """Every launch counter the wrapper keeps (a backward's: the trained models')."""
    return {m: getattr(wrapper, name) for m, name in tr.LAUNCH_COUNTER.items()
            if hasattr(wrapper, name)}


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_keyrow_kernels_match_twins(cuda, stochastic, reverse):
    bins, st, caps = keyrow_setup(cuda, reverse)
    st = dataclasses.replace(st, stochastic=stochastic)
    seed = STOCH_SEED if stochastic else 0
    form = tr.form_of(st)
    assert form == KEYROW_FORMS[stochastic]
    fwd_before, bwd_before = launch_counts(rb.rasterize_buckets), launch_counts(
        rb.rasterize_buckets_bwd)
    out_k, id_k = rb.rasterize_buckets(bins, st, caps, None, seed)
    torch.cuda.synchronize()
    kept_fwd = int(getattr(rb.rasterize_buckets, tr.KEPT_COUNTER[form]))
    again = rb.rasterize_buckets(bins, st, caps, None, seed)
    out_r, id_r = rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, caps,
                                           seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(out_k, again[0]) and torch.equal(id_k, again[1])
    if stochastic:
        assert torch.equal(out_k, out_r) and torch.equal(id_k, id_r)
    else:
        assert (out_k[:, :4] - out_r[:, :4]).abs().max().item() <= ATOL
        same = id_k == id_r
        assert same.float().mean().item() >= ID_AGREE
        assert torch.equal(out_k[:, 4][same], out_r[:, 4][same])
    assert out_k[:, 3].min().item() < 0.5  # the frame covers pixels
    work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps, seed=seed)
    assert kept_fwd == work.kept, (kept_fwd, work.kept)

    g = torch.randn(out_k.shape, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    ctx = tr.bwd_context(out_r, g)
    d_k = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps, None, seed)
    torch.cuda.synchronize()
    kept_bwd = int(getattr(rb.rasterize_buckets_bwd, tr.KEPT_COUNTER[form]))
    d_again = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, caps, None, seed)
    d_r = rb.rasterize_buckets_bwd_ref(bins.attrs, bins.bucket_starts, ctx, st, caps, seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_again) and d_k.shape[0] == GS_KEY + 1
    assert (d_k[GS_KEY] == 0).all() and (d_k[tr.GRAD_ROWS:] == 0).all()
    rows = range(tr.ATTR_R, tr.ATTR_B + 1) if stochastic else range(tr.GRAD_ROWS)
    for r in range(tr.GRAD_ROWS):
        k, ref = d_k[r], d_r[r]
        if r not in rows:
            assert (k == 0).all() and (ref == 0).all(), r
            continue
        scale = ref.abs().max().item()
        assert scale > 0, r
        assert (k - ref).abs().max().item() <= BWD_RTOL * scale, r
        limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
        assert ((k - ref).abs() <= limit).float().mean().item() >= 0.999, r
    assert kept_bwd == kept_fwd
    for wrapper, before in ((rb.rasterize_buckets, fwd_before),
                            (rb.rasterize_buckets_bwd, bwd_before)):
        after = launch_counts(wrapper)
        assert after == {m: before[m] + 2 * (m == form) for m in before}


@pytest.mark.cuda
def test_keyrow_merge_follows_the_key_row(cuda):
    """A reversed host order blends back to front: the frame differs from
    the fresh order's by more than 1e-3, and the fresh order's frame equals
    the device-sorted bucket frame's within K3's gate."""
    fresh, st, caps = keyrow_setup(cuda)
    rev, _, _ = keyrow_setup(cuda, reverse=True)
    a, _ = rb.rasterize_buckets(fresh, st, caps)
    b, _ = rb.rasterize_buckets(rev, st, caps)
    plain, st_plain = bucket_bins_on(cuda, bucket_cfg())
    c, _ = rb.rasterize_buckets(plain, st_plain, caps)
    torch.cuda.synchronize()
    assert (a[:, :3] - b[:, :3]).abs().max().item() > 1e-3
    assert (a[:, :4] - c[:, :4]).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
def test_host_order_render_on_card_launches_keyrow_forms_once(cuda, stochastic):
    """render_3dgs(host_order=...) on the bucket path: one launch of the
    key-row form forward and backward per sample, no other form; finite
    gradients that repeat bit for bit."""
    cfg = bucket_cfg(w=120, h=90).replace(
        stochastic=gt.StochasticMode.SPLAT if stochastic else gt.StochasticMode.NONE,
        temporal_samples=2 if stochastic else 1)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 120, 90, fov_y_rad=0.9,
                     device=cuda)
    form = KEYROW_FORMS[stochastic]
    samples = 2 if stochastic else 1
    grads = []
    for _ in range(2):
        s = splats_on(cuda, seed=1, n=1500)
        order = sort_order(s.means.detach().cpu().numpy(), cam.viewmat.cpu().numpy()[2, :3])
        before = [launch_counts(w) for w in (rb.rasterize_buckets, rb.rasterize_buckets_bwd)]
        out = render_3dgs(s.prepare(), cam, cfg, host_order=order)
        gt.rgb_loss(out.image, torch.full_like(out.image, 0.5)).backward()
        torch.cuda.synchronize()
        for w, b in zip((rb.rasterize_buckets, rb.rasterize_buckets_bwd), before):
            assert launch_counts(w) == {m: b[m] + samples * (m == form) for m in b}
        grads.append([getattr(s, f).grad for f in interop.SPLAT_FIELDS])
    for f, a, b in zip(interop.SPLAT_FIELDS, *grads):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all()), f


# ---- meshes: K1 gs2d_clip (+ _stoch), tri2d, tri2d_smooth; K2 gs2d_clip (+ _stoch), tri2d
#
# render_mesh blends a depth-sorted triangle list with an opaque, unclamped
# alpha (T exactly 0 or 1); the composed frame blends the splats behind the
# mesh depth (gs2d_clip). The kernels against their twins at K1's and K2's
# gates, the kept counters against the plain culls exactly and no culled
# (warp, pair) that hits, on a sphere and on lists of slivers, collinear and
# coincident triangles in every tile; gs2d_clip with no limit equals gs2d
# bit for bit.

from vk_gaussian_splatting_tpu_torch.io.obj import ObjMaterial, octa_sphere  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import mesh_raster as mr  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import render_3dgs_composed  # noqa: E402

MESH_FORMS = ("tri2d", "tri2d_smooth", "gs2d_clip", "gs2d_clip" + tr.STOCH)


def octa_sphere_mesh(subdiv=3, radius=1.5):
    return octa_sphere(subdiv, radius, ObjMaterial(diffuse=(0.8, 0.6, 0.4)))


def mesh_cfg(shading="smooth", w=128, h=96):
    return gt.RenderConfig(width=w, height=h, sh_degree=1,
                           raster=gt.RasterConfig(mesh_shading=shading))


def mesh_camera(device, w=128, h=96):
    return gt.look_at([0.4, -0.6, -7.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                      device=device)


def adversarial_triangles(device, tiles_x=8, tiles_y=6, n=96):
    """tri2d lists with every one of ``n`` slivers, collinear and coincident
    triangles (and large ones across the tiles) in every tile's list."""
    rng = np.random.default_rng(4)
    a = rng.uniform(-20, 16 * tiles_x + 20, (n, 2))
    b = rng.uniform(-20, 16 * tiles_y + 20, (n, 2))
    c = a + (b - a) * rng.uniform(-0.3, 1.3, (n, 1))
    c[: n // 3] += rng.normal(scale=0.05, size=(n // 3, 2))           # slivers
    c[n // 3: n // 2] = a[n // 3: n // 2]                              # coincident pairs
    c[n // 2: 2 * n // 3] = np.round(c[n // 2: 2 * n // 3]) + 0.5     # on pixel centres
    c[2 * n // 3:] += rng.normal(scale=30.0, size=(n - 2 * n // 3, 2))  # ordinary
    rows = np.zeros((10, n), np.float32)
    rows[:6] = np.stack([a, b, c], axis=1).reshape(n, 6).T
    rows[6:9] = rng.uniform(0.1, 1.0, (3, n))
    rows[9] = rng.uniform(1.0, 5.0, n)
    rows = rows[:, np.argsort(rows[9])]
    t = tiles_x * tiles_y
    attrs = torch.from_numpy(np.tile(rows, (1, t))).to(device)
    start = (torch.arange(t, dtype=torch.int32) * n).to(device)
    count = torch.full((t,), n, dtype=torch.int32, device=device)
    bins = types.SimpleNamespace(attrs=attrs, pair_id=torch.arange(n * t, dtype=torch.int32,
                                                                   device=device),
                                 tile_start=start, tile_count=count)
    return bins, tr.RasterStatics(tiles_x, tiles_y, model="tri2d", depth_iso=0.999)


def mesh_setup(device, form, scene="sphere"):
    """(bins, statics, pixel context) of one mesh form's blend: the sphere's
    faces (tri2d, tri2d_smooth) or the adversarial lists, or the splats of
    a 128x96 frame behind the smooth sphere's depth (gs2d_clip)."""
    model = form.removesuffix(tr.STOCH)
    if scene == "adversarial":
        bins, st = adversarial_triangles(device)
        return bins, dataclasses.replace(st, model=model), None
    cfg = mesh_cfg("flat" if model == "tri2d" else "smooth")
    cam = mesh_camera(device)
    mesh = mr.mesh_buffers_from_obj(octa_sphere_mesh(), device=device)
    if model != "gs2d_clip":
        bins, st = mr.mesh_bins(mesh, cam, cfg)
        return bins, st, None
    depth = mr.render_mesh(mesh, cam, cfg)[2]
    st = dataclasses.replace(raster_statics(cfg), model=model, stochastic=form != model)
    return bins_on(device, cfg), st, mr.depth_limit_pix_ctx(depth, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("form, scene", [(f, "sphere") for f in MESH_FORMS]
                         + [("tri2d", "adversarial"), ("tri2d_smooth", "adversarial")])
def test_mesh_fwd_kernels_match_twins(cuda, form, scene):
    bins, st, pix = mesh_setup(cuda, form, scene)
    if st.model == "tri2d_smooth" and scene == "adversarial":  # its 18 rows from tri2d's
        a = bins.attrs
        bins.attrs = torch.cat([a[:6], a[6:9].repeat(3, 1), a[9:10].repeat(3, 1)]).contiguous()
    before = launch_counts(tr.rasterize_tiles)
    out_k, id_k = tr.rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start,
                                     bins.tile_count, st, pix, STOCH_SEED)
    kept = assert_warp_kept_matches_plain_stream(bins, st, form, pix)
    again, again_id = tr.rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start,
                                         bins.tile_count, st, pix, STOCH_SEED)
    out_r, id_r = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                         bins.tile_count, st, pix_ctx=pix, seed=STOCH_SEED)
    torch.cuda.synchronize()
    after = launch_counts(tr.rasterize_tiles)
    assert after == {m: before[m] + 2 * (m == form) for m in before}
    assert torch.equal(out_k, again) and torch.equal(id_k, again_id)
    assert int(getattr(tr.rasterize_tiles, tr.KEPT_COUNTER[form])) == kept
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item()
    assert err <= ATOL, err
    same = id_k == id_r
    assert same.float().mean().item() >= ID_AGREE
    assert torch.equal(out_k[:, 4][same], out_r[:, 4][same])
    if st.model != "gs2d_clip":  # opaque and unclamped: T is exactly 0 or 1
        assert set(out_k[:, 3].unique().tolist()) == {0.0, 1.0}


def assert_warp_kept_matches_plain_stream(bins, st, form, pix):
    """K1's kept count for ``form`` against the plain count of the sweep of
    STOCH_SEED (the stream only matters to a stochastic form), and no
    culled (warp, pair) that hits."""
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    may = tr.pair_warp_may_hit(*args, pix_ctx=pix)
    _, _, tested, plain, _, _ = tr.blend_work(*args, pix_ctx=pix, keep=may, seed=STOCH_SEED)
    torch.cuda.synchronize()
    kept = int(getattr(tr.rasterize_tiles, tr.KEPT_COUNTER[form]))
    assert 0 < kept < tr.WARPS * tested and kept == plain, (kept, plain, tested)
    assert int((tr.pair_hits(*args, pix_ctx=pix, per_warp=True) & ~may).sum()) == 0
    return kept


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [False, True])
def test_clip_without_limit_is_gs2d_bit_for_bit(cuda, stochastic):
    bins, st, pix = mesh_setup(cuda, "gs2d_clip" + (tr.STOCH if stochastic else ""))
    clip = tr.rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start, bins.tile_count, st,
                              torch.zeros_like(pix), STOCH_SEED)
    plain = tr.rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start, bins.tile_count,
                               dataclasses.replace(st, model="gs2d"), None, STOCH_SEED)
    limited = tr.rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start, bins.tile_count,
                                 st, pix, STOCH_SEED)
    torch.cuda.synchronize()
    assert torch.equal(clip[0], plain[0]) and torch.equal(clip[1], plain[1])
    assert (limited[0][:, 3] > plain[0][:, 3]).any()  # the sphere hides splats


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["gs2d_clip", "gs2d_clip" + tr.STOCH, "tri2d"])
def test_mesh_bwd_kernels_match_twins(cuda, form):
    bins, st, pix = mesh_setup(cuda, form)
    out, _ = tr.rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start, bins.tile_count,
                                st, pix, STOCH_SEED)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    ctx = tr.bwd_context(out, g)
    before = launch_counts(tr.rasterize_tiles_bwd)
    d_k = tr.rasterize_tiles_bwd(bins.attrs, bins.tile_start, bins.tile_count, ctx, st, pix,
                                 STOCH_SEED)
    assert_pair_kept_matches_plain_stream(bins, st, form, pix)
    again = tr.rasterize_tiles_bwd(bins.attrs, bins.tile_start, bins.tile_count, ctx, st, pix,
                                   STOCH_SEED)
    d_r = tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start, bins.tile_count, ctx, st,
                                     pix_ctx=pix, seed=STOCH_SEED)
    torch.cuda.synchronize()
    after = launch_counts(tr.rasterize_tiles_bwd)
    assert after == {m: before[m] + 2 * (m == form) for m in before}
    assert torch.equal(d_k, again)
    zero = list(range(6)) if st.model == "tri2d" or st.stochastic else []
    assert (d_k[zero] == 0).all() and (d_r[zero] == 0).all()  # no gradient through alpha
    assert (d_k[tr.GRAD_ROWS:] == 0).all()                      # the depth row
    for r in range(tr.GRAD_ROWS):
        if r in zero:
            continue
        scale = d_r[r].abs().max().item()
        assert scale > 0, r
        assert (d_k[r] - d_r[r]).abs().max().item() <= BWD_RTOL * scale, r
        limit = 1e-2 * (d_r[r].abs() + d_r[r].abs()[d_r[r] != 0].median())
        assert ((d_k[r] - d_r[r]).abs() <= limit).float().mean().item() >= 0.999, r


def assert_pair_kept_matches_plain_stream(bins, st, form, pix):
    """K2's kept count for ``form``: the plain predicate's where the model
    culls (gs2d_clip), every tested pair where it does not (tri2d)."""
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    may = tr.pair_may_hit(*args, pix_ctx=pix)
    _, _, tested, plain, _, _ = tr.blend_work(*args, pix_ctx=pix, keep=may, seed=STOCH_SEED)
    torch.cuda.synchronize()
    kept = int(getattr(tr.rasterize_tiles_bwd, tr.KEPT_COUNTER[form]))
    want = plain if tr.model_of(st).cull_pairs else tested
    assert 0 < kept <= tested and kept == want, (kept, want, tested)
    assert int((tr.pair_hits(*args, pix_ctx=pix) & ~may).sum()) == 0


@pytest.mark.cuda
def test_mesh_render_on_card_launches_once_and_matches_cpu(cuda):
    """render_mesh (smooth: K1 tri2d_smooth; flat: K1 and K2 tri2d) and the
    composed frame (K1 tri2d_smooth and gs2d_clip; backward K2 gs2d_clip)
    launch each form once a call; the card's composed frame matches the CPU
    twin's at the card-against-CPU gate (tests/test_torch_cuda.py
    test_render_on_card_matches_cpu); the face colours' gradient repeats."""
    cfg = mesh_cfg()
    cam = mesh_camera(cuda)
    obj = octa_sphere_mesh()
    mesh = mr.mesh_buffers_from_obj(obj, device=cuda)
    fwd, bwd = tr.rasterize_tiles, tr.rasterize_tiles_bwd
    before = launch_counts(fwd)
    img, trans, depth, fid = mr.render_mesh(mesh, cam, cfg)
    torch.cuda.synchronize()
    assert launch_counts(fwd) == {m: before[m] + (m == "tri2d_smooth") for m in before}
    assert set(trans.unique().tolist()) == {0.0, 1.0} and bool((fid[trans == 0] >= 0).all())
    grads = []
    for _ in range(2):
        flat = mr.mesh_buffers_from_obj(obj, device=cuda)
        flat.face_colors.requires_grad_()
        b = [launch_counts(w) for w in (fwd, bwd)]
        out = mr.render_mesh(flat, cam, mesh_cfg("flat"))[0]
        (out * out).sum().backward()
        torch.cuda.synchronize()
        for w, c in zip((fwd, bwd), b):
            assert launch_counts(w) == {m: c[m] + (m == "tri2d") for m in c}
        grads.append(flat.face_colors.grad)
    assert torch.equal(grads[0], grads[1]) and bool((grads[0] != 0).any())
    s = splats_on(cuda, n=3000)
    b = [launch_counts(w) for w in (fwd, bwd)]
    got = render_3dgs_composed(s.prepare(), cam, cfg, 0, mesh)
    gt.rgb_loss(got.image, torch.full_like(got.image, 0.5)).backward()
    torch.cuda.synchronize()
    assert launch_counts(fwd) == {m: b[0][m] + (m in ("tri2d_smooth", "gs2d_clip"))
                                  for m in b[0]}
    assert launch_counts(bwd) == {m: b[1][m] + (m == "gs2d_clip") for m in b[1]}
    for f in interop.SPLAT_FIELDS:
        assert bool(torch.isfinite(getattr(s, f).grad).all()), f
    d = interop.random_splat_arrays(0, 3000, sh_degree=1, scale_range=(-3.5, -1.5))
    cpu = render_3dgs_composed(interop.splat_set_from_numpy(d, "cpu").prepare(),
                               mesh_camera("cpu"), cfg, 0,
                               mr.mesh_buffers_from_obj(obj, device="cpu"))
    diff = (got.image.detach().cpu() - cpu.image).abs()
    assert (diff > 5e-5).float().mean().item() <= 1e-3 and diff.max().item() <= 2e-3
    cover = (got.transmittance.cpu() == 0) == (cpu.transmittance == 0)
    assert cover.float().mean().item() >= 0.999


# ---- lighting and shadows: K1's multi-iso form (the deep shadow maps) -------------------

from vk_gaussian_splatting_tpu_torch.render import shadows as sh  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.deferred import surface_points  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    render_3dgs_lit,
    render_hybrid,
)
from vk_gaussian_splatting_tpu_torch.scene.lights import LightType, make_light  # noqa: E402


def shadow_scene(device, n_blob=600, n_slab=1500):
    """A dense blob over a receiver slab (tests/test_torch_shadows.py's
    hybrid scene, more splats)."""
    blob = interop.random_splat_arrays(0, n_blob, sh_degree=0, extent=0.6,
                                       scale_range=(-2.0, -1.2))
    blob["opacities"][:] = 5.0
    slab = interop.random_splat_arrays(1, n_slab, sh_degree=0, extent=4.0,
                                       scale_range=(-2.0, -1.3))
    slab["means"] = (slab["means"] * np.float32([1.0, 0.05, 1.0])
                     + np.float32([0.0, 4.0, 0.0])).astype(np.float32)
    slab["opacities"][:] = 4.0
    d = {k: np.concatenate([blob[k], slab[k]]) for k in blob}
    return interop.splat_set_from_numpy(d, device)


def shadow_lights(device):
    """A directional light from above (the cone map) and a point light inside
    the scene's bounding sphere (the cube map)."""
    return (make_light(LightType.DIRECTIONAL, direction=(0.1, 1.0, 0.2), intensity=1.2,
                       device=device),
            make_light(LightType.POINT, position=(1.5, 2.5, 1.0), intensity=2.0, device=device))


def shadow_map_setup(device, res=128):
    prepared = shadow_scene(device).prepare()
    center, radius = sh.scene_bounds(prepared)
    cam = sh.light_camera(shadow_lights(device)[0], center, radius, res)
    cfg = gt.RenderConfig(width=res, height=res, sh_degree=0)
    return sh.shadow_map_bins(prepared, cam, cfg, 1 << 18)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [128, 64])
def test_multi_iso_kernel_matches_twin(cuda, res):
    bins, st = shadow_map_setup(cuda, res)
    before = launch_counts(tr.rasterize_tiles)
    out_k, id_k = tr.rasterize_bins(bins, st)
    kept = assert_warp_kept_matches_plain_stream(bins, st, "gs2d_iso", None)
    again, _ = tr.rasterize_bins(bins, st)
    out_r, id_r = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                         bins.tile_count, st)
    torch.cuda.synchronize()
    after = launch_counts(tr.rasterize_tiles)
    assert after == {m: before[m] + 2 * (m == "gs2d_iso") for m in before}
    assert int(tr.rasterize_tiles.kept_iso) == kept
    assert out_k.shape == (st.tiles_x * st.tiles_y, tr.ISO_OUT_ROWS, tr.PIX)
    assert torch.equal(out_k, again) and bool((id_k == -1).all())
    assert (out_k[:, :4] - out_r[:, :4]).abs().max().item() <= ATOL
    # the picks: equal where T does not land within rounding of a level
    assert (out_k[:, 4:] == out_r[:, 4:]).float().mean().item() >= ID_AGREE
    assert bool((out_k[:, 4:] > 0).any(dim=(0, 2)).all())  # every level picked somewhere


@pytest.mark.cuda
def test_multi_iso_kernel_rows_equal_gs2d_kernel(cuda):
    """Rows 0-3 equal K1 gs2d's bit for bit, row 4 + k K1 gs2d's pick at
    depth_iso = ISO_LEVELS[k]; the empty tiles rgb 0, T 1, depths 0."""
    bins, st = shadow_map_setup(cuda)
    out, _ = tr.rasterize_bins(bins, st)
    gs2d = dataclasses.replace(st, multi_iso=False)
    ref, _ = tr.rasterize_bins(bins, gs2d)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :4], ref[:, :4])
    for k, level in enumerate(sh.ISO_LEVELS):
        pick, _ = tr.rasterize_bins(bins, dataclasses.replace(gs2d, depth_iso=level))
        torch.cuda.synchronize()
        assert torch.equal(out[:, 4 + k], pick[:, 4]), k
    z = torch.zeros((st.tiles_x * st.tiles_y,), dtype=torch.int32, device=cuda)
    empty, ids = tr.rasterize_tiles(torch.zeros((10, 0), device=cuda),
                                    torch.zeros((0,), dtype=torch.int32, device=cuda), z, z, st)
    assert (empty[:, :3] == 0).all() and (empty[:, 3] == 1).all()
    assert (empty[:, 4:] == 0).all() and (ids == -1).all()


@pytest.mark.cuda
def test_hybrid_render_on_card_launches_iso_and_matches_cpu(cuda):
    """render_hybrid on the card: K1 gs2d twice (main pass, normal buffer)
    and K1's multi-iso form seven times (one cone, six cube faces) a frame;
    against the CPU twins at the card-against-CPU gate; a shaded pixel
    beyond 1e-4 reads another staircase level on one of the two devices."""
    cfg = gt.RenderConfig(width=96, height=64, sh_degree=0, pipeline=gt.Pipeline.HYBRID)
    frames = {}
    for dev in (cuda, torch.device("cpu")):
        prepared = shadow_scene(dev).prepare()
        cam = gt.look_at([0, -2.0, -12.0], [0, 2.0, 0], [0, 1, 0], 96, 64, device=dev)
        lights = shadow_lights(dev)
        before = launch_counts(tr.rasterize_tiles)
        out, shaded, _ = render_hybrid(prepared, cam, cfg, 1 << 16, lights=lights,
                                       shadow_res=128)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = launch_counts(tr.rasterize_tiles)
            assert after == {m: before[m] + {"gs2d": 2, "gs2d_iso": 7}.get(m, 0) for m in before}
            again = render_hybrid(prepared, cam, cfg, 1 << 16, lights=lights, shadow_res=128)[1]
            assert torch.equal(again, shaded)
        fn = sh.make_shadow_fn(prepared, lights, cfg, 128)
        world = surface_points(out.depth, cam)
        levels = torch.stack([fn(world, light) for light in lights], -1)
        frames[dev.type] = [x.detach().cpu() for x in (out.image, shaded, levels)]
    (img_k, sh_k, lv_k), (img_c, sh_c, lv_c) = frames["cuda"], frames["cpu"]
    diff = (img_k - img_c).abs()
    assert (diff > 5e-5).float().mean().item() <= 1e-3 and diff.max().item() <= 2e-3
    beyond = ((sh_k - sh_c).abs() > 1e-4).any(-1)
    other_level = (lv_k != lv_c).any(-1)
    assert int((beyond & ~other_level).sum()) <= 1e-3 * beyond.numel()
    assert len(lv_k[..., 0].unique()) >= 2  # the cone map shadows some covered pixels


@pytest.mark.cuda
def test_lit_backward_launches_k2_twice(cuda):
    cfg = gt.RenderConfig(width=96, height=64, sh_degree=1)
    s = splats_on(cuda, n=3000)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 96, 64, fov_y_rad=0.9,
                     device=cuda)
    grads = []
    for _ in range(2):
        for f in interop.SPLAT_FIELDS:
            getattr(s, f).grad = None
        before = launch_counts(tr.rasterize_tiles_bwd)
        shaded = render_3dgs_lit(s.prepare(), cam, cfg, lights=shadow_lights(cuda)[:1])[1]
        (shaded * shaded).sum().backward()
        torch.cuda.synchronize()
        after = launch_counts(tr.rasterize_tiles_bwd)
        assert after == {m: before[m] + 2 * (m == "gs2d") for m in before}
        grads.append([getattr(s, f).grad.clone() for f in interop.SPLAT_FIELDS])
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


# ---- the ray tracer (ops/raytrace.py: plain torch, no kernel of its own) ----------
#
# trace_splats and trace_mesh on the card against the same calls on the CPU,
# at the tracer's gates (tests/test_torch_raytrace.py): radiance and T within
# 1e-4 on >= 99.9 % of rays, none beyond 1.2e-2 (a contribution flipped at a
# response cutoff by another exp or rsqrt); the iso depth the same pick on
# >= 99.9 %; mesh face ids equal and t within 1e-5 relative. The estimators
# draw from one fixed CPU stream on both devices. An any-hit draw belongs to
# a place in the radial order, and two splats whose distances to the ray
# centroid lie within rounding of each other (the centroid is a sum, in
# another order on each device) may trade places and so draws: the
# estimators are compared on a scene of splats on shells 2e-3 apart, where
# the order is the same on both devices. Repeats are bit-equal.

from vk_gaussian_splatting_tpu_torch.io.obj import ObjMaterial, ObjMesh, octa_sphere  # noqa: E402
from vk_gaussian_splatting_tpu_torch.ops import raytrace as rt  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render import render_3dgrt_exact  # noqa: E402
from vk_gaussian_splatting_tpu_torch.render.pipelines import (  # noqa: E402
    render_composed_wavefront,
)

TRACE_ATOL, TRACE_AGREE, TRACE_FLIP = 1e-4, 0.999, 1.2e-2


def fixed_uniforms(stream, seed, shape, device, pass_id=0, chunk_id=0):
    """One CPU stream per (stream, seed, pass, chunk), moved to the device."""
    gen = torch.Generator().manual_seed(hash((stream, seed, pass_id, chunk_id)) % (1 << 62))
    return torch.rand(shape, generator=gen).to(device)


def trace_gate(got, want):
    per = (got.cpu() - want).abs().reshape(want.shape[0], -1).amax(dim=1)
    assert (per <= TRACE_ATOL).float().mean().item() >= TRACE_AGREE, per.max()
    assert per.max().item() <= TRACE_FLIP, per.max()


def trace_rays(device, r=2048, seed=3):
    g = torch.Generator().manual_seed(seed)
    o = torch.tensor([0.0, -0.5, -9.0]) + 0.5 * torch.randn((r, 3), generator=g)
    d = torch.tensor([0.0, 0.1, 1.0]) + 0.3 * torch.randn((r, 3), generator=g)
    return o.to(device), (d / d.norm(dim=-1, keepdim=True)).to(device)


def shell_splats(device, n=3000, seed=4):
    """Splats in the rays' cone at distances 4 + 2e-3 i from the rays'
    centroid (one splat a shell): the radial order cannot depend on how a
    device rounds the centroid."""
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-3.0, -1.5))
    centroid = trace_rays("cpu")[0].double().mean(dim=0).numpy()
    rng = np.random.default_rng(seed)
    u = np.float64([0.0, 0.1, 1.0]) + 0.3 * rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d["means"] = (centroid + (4.0 + 2e-3 * rng.permutation(n))[:, None] * u).astype(np.float32)
    return interop.splat_set_from_numpy(d, device)


@pytest.mark.cuda
@pytest.mark.parametrize("order, stochastic", [("radial", False), ("windowed", False),
                                               ("auto", False), ("radial", "pass"),
                                               ("radial", "anyhit"), ("windowed", "anyhit")])
def test_trace_splats_on_card_matches_cpu(cuda, monkeypatch, order, stochastic):
    monkeypatch.setattr(rt, "trace_uniforms", fixed_uniforms)
    cfg = gt.RenderConfig(width=64, height=32, sh_degree=1)
    cfg = cfg.replace(rt=dataclasses.replace(cfg.rt, max_passes=8))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        prepared = (shell_splats(dev) if stochastic else
                    splats_on(dev, n=3000, scale_range=(-3.0, -1.5))).prepare()
        o, d = trace_rays(dev)
        tmin = torch.full((o.shape[0],), 1e-3, device=dev)
        tmax = torch.full((o.shape[0],), float("inf"), device=dev)
        call = lambda: rt.trace_splats(prepared, o, d, tmin, tmax, cfg, chunk=256,  # noqa: E731
                                       ray_block=512, stochastic=stochastic, seed=7, order=order)
        with torch.no_grad():
            res[dev.type] = call()
            again = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for f in ("radiance", "transmittance", "depth"):
                assert torch.equal(getattr(again, f), getattr(res["cuda"], f)), f
    k, c = res["cuda"], res["cpu"]
    trace_gate(k.radiance, c.radiance)
    trace_gate(k.transmittance, c.transmittance)
    dk, dc = k.depth.cpu(), c.depth
    same = (dk - dc).abs() <= 1e-5 * dc.abs().clamp(min=1.0)
    assert same.float().mean().item() >= TRACE_AGREE
    assert float(c.transmittance.detach().min()) < 0.5
    if stochastic:
        assert bool(torch.isin(k.transmittance.cpu(), torch.tensor([0.0, 1.0])).all())


@pytest.mark.cuda
def test_trace_mesh_on_card_matches_cpu(cuda):
    sphere = octa_sphere(5, 2.0)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        pos = torch.as_tensor(sphere.positions, device=dev)
        idx = torch.as_tensor(sphere.indices, device=dev)
        g = torch.Generator().manual_seed(9)
        o = torch.nn.functional.normalize(torch.randn((3000, 3), generator=g), dim=-1) * 6.0
        d = torch.nn.functional.normalize(torch.rand((3000, 3), generator=g) * 5.0 - 2.5 - o,
                                          dim=-1)
        call = lambda: rt.trace_mesh(pos, idx, o.to(dev), d.to(dev),  # noqa: E731
                                     torch.full((3000,), 1e-3, device=dev), ray_block=512)
        res[dev.type] = call()
        if dev.type == "cuda":
            again = call()
            assert torch.equal(again.t, res["cuda"].t) and torch.equal(again.face,
                                                                       res["cuda"].face)
    k, c = res["cuda"], res["cpu"]
    assert torch.equal(k.face.cpu(), c.face) and torch.equal(k.hit.cpu(), c.hit)
    hit = c.hit
    assert 0.3 < hit.float().mean().item() < 0.95
    torch.testing.assert_close(k.t.cpu()[hit], c.t[hit], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_traced_frames_on_card_match_cpu(cuda):
    """render_3dgrt_exact, render_hybrid with ray shadows and
    render_composed_wavefront (a mirror floor) on the card against the CPU:
    images at the tracer's per-pixel gate, each repeat bit-equal."""
    w, h = 64, 48
    grt = gt.RenderConfig(width=w, height=h, sh_degree=0)
    grt = grt.replace(rt=dataclasses.replace(grt.rt, max_passes=16))
    hyb = gt.RenderConfig(width=w, height=h, sh_degree=0, pipeline=gt.Pipeline.HYBRID,
                          rt=gt.RtConfig(shadows="ray"))
    wav = gt.RenderConfig(width=w, height=h, sh_degree=1)
    mirror = ObjMesh(np.float32([[-6, -2, -6], [6, -2, -6], [6, -2, 6], [-6, -2, 6]]),
                     np.tile(np.float32([[0, 1, 0]]), (4, 1)), np.int32([[0, 1, 2], [0, 2, 3]]),
                     np.zeros(2, np.int32),
                     [ObjMaterial(diffuse=(0.05, 0.05, 0.05), specular=(0.9, 0.9, 0.9),
                                  illum=1)])
    frames = {}
    for dev in (cuda, torch.device("cpu")):
        cam = gt.look_at([0, 0.5, -9], [0, -0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)
        prepared = shadow_scene(dev, 300, 600).prepare()
        calls = (
            lambda: render_3dgrt_exact(prepared, cam, grt).image,
            lambda: render_hybrid(prepared, cam, hyb, 1 << 16, lights=shadow_lights(dev))[1],
            lambda: render_composed_wavefront(
                prepared, cam, wav, 1 << 16, mesh=mr.mesh_buffers_from_obj(mirror, device=dev),
                max_bounces=2, stride=2)[1],
        )
        frames[dev.type] = [f() for f in calls]
        if dev.type == "cuda":
            for f, first in zip(calls, frames["cuda"]):
                assert torch.equal(f(), first)
    for k, c in zip(frames["cuda"], frames["cpu"]):
        assert bool(torch.isfinite(k).all())
        trace_gate(k.reshape(-1, 3), c.reshape(-1, 3))
