"""The CUDA tile blenders (pair blender K1, K2; bucket rasterizer K3, K4;
each for the gs2d and the gut3d response model) and the probe kernels P1-P3
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


def gut_fwd(bins, st, caps, pix, twin=False):
    if isinstance(bins, rb.BucketBins):
        if twin:
            return rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, caps,
                                            pix_ctx=pix)
        return rb.rasterize_buckets(bins, st, caps, pix)
    if twin:
        return tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                      bins.tile_count, st, pix_ctx=pix)
    return tr.rasterize_bins(bins, st, pix)


def gut_bwd(bins, st, caps, ctx, pix, twin=False):
    if isinstance(bins, rb.BucketBins):
        fn = rb.rasterize_buckets_bwd_ref if twin else rb.rasterize_buckets_bwd
        return fn(bins.attrs, bins.bucket_starts, ctx, st, caps, pix_ctx=pix)
    fn = tr.rasterize_tiles_bwd_ref if twin else tr.rasterize_tiles_bwd
    return fn(bins.attrs, bins.tile_start, bins.tile_count, ctx, st, pix_ctx=pix)


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
    _, _, tested, kept_plain, _ = tr.blend_work(*args, pix_ctx=pix, keep=may)
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
    _, _, tested, kept_plain, _ = tr.blend_work(*args, pix_ctx=pix, keep=may)
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
