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


def gut_setup(device, method="pairs", degree=2, fisheye=False, w=128, h=96, seed=0, n=1500):
    """Bins, statics, caps and rays of a 3DGUT frame on ``device``."""
    raster = gt.RasterConfig(method=method, bucket_caps=(512, 256, 512, 256))
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=1, pipeline=gt.Pipeline.MESH_3DGUT,
                          camera_type=gt.CameraType.FISHEYE if fisheye else gt.CameraType.PINHOLE,
                          rt=gt.RtConfig(kernel_degree=degree), raster=raster)
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-3.5, -1.5))
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                     device=device)
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


def assert_gut_bwd_matches(d_k, d_r):
    for r in range(14):
        k, ref = d_k[r], d_r[r]
        scale = ref.abs().max().item()
        assert scale > 0, r
        assert (k - ref).abs().max().item() <= GUT_BWD_MAX * scale, r
        limit = 1e-2 * (ref.abs() + ref.abs()[ref != 0].median())
        assert ((k - ref).abs() <= limit).float().mean().item() >= 0.999, r
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


# ---- the probes P1-P3: bitonic sort (csrc/bench_roll.cu), sort stages
# (csrc/bench_sort_stage.cu), pipelined bulk copies (csrc/bench_radix_ab.cu)

from vk_gaussian_splatting_tpu_torch.probes import bench_radix_ab as pa  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_roll as pr  # noqa: E402
from vk_gaussian_splatting_tpu_torch.probes import bench_sort_stage as ps  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("t, r, c, reps", [(3, 4, 128, 3), (1, 16, 2048, 2), (5, 3, 2, 1),
                                           (2, 5, 4096, 1), (0, 4, 64, 1)])
def test_probe_bitonic_sort_matches_twin(cuda, t, r, c, reps):
    x = pr.tiles_of(t, r, c, cuda)
    before = pr.bitonic_sort.launches
    out = pr.bitonic_sort(x, reps)
    torch.cuda.synchronize()
    assert pr.bitonic_sort.launches == before + (t > 0)
    assert torch.equal(out, pr.bitonic_sort_ref(x, reps))
    if t:
        assert torch.equal(out[:, 0], torch.sort(x[:, 0], dim=-1).values)


@pytest.mark.cuda
def test_probe_bitonic_sort_with_ties_and_limits(cuda):
    x = torch.floor(pr.tiles_of(4, 6, 256, cuda) * 5)   # five key values: many ties
    assert torch.equal(pr.bitonic_sort(x, 2), pr.bitonic_sort_ref(x, 2))
    with pytest.raises(ValueError, match="shared memory"):
        pr.bitonic_sort(pr.tiles_of(1, 32, 4096, cuda))
    with pytest.raises(ValueError, match="power of two"):
        pr.bitonic_sort(pr.tiles_of(1, 4, 96, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ps.VARIANTS)
@pytest.mark.parametrize("rows, n_stages, tpt", [(4, 55, 2), (16, 20, 2), (8, 70, 5),
                                                 (1, 55, 3), (16, 55, 2)])
def test_probe_sort_stages_match_twin(cuda, variant, rows, n_stages, tpt):
    x, m, sched = ps.inputs(variant, rows, n_stages, tpt, cuda)
    before = ps.sort_stages.launches[variant]
    out = ps.sort_stages(x, m, variant, sched, rows - 1, blocks=7)
    torch.cuda.synchronize()
    assert ps.sort_stages.launches[variant] == before + 1
    assert torch.equal(out, ps.sort_stages_ref(x, m, variant, sched, rows - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ps.VARIANTS)
def test_probe_sort_stages_ties_and_limits(cuda, variant):
    x, m, sched = ps.inputs(variant, 4, 55, 2, cuda)
    x = torch.floor(x * 2)
    assert torch.equal(ps.sort_stages(x, m, variant, sched, 3, blocks=3),
                       ps.sort_stages_ref(x, m, variant, sched, 3))
    if variant == "sub8":
        with pytest.raises(ValueError, match="registers"):
            ps.sort_stages(*ps.inputs(variant, 3, 5, 1, cuda)[:2], variant, sched[:5], 2)
    else:
        big, bm, bs = ps.inputs(variant, 16, 5, 4, cuda)   # 256 KB of tiles
        with pytest.raises(ValueError, match="shared memory"):
            ps.sort_stages(big, bm, variant, bs, 15)
        y = ps.inputs(variant, 5, 55, 3, cuda)[0]
        assert torch.equal(ps.sort_stages(y, m, variant, sched, 0),
                           ps.sort_stages_ref(y, m, variant, sched, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("w", pa.WIDTHS)
@pytest.mark.parametrize("n_steps, n_copies, steps_per_block", [(2, 9, None), (3, 20, 1),
                                                                (1, 5, 1), (4, 64, 3)])
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
