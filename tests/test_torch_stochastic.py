"""Stochastic transparency on the CPU: the port against the JAX package.

``RasterStatics.stochastic`` (SPLAT and ANYHIT) accepts each pair that
passes the cutoffs as opaque where a hashed uniform falls below its alpha
(the JAX ``_alpha_closure``, rasterize_pallas.py:180-194). The stream is a
pure function of (key, pixel, lane), so the port reproduces the JAX frames
pair for pair when it keys each blend step as the TPU kernels do: pairs by
``seed + p // chunk``, the bucket path by ``seed + tile * n_chunks + m //
chunk`` with m the lane's place in the merged window, dead head lanes
included. A lane placed one off in the merge would draw another uniform.

Tolerances:
- ``hash_uniform`` against ``_hash_uniform``: bit for bit.
- frames (JAX kernels in interpret mode, the port's twins): gs2d >= 99.9 %
  of channels within 5e-5 and ids equal on >= 99.9 % of pixels; gut3d the
  flip-aware gates of tests/test_torch_gut.py (also none beyond 1.2e-2).
  An accept flips only where the two packages' alphas straddle a uniform,
  and they differ by rounding alone (measured max 6e-8, ids 100 %).
- gradients: the accepted alpha has no gradient in either package, so each
  pair's geometry rows get exactly 0 and only the colour rows get one;
  those within 1e-5 of each row's max (as tests/test_torch_rasterize_bwd.py);
  the SplatSet fields within 1e-5 of each field's max (3DGS, as
  tests/test_torch_train.py) or the gut3d gates (p99.9 1e-4, max 2e-3).
- convergence: the rows of docs/stochastic_convergence.md (JAX scene
  ``random_splats(key(0), 800)``, 128x96, SH 1) within 0.1 dB.

JAX programs built here: nine frames, one kernel VJP and four render
gradients (about 2 minutes alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import raster_bucket as jrb
from vk_gaussian_splatting_tpu.ops import rasterize_pallas as jr
from vk_gaussian_splatting_tpu.ops.binning import bin_splats as j_bin
from vk_gaussian_splatting_tpu.ops.projection import project_splats as j_project
from vk_gaussian_splatting_tpu.render.pipelines import gs_attr_rows as j_rows
from vk_gaussian_splatting_tpu.render.pipelines import raster_statics as j_statics
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgrt as j_grt
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgut as j_gut
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops import response as tresp
from vk_gaussian_splatting_tpu_torch.ops.denoise import denoise_output
from vk_gaussian_splatting_tpu_torch.render import render
from vk_gaussian_splatting_tpu_torch.render import pipelines as tp

from test_torch_rasterize import twin_inputs
from test_torch_rasterize_bwd import assert_rows_close, cotangent

torch.set_num_threads(2)

IMG_ATOL, IMG_SHARE, GUT_IMG_MAX = 5e-5, 0.999, 1.2e-2
ID_AGREE = 0.999
ROW_RTOL = 1e-5
GRAD_RTOL = 1e-5
GUT_P999, GUT_MAX = 1e-4, 2e-3
PSNR_ATOL = 0.1
W, H = 64, 48
SCENE = (3, 600, (-3.0, -1.5))   # seed, splats, log-scale range: every tile is covered
CAPS = (512, 256, 256, 128)
SPLAT, ANYHIT, PASS = "SPLAT", "ANYHIT", "PASS"


def cfgs(pipeline="MESH", method="pairs", fmt="f32", stochastic=SPLAT, **kw):
    """The same RenderConfig in both packages."""
    args = dict(dict(width=W, height=H, sh_degree=1, temporal_samples=1), **kw)
    raster = dict(method=method, pair_format=fmt, bucket_caps=CAPS)
    return (jc.RenderConfig(pipeline=jc.Pipeline[pipeline],
                            stochastic=jc.StochasticMode[stochastic], **args,
                            raster=jc.RasterConfig(**raster)),
            tc.RenderConfig(pipeline=tc.Pipeline[pipeline],
                            stochastic=tc.StochasticMode[stochastic], **args,
                            raster=tc.RasterConfig(**raster)))


@pytest.fixture(scope="module")
def scene():
    """(numpy splats, port camera, JAX camera)."""
    d = interop.random_splat_arrays(SCENE[0], SCENE[1], sh_degree=1, scale_range=SCENE[2])
    cam_t = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9,
                       device="cpu")
    return d, cam_t, jcam.make_camera(**interop.camera_to_numpy(cam_t))


def to_jax(d):
    return jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})


J_RENDER = {"MESH": j_render, "MESH_3DGUT": j_gut, "RTX": j_grt}


def assert_frames_match(oj, ot, gut):
    diff = np.abs(ot.image.numpy() - np.asarray(oj.image))
    assert np.isfinite(diff).all()
    assert (diff <= IMG_ATOL).mean() >= IMG_SHARE, (diff > IMG_ATOL).mean()
    if gut:
        assert diff.max() <= GUT_IMG_MAX, diff.max()
    tdiff = np.abs(ot.transmittance.numpy() - np.asarray(oj.transmittance))
    assert (tdiff <= IMG_ATOL).mean() >= IMG_SHARE
    same = ot.splat_id.numpy() == np.asarray(oj.splat_id)
    assert same.mean() >= ID_AGREE, same.mean()


# ---- the stream ----------------------------------------------------------------

@pytest.mark.parametrize("key", [1, 7920, 123456, 2**31 - 1])
@pytest.mark.parametrize("lanes", [128, 384])
def test_hash_uniform_is_bit_equal_to_jax(key, lanes):
    u_j = np.asarray(jr._hash_uniform(jnp.int32(key), (tresp.PIX, lanes)))
    u_t = tresp.hash_uniform(torch.tensor(key, dtype=torch.int64),
                             torch.arange(tresp.PIX)[:, None], torch.arange(lanes)[None, :])
    assert u_t.dtype == torch.float32
    np.testing.assert_array_equal(u_t.numpy().view(np.int32), u_j.view(np.int32))
    assert 0.0 <= float(u_t.min()) and float(u_t.max()) < 1.0


def test_accept_is_exactly_opaque_after_the_clamp():
    a = torch.tensor([0.0, 0.5, 0.5, 0.999, 0.999, 1e-3])
    u = torch.tensor([0.0, 0.4999, 0.5, 0.9989, 0.999, 0.0])
    np.testing.assert_array_equal(tresp.stochastic_accept(a, u).numpy(),
                                  [0.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    # the JAX closure's where, on the same alphas and uniforms
    j = np.asarray(jnp.where((jnp.asarray(u.numpy()) < jnp.asarray(a.numpy()))
                             & (jnp.asarray(a.numpy()) > 0.0), 1.0, 0.0))
    np.testing.assert_array_equal(tresp.stochastic_accept(a, u).numpy(), j)


@pytest.mark.parametrize("caps, chunk", [((640, 384, 640, 256), 384), (CAPS, 384),
                                         (CAPS, 128), ((128, 128, 128, 128), 256)])
def test_bucket_chunk_count_matches_jax(caps, chunk):
    """The key stride from one tile to the next: the chunks of the TPU
    kernel's merged buffer (raster_bucket.py:484-486, :959-961)."""
    assert rb.n_chunks(caps, chunk) == len(jrb._chunk_bounds(jrb._sort_width(caps), chunk))


# ---- frames against the JAX package ----------------------------------------------

# name: (pipeline, method, pair format, temporal samples)
FRAMES = {
    "3dgs_pairs": ("MESH", "pairs", "f32", 1),
    "3dgs_bucket": ("MESH", "bucket", "f32", 1),
    "3dgs_temporal3": ("MESH", "pairs", "f32", 3),
    "3dgs_packed": ("MESH", "pairs", "packed", 1),
    "3dgut_pairs": ("MESH_3DGUT", "pairs", "f32", 1),
    "3dgut_bucket_temporal2": ("MESH_3DGUT", "bucket", "f32", 2),
    "3dgrt_pairs": ("RTX", "pairs", "f32", 1),
    "3dgut_bucket_packed": ("MESH_3DGUT", "bucket", "packed", 1),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_stochastic_frame_matches_jax(scene, name):
    d, cam_t, cam_j = scene
    pipeline, method, fmt, samples = FRAMES[name]
    cj, ct = cfgs(pipeline, method, fmt, temporal_samples=samples)
    oj = J_RENDER[pipeline](to_jax(d).prepare(), cam_j, cj)
    ot = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t, ct)
    assert_frames_match(oj, ot, gut=pipeline != "MESH")
    img = ot.image.numpy()
    if samples == 1:
        # one sample: each pixel is one splat's colour, T exactly 0 or 1
        assert set(np.unique(ot.transmittance.numpy())) <= {0.0, 1.0}
        assert (ot.transmittance == 0).any() and (ot.transmittance == 1).any()
    else:
        levels = np.unique(ot.transmittance.numpy())
        assert len(levels) > 2 and set(levels * samples) <= set(range(samples + 1))
    assert np.isfinite(img).all()


def test_bucket_stream_is_keyed_by_merged_place(scene):
    """The bucket frame's agreement with JAX shows that the port's merged
    lists put each live lane where the JAX merge does: the same twin keyed
    one seed off, or keyed by the lane's live rank (the dead head lanes not
    counted), disagrees with the JAX frame on many pixels."""
    d, cam_t, cam_j = scene
    cj, ct = cfgs(method="bucket")
    img_j = np.asarray(j_render(to_jax(d).prepare(), cam_j, cj).image)
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    st = tp.bucket_statics(ct)
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    with torch.no_grad():
        proj = tp.project_splats(prep, cam_t, ct)
        bins = tp.bin_for_cfg(proj, *tp.gs_attr_rows(proj), ct, 0)
        lists = rb._tile_lists(bins.attrs, bins.bucket_starts, st, CAPS, tiles)
        n, lanes = tiles.numel(), lists.cols.numel() // tiles.numel()
        first = torch.arange(n) * lanes
        head = lists.tile_start.long() - first
        assert (head > 0).any()  # the scene has dead head lanes to count
        at = torch.arange(lanes)[None, :] + head[:, None]
        ranked = torch.where(at < lanes, lists.cols.view(n, lanes).gather(
            1, at.clamp(max=lanes - 1)), -1).flatten().clamp(min=0)

        def image(out):
            return tr.assemble_image(*out, st.tiles_x, st.tiles_y, W, H)[0].numpy()

        right = image(rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st,
                                               CAPS, seed=1))
        off_seed = image(rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts,
                                                  st, CAPS, seed=2))
        by_rank = image(tr.rasterize_tiles_ref(
            bins.attrs[:, ranked], bins.ids[ranked], first.to(torch.int32),
            lists.tile_count, st, tiles, seed=1, key_offset=lists.key_offset))
    assert (np.abs(right - img_j) <= IMG_ATOL).mean() >= IMG_SHARE
    for wrong in (off_seed, by_rank):
        assert (np.abs(wrong - img_j) > IMG_ATOL).mean() > 0.05


def test_anyhit_equals_splat_and_pass_is_deterministic(scene):
    d, cam_t, _ = scene
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    out = {m: render(prep, cam_t, cfgs(stochastic=m)[1])
           for m in (SPLAT, ANYHIT, PASS, "NONE")}
    for f in ("image", "transmittance", "depth", "splat_id"):
        assert torch.equal(getattr(out[ANYHIT], f), getattr(out[SPLAT], f)), f
        assert torch.equal(getattr(out[PASS], f), getattr(out["NONE"], f)), f
    assert not torch.equal(out[SPLAT].image, out["NONE"].image)


def test_seeds_per_sample_and_repeat(scene):
    """Sample s is keyed by s * 7919 + 1: a 2-sample frame is the mean of the
    blends of seeds 1 and 7920; the frame repeats bit for bit."""
    d, cam_t, _ = scene
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    _, ct = cfgs(temporal_samples=2)
    a, b = render(prep, cam_t, ct), render(prep, cam_t, ct)
    assert torch.equal(a.image, b.image) and torch.equal(a.splat_id, b.splat_id)
    assert [tp.sample_seed(s) for s in range(3)] == [1, 7920, 15839]
    st = tp.raster_statics(ct)
    with torch.no_grad():
        proj = tp.project_splats(prep, cam_t, ct)
        bins = tp.bin_for_cfg(proj, *tp.gs_attr_rows(proj), ct, 0)
        imgs = [tr.assemble_image(*tr.rasterize_bins(bins, st, seed=s), st.tiles_x, st.tiles_y,
                                  W, H)[0] for s in (1, 7920)]
    assert torch.equal(a.image, (imgs[0] + imgs[1]) / 2)


# ---- gradients -------------------------------------------------------------------

def jax_stochastic_vjp(d, cam_j, seed):
    """(JAX bins, JAX d_attrs, cotangent rows 0-3) of the stochastic pair
    kernels in interpret mode, keyed by ``seed``."""
    cfg = jc.RenderConfig(width=W, height=H, sh_degree=1, stochastic=jc.StochasticMode.SPLAT)
    st = j_statics(cfg, interpret=True)
    assert st.stochastic
    n_t = st.tiles_x * st.tiles_y
    g4 = cotangent((n_t, 5, jr.PIX), 11).numpy()[:, :4]
    g = np.zeros((n_t, jr.OUT_COLS, jr.PIX), np.float32)
    g[:, :4] = g4

    def fn(s, c, gj):
        proj = j_project(s.prepare(), c, cfg)
        bins = j_bin(proj, j_rows(proj), tile_size=16, tiles_x=st.tiles_x,
                     tiles_y=st.tiles_y, wide_id=True)
        seed_a = jnp.full((1,), seed, jnp.int32)
        _, vjp = jax.vjp(lambda a: jr.rasterize_tiles(a, bins.sched_word, bins.sched_block,
                                                      None, seed_a, st), bins.attrs)
        return bins, vjp(gj)[0]

    bins, d_attrs = jax.jit(fn)(to_jax(d), cam_j, jnp.asarray(g))
    return bins, np.asarray(d_attrs), g4


def test_stochastic_pair_backward_matches_jax_kernel(scene):
    """The twin backward against ``jax.vjp`` of the stochastic K2 on the JAX
    bins: colour rows to 1e-5 of their max, every other row exactly 0 in
    both; and against torch autograd of the twin forward."""
    d, _, cam_j = scene
    seed = 7920
    bins, d_j, g4 = jax_stochastic_vjp(d, cam_j, seed)
    attrs, ids, start, count = twin_inputs(bins)
    _, ct = cfgs()
    st = tp.raster_statics(ct)
    leaf = attrs.clone().requires_grad_()
    out, _ = tr.rasterize_tiles_ref(leaf, ids, start, count, st, seed=seed)
    g = torch.zeros(out.shape)
    g[:, :4] = torch.from_numpy(g4)
    (out * g).sum().backward()
    d_t = tr.rasterize_tiles_bwd_ref(attrs, start, count, tr.bwd_context(out.detach(), g), st,
                                     seed=seed)
    colour = range(tresp.ATTR_R, tresp.ATTR_B + 1)
    assert_rows_close(d_t, d_j, ROW_RTOL, colour)
    assert_rows_close(d_t, leaf.grad, ROW_RTOL, colour)
    for r in set(range(tresp.GS_ROWS)) - set(colour):
        assert (d_t[r] == 0).all(), r
        assert (d_j[r] == 0).all(), r
        assert (leaf.grad[r] == 0).all(), r
    assert bool(torch.isfinite(d_t).all())


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_stochastic_bucket_and_pair_backward_zero_geometry_rows(scene, method):
    """Port twins alone: the backward of either method gives only colour
    rows, finite, and equals autograd of the twin forward there."""
    d, cam_t, _ = scene
    _, ct = cfgs(method=method)
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    with torch.no_grad():
        proj = tp.project_splats(prep, cam_t, ct)
        bins = tp.bin_for_cfg(proj, *tp.gs_attr_rows(proj), ct, 0)
    st = tp.raster_statics(ct)
    leaf = bins.attrs.clone().requires_grad_()
    if method == "pairs":
        out, _ = tr.rasterize_tiles_ref(leaf, bins.pair_id, bins.tile_start, bins.tile_count,
                                        st, seed=5)
    else:
        st = dataclasses.replace(st, chunk=ct.raster.bucket_chunk)
        out, _ = rb.rasterize_buckets_ref(leaf, bins.ids, bins.bucket_starts, st, CAPS, seed=5)
    g = cotangent(out.shape, 3)
    (out * g).sum().backward()
    ctx = tr.bwd_context(out.detach(), g)
    if method == "pairs":
        d_t = tr.rasterize_tiles_bwd(bins.attrs, bins.tile_start, bins.tile_count, ctx, st,
                                     seed=5)
    else:
        d_t = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, CAPS, seed=5)
    colour = range(tresp.ATTR_R, tresp.ATTR_B + 1)
    assert_rows_close(d_t, leaf.grad, ROW_RTOL, colour)
    for r in set(range(tresp.GS_ROWS)) - set(colour):
        assert (d_t[r] == 0).all() and (leaf.grad[r] == 0).all(), r
    assert bool(torch.isfinite(d_t).all())


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_stochastic_work_counts_draws(scene, method):
    """The work counts that price the stochastic kernels' hash: a draw is a
    kept evaluation whose alpha passes the cutoffs, so every accepted pair
    (a stochastic hit) is one and a deterministic sweep draws where it
    hits; the culls keep every pair that draws."""
    d, cam_t, _ = scene
    _, ct = cfgs(method=method)
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    with torch.no_grad():
        proj = tp.project_splats(prep, cam_t, ct)
        bins = tp.bin_for_cfg(proj, *tp.gs_attr_rows(proj), ct, 0)
    st = tp.raster_statics(ct)
    det = dataclasses.replace(st, stochastic=False)
    if method == "bucket":
        st, det = (dataclasses.replace(s, chunk=ct.raster.bucket_chunk) for s in (st, det))
        work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, CAPS, seed=1)
        assert 0 < work.hits < work.draws <= work.kept_evals
        plain = rb.bucket_work(bins.attrs, bins.bucket_starts, det, CAPS)
        assert plain.draws == plain.hits
        return
    args = (bins.attrs, bins.tile_start, bins.tile_count)
    _, hits, _, _, kept_evals, draws = tr.blend_work(
        *args, st, keep=tr.pair_may_hit(*args, st), seed=1)
    assert 0 < hits < draws <= kept_evals
    every = torch.ones(bins.attrs.shape[1], dtype=torch.bool)
    assert tr.blend_work(*args, st, keep=every, seed=1)[5] == draws
    _, d_hits, _, _, _, d_draws = tr.blend_work(*args, det, keep=every)
    assert d_draws == d_hits


# pipeline, method: the render-level gradient cases
GRADS = {
    "3dgs_pairs": ("MESH", "pairs"),
    "3dgs_bucket": ("MESH", "bucket"),
    "3dgut_pairs": ("MESH_3DGUT", "pairs"),
    "3dgut_bucket": ("MESH_3DGUT", "bucket"),
}


@pytest.mark.parametrize("name", list(GRADS))
def test_stochastic_gradients_match_jax(scene, name):
    """Weighted image plus weighted transmittance of a 2-sample stochastic
    frame through both packages, the six SplatSet fields. Only the colour
    path carries a gradient: the opacities, scales and quaternions get
    exactly 0 in both packages, the means (through the SH view direction)
    and SH coefficients theirs."""
    d, cam_t, cam_j = scene
    pipeline, method = GRADS[name]
    cj, ct = cfgs(pipeline, method, temporal_samples=2)
    rng = np.random.default_rng(17)
    wimg = rng.normal(size=(H, W, 3)).astype(np.float32)
    wt = rng.normal(size=(H, W)).astype(np.float32)

    def loss_j(s):
        o = J_RENDER[pipeline](s.prepare(), cam_j, cj)
        return jnp.sum(o.image * wimg) + jnp.sum(o.transmittance * wt)

    g_j = jax.jit(jax.grad(loss_j))(to_jax(d))
    s = interop.splat_set_from_numpy(d, "cpu")
    for f in interop.SPLAT_FIELDS:
        getattr(s, f).requires_grad_()
    o = render(s.prepare(), cam_t, ct)
    (torch.sum(o.image * torch.from_numpy(wimg))
     + torch.sum(o.transmittance * torch.from_numpy(wt))).backward()
    gut = pipeline != "MESH"
    for f in interop.SPLAT_FIELDS:
        a = getattr(s, f).grad.numpy().astype(np.float64).ravel()
        b = np.asarray(getattr(g_j, f), np.float64).ravel()
        if f in ("opacities", "scales", "quats"):
            assert (a == 0).all() and (b == 0).all(), f
            continue
        scale = np.abs(b).max()
        assert scale > 0, f
        rel = np.abs(a - b) / scale
        if gut:
            assert np.quantile(rel, 0.999) <= GUT_P999, (f, np.quantile(rel, 0.999))
            assert rel.max() <= GUT_MAX, (f, rel.max())
        else:
            assert rel.max() <= GRAD_RTOL, (f, rel.max())


# ---- convergence (docs/stochastic_convergence.md) --------------------------------

# (estimator, SPP) -> PSNR in dB against the deterministic frame, from the doc
CONVERGENCE = {("splat", 1): 13.12, ("splat+atrous", 1): 15.14,
               ("splat", 5): 20.12, ("splat+atrous", 5): 24.29,
               ("splat", 16): 25.12, ("splat+atrous", 16): 27.18}


def _psnr(ref, img):
    return 10.0 * np.log10(1.0 / max(float(np.mean((ref - img) ** 2)), 1e-12))


def test_convergence_reproduces_the_doc():
    """scripts/stochastic_convergence.py's scene and camera, built by the
    JAX package and carried across: the port's splat and splat+atrous PSNRs
    at 1, 5 and 16 SPP within 0.1 dB of the doc's rows."""
    from vk_gaussian_splatting_tpu.scene.cameras import look_at as j_look_at
    from vk_gaussian_splatting_tpu.scene.splat_set import random_splats

    sj = random_splats(jax.random.key(0), 800, sh_degree=1, scale_range=(-2.8, -1.0))
    splats = interop.splat_set_from_numpy(
        {k: np.array(getattr(sj, k)) for k in interop.SPLAT_FIELDS}, "cpu")
    cj = j_look_at([0, 0, -8], [0, 0, 0], [0, 1, 0], 128, 96, fov_y_rad=0.9)
    cam = interop.camera_from_numpy({k: np.array(getattr(cj, k))
                                     for k in interop.CAMERA_FIELDS}, "cpu")
    cfg = tc.RenderConfig(width=128, height=96, sh_degree=1)
    prep = splats.prepare()
    with torch.no_grad():
        ref = np.clip(render(prep, cam, cfg, max_pairs=1 << 17).image.numpy(), 0, 1)
        got = {}
        for spp in (1, 5, 16):
            scfg = cfg.replace(stochastic=tc.StochasticMode.SPLAT, temporal_samples=spp)
            out = render(prep, cam, scfg, max_pairs=1 << 17)
            got[("splat", spp)] = _psnr(ref, np.clip(out.image.numpy(), 0, 1))
            den = render(prep, cam, scfg.replace(denoise="atrous"), max_pairs=1 << 17).image
            assert torch.equal(den, denoise_output(out))
            got[("splat+atrous", spp)] = _psnr(ref, np.clip(den.numpy(), 0, 1))
    for k, want in CONVERGENCE.items():
        assert abs(got[k] - want) <= PSNR_ATOL, (k, got[k], want)
