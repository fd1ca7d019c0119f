"""The bucket path (``RasterConfig.method="bucket"``) of the PyTorch port on
the CPU, where its twins blend: the bucket-grid integers, the frame and its
gradients against the JAX package (interpret-mode kernels), the port's
bucket path against its own pair path, the twin backward against autograd,
and a training step.

Tolerances, each with its reason:
- bucket-grid integers: exactly; both packages get one ProjectedSplats.
  The scenes are 128 px wide: narrow enough that the port's one repair of
  ``assign_buckets`` (a mid splat at the mid grid's edge keeps no coarse
  slot, ops/bucket_grid.py) changes nothing; a wider case pins the repair.
- frame against JAX: image and transmittance 5e-5 max abs, picked depth
  1e-5 where both picked the same splat, ids on >= 99.9 % of pixels,
  num_pairs and overflow exactly (as tests/test_torch_render.py). The two
  merges order exactly equal depths differently; these random scenes have
  none within a tile's window.
- gradients of the six SplatSet fields against ``jax.grad``: 1e-5 of each
  field's max (as tests/test_torch_train.py).
- the port's bucket path against its pair path: the gates of
  tests/test_bucket.py, which hold the JAX package's two paths to each
  other. The paths freeze a pixel at different lanes (bucket_chunk 384
  against chunk 128) and truncate differently.
- twin backward against autograd of the twin forward: 1e-5 of each row's
  max (as tests/test_torch_rasterize_bwd.py).

JAX programs built here: seven bucket frames and two bucket gradients.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import bucket_grid as jbg
from vk_gaussian_splatting_tpu.ops.projection import ProjectedSplats as JProjected
from vk_gaussian_splatting_tpu.render.pipelines import gs_attr_rows as j_rows
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch import train as tt
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.ops import bucket_grid as tbg
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats, project_splats
from vk_gaussian_splatting_tpu_torch.io import load_ply
from vk_gaussian_splatting_tpu_torch.render import render
from vk_gaussian_splatting_tpu_torch.render.pipelines import bucket_statics, gs_attr_rows

torch.set_num_threads(2)

IMG_ATOL = 5e-5
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999
GRAD_RTOL = 1e-5
W, H = 128, 96
GOLDEN = os.path.join(os.path.dirname(__file__), "..", "assets", "golden")

# name: (seed, n, scale_range) — fine: small splats only; mixed: every class,
# so all six spans hold candidates; big: mid, coarse and global splats
SCENES = {"fine": (0, 2500, (-3.5, -1.5)), "mixed": (5, 300, (-5.0, 1.5)),
          "big": (6, 150, (-1.5, 1.5))}


def scene_arrays(name):
    seed, n, scale_range = SCENES[name]
    return interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)


def cam_pair(w=W, h=H, eye=(0.2, -0.3, -9.0)):
    cam_t = gt.look_at(list(eye), [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device="cpu")
    return cam_t, jcam.make_camera(**interop.camera_to_numpy(cam_t))


def bucket_raster(caps, pkg):
    return pkg.RasterConfig(method="bucket", bucket_caps=tuple(caps))


@pytest.fixture(scope="module", params=list(SCENES))
def projected(request):
    """One ProjectedSplats for both packages (the port's projection, as
    numpy), so bucket integers can be compared exactly."""
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=1)
    cam_t, _ = cam_pair()
    p = project_splats(interop.splat_set_from_numpy(scene_arrays(request.param),
                                                    "cpu").prepare(), cam_t, cfg)
    arrays = {f.name: getattr(p, f.name).numpy() for f in dataclasses.fields(p)}
    spec_t = tbg.BucketGridSpec.build(W // 16, H // 16)
    spec_j = jbg.BucketGridSpec.build(W // 16, H // 16)
    return (p, JProjected(**{k: jnp.asarray(v) for k, v in arrays.items()}), spec_t, spec_j,
            request.param)


def test_bucket_grid_spec_matches_jax():
    for tx, ty in ((8, 6), (120, 68), (1, 1), (5, 13)):
        assert (dataclasses.asdict(tbg.BucketGridSpec.build(tx, ty))
                == dataclasses.asdict(jbg.BucketGridSpec.build(tx, ty)))


@pytest.mark.parametrize("tiles", [(8, 6), (120, 68), (5, 13)])
def test_window_span_table_matches_jax(tiles):
    spec_t, spec_j = tbg.BucketGridSpec.build(*tiles), jbg.BucketGridSpec.build(*tiles)
    np.testing.assert_array_equal(tbg.window_span_table(spec_t).numpy(),
                                  np.asarray(jbg.window_span_table(spec_j)))


def test_assign_buckets_matches_jax(projected):
    p_t, p_j, spec_t, spec_j, name = projected
    slots = tbg.assign_buckets(p_t, spec_t).numpy()
    np.testing.assert_array_equal(slots, np.asarray(jbg.assign_buckets(p_j, spec_j)))
    live = slots[slots < spec_t.num_buckets - 1]
    classes = np.searchsorted(spec_t.offsets, live, side="right") - 1
    want = {"fine": {0}, "mixed": {0, 1, 2, 3}, "big": {1, 2, 3}}[name]
    assert want <= set(classes.tolist()), set(classes.tolist())


def test_bucket_starts_and_caps_match_jax(projected):
    """bucket_starts, num_valid, span_lengths, required_window_caps,
    measure_required_caps, fit_caps and window_overflow, integer for
    integer."""
    p_t, p_j, spec_t, spec_j, _ = projected
    rows, ids = gs_attr_rows(p_t)
    caps = (256, 128, 128, 128)
    b_t = tbg.bucket_splats(p_t, rows, ids, tiles_x=spec_t.tiles_x, tiles_y=spec_t.tiles_y,
                            caps=caps)
    b_j = jbg.bucket_splats(p_j, j_rows(p_j), tiles_x=spec_j.tiles_x, tiles_y=spec_j.tiles_y,
                            caps=caps)
    np.testing.assert_array_equal(b_t.bucket_starts.numpy(), np.asarray(b_j.bucket_starts))
    assert int(b_t.num_valid) == int(b_j.num_valid) > 0
    np.testing.assert_array_equal(tbg.span_lengths(b_t.bucket_starts, spec_t).numpy(),
                                  np.asarray(jbg.span_lengths(b_j.bucket_starts, spec_j)))
    req_t = tbg.required_window_caps(b_t.bucket_starts, spec_t).numpy()
    np.testing.assert_array_equal(req_t, np.asarray(jbg.required_window_caps(
        b_j.bucket_starts, spec_j)))
    np.testing.assert_array_equal(tbg.measure_required_caps(p_t, spec_t).numpy(), req_t)
    np.testing.assert_array_equal(np.asarray(jbg.measure_required_caps(p_j, spec_j)), req_t)
    assert tbg.fit_caps(req_t) == jbg.fit_caps(req_t)
    for c in (caps, tbg.fit_caps(req_t), tuple(int(x) for x in req_t)):
        assert (bool(tbg.window_overflow(b_t.bucket_starts, spec_t, c))
                == bool(jbg.window_overflow(b_j.bucket_starts, spec_j, c)))
    # the live slots' depth rows: each bucket in depth order (sentinel slots,
    # all at +inf, come after them in any order)
    live = int(b_t.num_valid)
    np.testing.assert_array_equal(b_t.attrs.detach().numpy()[9, :live],
                                  np.asarray(b_j.attrs)[:, 9, :].reshape(-1)[:live])


def test_mid_splat_at_the_grid_edge_keeps_no_coarse_slot():
    """The repair of assign_buckets: at 320 px the coarse grid has three
    cells, so a mid splat in the mid grid's last cell keeps, in the JAX
    package, the coarse pair bucket it got first as its slot 1. The port
    leaves that slot unused; every other slot agrees."""
    spec_t, spec_j = tbg.BucketGridSpec.build(20, 6), jbg.BucketGridSpec.build(20, 6)
    arrays = dict(xy=np.array([[300.0, 40.0], [150.0, 40.0], [10.0, 50.0]], np.float32),
                  conic=np.full((3, 3), 0.01, np.float32), depth=np.full(3, 5.0, np.float32),
                  radius=np.array([[20.0, 20.0], [20.0, 20.0], [90.0, 90.0]], np.float32),
                  color=np.ones((3, 3), np.float32), alpha=np.ones(3, np.float32),
                  valid=np.ones(3, bool))
    slots_t = tbg.assign_buckets(ProjectedSplats(**{k: torch.from_numpy(v)
                                                    for k, v in arrays.items()}), spec_t).numpy()
    slots_j = np.array(jbg.assign_buckets(JProjected(**{k: jnp.asarray(v)
                                                          for k, v in arrays.items()}), spec_j))
    sentinel, coarse = spec_t.num_buckets - 1, spec_t.offsets[2]
    assert coarse <= slots_j[1, 0] < spec_t.offsets[3]      # the mid splat, twice in JAX
    assert slots_t[1, 0] == sentinel
    slots_j[1, 0] = sentinel
    np.testing.assert_array_equal(slots_t, slots_j)


@pytest.mark.parametrize("required", [[516, 240, 434, 148], [0, 0, 0, 0], [1, 129, 4000, 77]])
def test_fit_caps_matches_jax(required):
    assert tbg.fit_caps(required) == jbg.fit_caps(required)
    assert tbg.fit_caps(required, margin=1.0) == jbg.fit_caps(required, margin=1.0)


# name: (scene, n override, caps, render kw, overflow)
FRAMES = {
    "default_caps_fine": ("fine", None, (512, 256, 512, 256), {}, False),
    "mixed_all_spans": ("mixed", None, (384, 256, 384, 128), {}, False),
    "big_splats": ("big", None, (256, 256, 256, 256), {}, False),
    "odd_size_background": ("fine", 1500, (512, 256, 512, 256),
                            dict(width=120, height=90, background=(0.1, 0.2, 0.3)), False),
    "empty_scene": ("behind", None, (512, 256, 512, 256), {}, False),
    "overflow_at_128": ("dense", None, (128, 128, 128, 128), {}, True),
    "no_overflow_at_512": ("dense", None, (512, 128, 128, 128), {}, False),
}


def frame_arrays(scene, n):
    if scene == "dense":  # tests/test_bucket.py:142-149's scene: fine spans ~200
        return interop.random_splat_arrays(2, 4000, sh_degree=1, scale_range=(-5.5, -4.0))
    if scene == "behind":  # every splat behind the camera
        d = interop.random_splat_arrays(3, 500, sh_degree=1, scale_range=(-3.5, -1.5))
        d["means"][:, 2] = -20.0 - np.abs(d["means"][:, 2])
        return d
    seed, n0, scale_range = SCENES[scene]
    return interop.random_splat_arrays(seed, n or n0, sh_degree=1, scale_range=scale_range)


@pytest.mark.parametrize("name", list(FRAMES))
def test_bucket_frame_matches_jax(name):
    scene, n, caps, kw, overflow = FRAMES[name]
    base = {**dict(width=W, height=H, sh_degree=1), **kw}
    d = frame_arrays(scene, n)
    cam_t, cam_j = cam_pair(base["width"], base["height"])
    cj = jc.RenderConfig(**base, raster=bucket_raster(caps, jc))
    ct = tc.RenderConfig(**base, raster=bucket_raster(caps, tc))
    oj = j_render(jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare(),
                  cam_j, cj)
    ot = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t, ct)
    assert bool(oj.overflow) == bool(ot.overflow) == overflow
    assert int(oj.num_pairs) == int(ot.num_pairs)
    img_j, img_t = np.asarray(oj.image), ot.image.numpy()
    assert img_t.shape == img_j.shape == (base["height"], base["width"], 3)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(ot.transmittance.numpy(), np.asarray(oj.transmittance),
                               rtol=0, atol=IMG_ATOL)
    id_j, id_t = np.asarray(oj.splat_id), ot.splat_id.numpy()
    same = id_j == id_t
    assert same.mean() >= ID_AGREE, same.mean()
    both = same & (id_j >= 0)
    np.testing.assert_allclose(ot.depth.numpy()[both], np.asarray(oj.depth)[both],
                               rtol=0, atol=DEPTH_ATOL)
    if name == "empty_scene":
        assert int(ot.num_pairs) == 0
        assert (ot.transmittance == 1).all() and (ot.splat_id == -1).all()
    elif name == "odd_size_background":
        uncovered = ot.transmittance.numpy() == 1
        assert uncovered.any()
        np.testing.assert_array_equal(img_t[uncovered], np.broadcast_to(
            [0.1, 0.2, 0.3], img_t[uncovered].shape).astype(np.float32))
    else:
        assert float(ot.transmittance.min()) < 0.5


def to_jax(d):
    return jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("caps", [(512, 128, 128, 128), (384, 128, 128, 128)])
def test_bucket_gradients_match_jax(caps):
    """Weighted image plus weighted transmittance through both bucket paths."""
    d = interop.random_splat_arrays(0, 500, sh_degree=1, scale_range=(-4.0, -1.5))
    w, h = 64, 48
    rng = np.random.default_rng(7)
    wimg = rng.normal(size=(h, w, 3)).astype(np.float32)
    wt = rng.normal(size=(h, w)).astype(np.float32)
    cam_t, cam_j = cam_pair(w, h)
    cj = jc.RenderConfig(width=w, height=h, sh_degree=1, raster=bucket_raster(caps, jc))
    ct = tc.RenderConfig(width=w, height=h, sh_degree=1, raster=bucket_raster(caps, tc))

    def loss_j(s):
        o = j_render(s.prepare(), cam_j, cj)
        return jnp.sum(o.image * wimg) + jnp.sum(o.transmittance * wt)

    g_j = jax.jit(jax.grad(loss_j))(to_jax(d))
    s = interop.splat_set_from_numpy(d, "cpu")
    for f in interop.SPLAT_FIELDS:
        getattr(s, f).requires_grad_()
    o = render(s.prepare(), cam_t, ct)
    assert not bool(o.overflow)
    (torch.sum(o.image * torch.from_numpy(wimg))
     + torch.sum(o.transmittance * torch.from_numpy(wt))).backward()
    for f in interop.SPLAT_FIELDS:
        a = getattr(s, f).grad.numpy().astype(np.float64)
        b = np.asarray(getattr(g_j, f), np.float64)
        assert np.abs(b).max() > 0, f
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(b).max(), f


# ---- the port's bucket path against its own pair path (no JAX) -----------

def pair_and_bucket(seed, n, scale_range, caps, w=W, h=H, eye=(0.0, 0.0, -6.0), grads=False,
                    x_spread=1.0):
    """tests/test_bucket.py's _scene: extent 2.5 (times x_spread along x),
    camera at z = -6."""
    d = interop.random_splat_arrays(seed, n, sh_degree=1, extent=2.5, scale_range=scale_range)
    d["means"][:, 0] *= x_spread
    cam = gt.look_at(list(eye), [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device="cpu")
    outs = []
    for raster in (tc.RasterConfig(expansion="exact"), bucket_raster(caps, tc)):
        s = interop.splat_set_from_numpy(d, "cpu")
        if grads:
            for f in interop.SPLAT_FIELDS:
                getattr(s, f).requires_grad_()
        o = render(s.prepare(), cam, tc.RenderConfig(width=w, height=h, sh_degree=1,
                                                      raster=raster), max_pairs=1 << 18)
        if grads:
            (torch.sum(o.image ** 2) + torch.sum(o.transmittance ** 2)).backward()
            o = [getattr(s, f).grad.numpy() for f in interop.SPLAT_FIELDS]
        outs.append(o)
    return outs


# name: (seed, n, scale_range, caps, image atol, share of pixels beyond 1e-3,
#        width, x spread); "wide_mid_edges" has mid splats in the edge cells
#        of the mid grid of an image whose coarse grid has three cells per row
AGAINST_PAIRS = {
    "fine": (0, 600, (-3.0, -1.2), (512, 512, 128, 128), 2e-5, 0.0, W, 1.0),
    "big_splats": (7, 150, (-1.5, 0.2), (256, 256, 256, 256), 2e-4, 0.0, W, 1.0),
    "merge_path": (2, 300, (-5.0, 0.5), (1024, 256, 256, 256), 2e-2, 0.01, W, 1.0),
    "nonpow2_caps": (2, 300, (-5.0, 0.5), (384, 256, 384, 128), 2e-2, 0.01, W, 1.0),
    "wide_mid_edges": (3, 400, (-2.5, -1.5), (512, 512, 256, 128), 2e-4, 0.0, 320, 5.0),
}


@pytest.mark.parametrize("name", list(AGAINST_PAIRS))
def test_bucket_matches_pair_path(name):
    seed, n, scale_range, caps, atol, far_share, w, x_spread = AGAINST_PAIRS[name]
    ref, out = pair_and_bucket(seed, n, scale_range, caps, w=w, x_spread=x_spread)
    assert not bool(out.overflow) and not bool(ref.overflow)
    diff = (out.image - ref.image).abs()
    assert diff.max().item() < atol, diff.max().item()
    assert (diff > 1e-3).float().mean().item() <= far_share
    if name == "fine":
        assert (out.transmittance - ref.transmittance).abs().max().item() < atol
        both = (out.splat_id >= 0) & (ref.splat_id >= 0)
        assert (out.splat_id[both] == ref.splat_id[both]).float().mean().item() > 0.99


def test_bucket_overflow_flags_truncation():
    """A fine-dominated scene: the 128 fine cap truncates, 512 holds it."""
    d = interop.random_splat_arrays(2, 4000, sh_degree=1, extent=2.5, scale_range=(-5.5, -4.0))
    cam = gt.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9, device="cpu")
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    flags = [bool(render(prep, cam, tc.RenderConfig(width=W, height=H, sh_degree=1,
                                                     raster=bucket_raster(c, tc))).overflow)
             for c in ((128, 128, 128, 128), (512, 128, 128, 128))]
    assert flags == [True, False]


def test_bucket_empty_scene_looking_away():
    d = interop.random_splat_arrays(0, 64, sh_degree=1, extent=2.5, scale_range=(-3.0, -1.2))
    cam = gt.look_at([0, 0, -6], [0, 0, -12], [0, 1, 0], W, H, fov_y_rad=0.9, device="cpu")
    out = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam,
                 tc.RenderConfig(width=W, height=H, sh_degree=1,
                                 raster=bucket_raster((512, 512, 128, 128), tc)))
    assert (out.transmittance == 1).all() and int(out.num_pairs) == 0


@pytest.mark.parametrize("seed, n, scale_range, caps", [
    (11, 250, (-3.0, -1.2), (512, 512, 128, 128)),
    (13, 200, (-4.5, -0.5), (512, 128, 128, 128)),
    (12, 150, (-3.0, -1.2), (384, 128, 128, 128)),
])
def test_bucket_gradients_match_pair_path(seed, n, scale_range, caps):
    """tests/test_bucket.py's gradient cases, on the six SplatSet fields:
    2e-5 of each field's max."""
    g_ref, g_bkt = pair_and_bucket(seed, n, scale_range, caps, w=64, h=48, grads=True)
    for f, a, b in zip(interop.SPLAT_FIELDS, g_ref, g_bkt):
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-5, err_msg=f)


# ---- the twins and the wrappers ---------------------------------------------

def small_bins(caps=(384, 256, 384, 128), chunk=128, seed=4, n=300, scale_range=(-5.0, 0.5)):
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=1, raster=tc.RasterConfig(
        method="bucket", bucket_caps=caps, bucket_chunk=chunk))
    cam, _ = cam_pair(64, 48)
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)
    proj = project_splats(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    st = bucket_statics(cfg)
    bins = tbg.bucket_splats(proj, rows.detach(), ids, tiles_x=st.tiles_x,
                             tiles_y=st.tiles_y, caps=caps)
    return bins, st, caps


@pytest.mark.parametrize("chunk", [128, 384])
def test_bucket_twin_backward_matches_autograd(chunk):
    bins, st, caps = small_bins(chunk=chunk)
    attrs = bins.attrs.detach().clone().requires_grad_()
    out, _ = rb.rasterize_buckets_ref(attrs, bins.ids, bins.bucket_starts, st, caps)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    g[:, 4] = 0.0  # the picked depth is not differentiated
    (d_auto,) = torch.autograd.grad((out * g).sum(), attrs)
    d_twin = rb.rasterize_buckets_bwd_ref(bins.attrs.detach(), bins.bucket_starts,
                                          tr.bwd_context(out.detach(), g), st, caps)
    assert out[:, 3].min().item() < st.min_transmittance  # pixels froze
    for r in range(tr.GRAD_ROWS):
        scale = d_auto[r].abs().max().item()
        assert scale > 0, r
        assert (d_twin[r] - d_auto[r]).abs().max().item() <= GRAD_RTOL * scale, r
    assert (d_twin[tr.GRAD_ROWS:] == 0).all()


def test_bucket_twin_on_tile_subsets():
    """The twins on a subset of tiles give those tiles' rows of the whole,
    and the column gradients of their tiles alone sum to the whole's."""
    bins, st, caps = small_bins()
    out, out_id = rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, caps)
    tiles = torch.tensor([3, 0, 7, 11])
    sub, sub_id = rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, caps,
                                           tiles=tiles)
    assert torch.equal(sub, out[tiles]) and torch.equal(sub_id, out_id[tiles])
    ctx = tr.bwd_context(out, torch.ones_like(out))
    whole = rb.rasterize_buckets_bwd_ref(bins.attrs, bins.bucket_starts, ctx, st, caps)
    n_t = st.tiles_x * st.tiles_y
    parts = sum(rb.rasterize_buckets_bwd_ref(bins.attrs, bins.bucket_starts, ctx, st, caps,
                                             tiles=torch.arange(a, min(a + 5, n_t)))
                for a in range(0, n_t, 5))
    assert (parts - whole).abs().max().item() <= 1e-6 * whole.abs().max().item()


def test_bucket_work_counts():
    bins, st, caps = small_bins()
    work = rb.bucket_work(bins.attrs, bins.bucket_starts, st, caps)
    spec = tbg.BucketGridSpec.build(st.tiles_x, st.tiles_y)
    assert not bool(bins.overflow)
    lengths = tbg.span_lengths(bins.bucket_starts, spec)
    assert work.live == int(lengths.sum()) and work.shared == int(lengths[:, 1:].sum())
    assert 0 < work.hits < work.evals <= work.live * tr.PIX
    assert work.comparisons > work.live
    assert 0 < work.kept < work.tested <= work.live
    assert work.hits <= work.kept_evals < work.evals


# ---- K4's per-tile cull: the plain predicate ---------------------------------

def assert_cull_is_exact(attrs, bucket_starts, st, caps, pix_ctx=None, min_culled=0.0):
    """``tile_may_hit`` keeps every lane that the model's alpha passes at
    some pixel of its tile (``tile_lane_hits``, frozen pixels too), and
    culls at least ``min_culled`` of the live lanes; the hit test itself
    sees every hit of the twin's sweep. Returns (kept, hit, live) masks."""
    may = rb.tile_may_hit(attrs, bucket_starts, st, caps, pix_ctx=pix_ctx)
    hit = rb.tile_lane_hits(attrs, bucket_starts, st, caps, pix_ctx=pix_ctx)
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    lists = rb._tile_lists(attrs, bucket_starts, st, caps, tiles)
    live = lists.cols >= 0
    assert may.shape == hit.shape == live.shape
    assert not (may & ~live).any() and not (hit & ~live).any()
    assert int((hit & ~may).sum()) == 0, "the cull dropped a lane that hits"
    swept = torch.zeros_like(live)
    for s in tr._blend_steps(attrs[:, lists.cols.clamp(min=0)], lists.tile_start,
                             lists.tile_count, st, tiles, pix_ctx)[1]:
        swept[s.pc[(s.alpha > 0).any(dim=1)]] = True
    assert not (swept & ~hit).any()
    assert 1.0 - may.sum().item() / live.sum().item() >= min_culled
    return may, hit, live


def golden_bins():
    """The golden scene at W x H on the bucket path, caps fitted to it."""
    splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device="cpu")
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], W, H, fov_y_rad=0.9,
                     device="cpu")
    proj = project_splats(splats.prepare(), cam, tc.RenderConfig(width=W, height=H,
                                                                 sh_degree=0))
    spec = tbg.BucketGridSpec.build(W // 16, H // 16)
    caps = tbg.fit_caps([int(x) for x in tbg.measure_required_caps(proj, spec)])
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=0, raster=bucket_raster(caps, tc))
    rows, ids = gs_attr_rows(proj)
    st = bucket_statics(cfg)
    bins = tbg.bucket_splats(proj, rows.detach(), ids, tiles_x=st.tiles_x, tiles_y=st.tiles_y,
                             caps=caps)
    assert not bool(bins.overflow)
    return bins, st, caps


def test_cull_is_exact_on_the_golden_scene():
    bins, st, caps = golden_bins()
    may, hit, live = assert_cull_is_exact(bins.attrs, bins.bucket_starts, st, caps,
                                          min_culled=0.05)
    assert hit.sum() > 0


def test_cull_drops_lanes_of_spans_wider_than_their_splats():
    """Mid and coarse splats read by many tiles: most of their lanes touch
    none of a reading tile's pixels, and the predicate culls them."""
    bins, st, caps = small_bins(n=300, scale_range=(-3.0, 0.0))
    may, hit, live = assert_cull_is_exact(bins.attrs, bins.bucket_starts, st, caps)
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    lists = rb._tile_lists(bins.attrs, bins.bucket_starts, st, caps, tiles)
    assert int(lists.n_eff[:, 1:5].sum()) > int(lists.n_eff[:, 0].sum())  # mostly mid, coarse
    assert 1.0 - may.sum().item() / live.sum().item() > 0.3


def f32_next(x, toward):
    return float(np.nextafter(np.float32(x), np.float32(toward)))


def adversarial_gs2d_rows(st):
    """(opacity, conic a, b, c, x offset) rows at the gs2d predicate's edges,
    each to be put on a pixel centre of a tile that reads it (x offset
    aside): opacity at alpha_min and one ulp either side; near-singular,
    indefinite, negative-definite and zero conics; NaN and inf rows. Rows
    0-1 hit, row 2 cannot and is culled, rows 3-12 must be kept."""
    amin = float(np.float32(st.alpha_min))
    nan, inf = float("nan"), float("inf")
    return [(amin, 0.5, 0.0, 0.5, 0), (f32_next(amin, 1), 0.5, 0.0, 0.5, 0),
            (f32_next(amin, 0), 0.5, 0.0, 0.5, 0), (0.9, 0.5, 0.4999999, 0.5, 0),
            (0.9, 2.0, 1.9999999, 2.0, 30), (0.9, 0.5, 0.8, 0.5, 30),
            (0.9, -0.5, 0.0, -0.5, 30), (0.9, 0.0, 0.0, 0.0, 30), (0.9, 0.5, 0.0, 0.5, nan),
            (nan, 0.5, 0.0, 0.5, 0), (inf, 0.5, 0.0, 0.5, 40), (0.9, inf, 0.0, 0.5, 0),
            (0.9, 0.5, nan, 0.5, 0), (f32_next(amin, 0), 1e-30, 0.0, 1e-30, 0)]


def adversarial_gs2d_bins():
    """(bins, st, caps, picked columns, rows): small_bins with its first live
    columns rewritten to ``adversarial_gs2d_rows``, each centred on a pixel
    of a reading tile (x offset aside)."""
    bins, st, caps = small_bins(n=300, scale_range=(-5.0, -1.0))
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    lists = rb._tile_lists(bins.attrs, bins.bucket_starts, st, caps, tiles)
    lanes = lists.cols.view(tiles.shape[0], -1)
    rows = adversarial_gs2d_rows(st)
    attrs = bins.attrs.clone()
    picked = torch.unique(lists.cols[lists.cols >= 0])[:len(rows)]
    for col, (op, a, b, c, dx) in zip(picked.tolist(), rows):
        t = int(torch.nonzero((lanes == col).any(dim=1))[0])
        attrs[0, col] = (t % st.tiles_x) * 16 + 3.5 + dx
        attrs[1, col] = (t // st.tiles_x) * 16 + 5.5
        attrs[2:6, col] = torch.tensor([a, b, c, op])
    return dataclasses.replace(bins, attrs=attrs), st, caps, picked, rows


def test_cull_on_adversarial_gs2d_rows():
    """Nothing that hits is culled, and every non-finite or
    non-positive-definite row is kept."""
    bins, st, caps, picked, rows = adversarial_gs2d_bins()
    lists = rb._tile_lists(bins.attrs, bins.bucket_starts, st, caps,
                           torch.arange(st.tiles_x * st.tiles_y))
    may, hit, _ = assert_cull_is_exact(bins.attrs, bins.bucket_starts, st, caps)
    at = lists.cols[:, None] == picked[None, :]                     # (lanes, rows)
    kept = [bool(may[at[:, k]].all()) for k in range(len(rows))]
    hits = [bool(hit[at[:, k]].any()) for k in range(len(rows))]
    assert hits[0] and hits[1] and not hits[2]                       # alpha_min is inclusive
    assert kept[0] and kept[1] and not kept[2]
    assert all(kept[3:13]), kept                                     # degenerate or not finite


# ---- K3's per-tile cull: the twin's sweep without the culled lanes ----------

def culled_sweep(attrs, ids, bucket_starts, st, caps, pix_ctx=None, drop=None):
    """K3's twin over every tile, as ``rasterize_buckets_ref`` runs it, with
    the lanes of ``drop`` (``tile_may_hit``'s layout) made "no lane" in
    place: zero rows, whose alpha fails the cutoffs in every model, and id
    -1. The sweep the kernel runs, which stages only the kept lanes."""
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    lists = rb._tile_lists(attrs, bucket_starts, st, caps, tiles)
    c = lists.cols.clamp(min=0)
    lane_attrs, lane_ids = attrs[:, c], ids[c]
    if drop is not None:
        lane_attrs[:, drop] = 0.0
        lane_ids[drop] = -1
    return tr.rasterize_tiles_ref(lane_attrs, lane_ids, lists.tile_start, lists.tile_count, st,
                                  tiles, pix_ctx)


def assert_culled_sweep_changes_nothing(attrs, ids, bucket_starts, st, caps, pix_ctx=None):
    """The twin, and the twin with every lane ``tile_may_hit`` culls taken
    out, give the same rgb, T, depth and id bit for bit. Returns the share
    of the live lanes culled."""
    out, out_id = rb.rasterize_buckets_ref(attrs, ids, bucket_starts, st, caps, pix_ctx=pix_ctx)
    same, same_id = culled_sweep(attrs, ids, bucket_starts, st, caps, pix_ctx)
    assert torch.equal(same, out) and torch.equal(same_id, out_id)   # the helper is the twin
    live = rb._tile_lists(attrs, bucket_starts, st, caps,
                          torch.arange(st.tiles_x * st.tiles_y)).cols >= 0
    drop = live & ~rb.tile_may_hit(attrs, bucket_starts, st, caps, pix_ctx=pix_ctx)
    got, got_id = culled_sweep(attrs, ids, bucket_starts, st, caps, pix_ctx, drop)
    assert torch.isfinite(out).all() and (out_id >= 0).any()
    assert torch.equal(got, out), (got - out).abs().max().item()
    assert torch.equal(got_id, out_id)
    return drop.sum().item() / live.sum().item()


@pytest.mark.parametrize("scene", ["golden", "adversarial"])
def test_culled_sweep_changes_nothing_gs2d(scene):
    """K3 stages only the lanes the cull keeps: on the golden frame and on
    the adversarial rows (test_cull_on_adversarial_gs2d_rows), the sweep
    without the culled lanes equals the twin's bit for bit."""
    if scene == "golden":
        bins, st, caps = golden_bins()
    else:
        bins, st, caps, _, _ = adversarial_gs2d_bins()
    culled = assert_culled_sweep_changes_nothing(bins.attrs, bins.ids, bins.bucket_starts, st,
                                                 caps)
    assert culled > 0.05


@pytest.mark.parametrize("caps", [(500, 256, 512, 256), (512, 0, 512, 256), (512, 256, 512)])
def test_bucket_caps_must_be_multiples_of_128(caps):
    bins, st, _ = small_bins()
    with pytest.raises(ValueError, match="multiples of 128"):
        rb.rasterize_buckets(bins, st, caps)


def test_train_step_on_bucket_path_lowers_the_loss():
    d = interop.random_splat_arrays(0, 400, sh_degree=0, scale_range=(-4.0, -1.5))
    init = dict(d, sh_dc=d["sh_dc"] + np.random.default_rng(1).normal(
        scale=0.3, size=d["sh_dc"].shape).astype(np.float32))
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=0,
                          raster=bucket_raster((512, 128, 128, 128), tc))
    cam, _ = cam_pair(64, 48)
    with torch.no_grad():
        target = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg).image
    splats = interop.splat_set_from_numpy(init, "cpu")
    tcfg = tt.TrainConfig(scene_extent=3.0)
    opt = tt.make_optimizer(splats, tcfg)
    before = rb.rasterize_buckets.launches, rb.rasterize_buckets_bwd.launches
    losses = [float(tt.train_step(splats, opt, cam, target, cfg, 0, tcfg)[0]) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    assert (rb.rasterize_buckets.launches, rb.rasterize_buckets_bwd.launches) == before


def test_library_path_hashes_the_shared_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.name.startswith("libk-")
