"""The 3DGUT and 3DGRT raster pipelines of the PyTorch port on the CPU,
where the twins blend, against the JAX package (Pallas kernels in interpret
mode, as tests/test_gut.py runs them): cameras and the shutter helpers, the
UT projection, the rays, the gut3d response and its hand-derived VJP, the
twins' backward, frames, render-level gradients, the 3DGRT depth-row
asymmetry, and a training step.

Tolerances, each with its reason:
- shutter helpers: 1e-6 absolute (unit quaternions, times in [0, 1]).
- UT projection: 1e-5 relative to each row's scale (its largest entry),
  ``valid`` and ``radius`` exactly, as tests/test_torch_projection.py: XLA
  on the CPU contracts multiply-adds into FMAs, so the packages are not
  bit-equal. The conic, to 5e-5 of each splat's conic (Frobenius norm): it
  inverts a covariance summed from differences of nearly equal sigma-point
  projections, which loses digits in f32; on these scenes the port is up to
  2.7e-5 and the JAX package up to 1.2e-5 from a float64 evaluation of the
  same arithmetic (fisheye; pinhole, OpenCV and rolling up to 6.5e-6).
- rays: 1e-6 absolute (unit directions, origins near the unit scale).
- gut3d alpha: 1e-5 of the block's max where both kept the pair, and the
  kept sets equal on >= 99.9 % of (pixel, lane) entries: the two packages'
  rsqrt round apart, which can flip an entry at a cutoff.
- gut3d VJP, against torch autograd of the twin's alpha and against
  ``jax.vjp`` of the JAX alpha: 1e-5 of each row's max.
- twin backward against autograd of the twin forward: 1e-5 of each row's
  max (as tests/test_torch_rasterize_bwd.py).
- frames against JAX: image and transmittance within 5e-5 on >= 99.9 % of
  channels and none beyond 1.2e-2 (a flipped cutoff moves a pixel by up to
  about kernel_min_response * opacity, verify SKILL); picked depth (1e-5)
  and ids on >= 99.9 % of pixels.
- render-level gradients of the six SplatSet fields against ``jax.grad``:
  the 99.9th percentile of |diff| / max |ref| at most 1e-4, the max at most
  2e-3 (tests/test_gut.py:136's bound): a flipped cutoff moves one
  pair-pixel's whole gradient.

The per-tile cull of the gut3d pair lists (K2g's instance does not cull,
``Model.cull_pairs``): ``pair_may_hit`` keeps every pair that hits, and the
backward twin with the culled pairs taken out equals the full sweep bit for
bit, at degrees 0, 1 and 2 under pinhole, fisheye and rolling-shutter
cameras. K1g's per-warp cull (``pair_warp_may_hit``) keeps every (warp,
pair) that hits at every degree under every camera of the cull tests, the
forward twin without the culled (warp, pair)s equals the full sweep bit for
bit, and the predicate's tile answers are those of its unfactored form.

JAX programs built here: five frames and two gradients (seven Pallas
interpret programs), plus plain XLA programs for projections, rays and the
response model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import projection as jproj
from vk_gaussian_splatting_tpu.ops import rasterize_pallas as jr
from vk_gaussian_splatting_tpu.ops import response as jresp
from vk_gaussian_splatting_tpu.render import rays as jrays
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgrt as j_grt
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgut as j_gut
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch import train as tt
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops import response as tresp
from vk_gaussian_splatting_tpu_torch.ops.projection import ut_project_splats
from vk_gaussian_splatting_tpu_torch.render import pipelines as tp
from vk_gaussian_splatting_tpu_torch.render import rays as trays
from vk_gaussian_splatting_tpu_torch.render import render
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam
from test_torch_bucket import assert_culled_sweep_changes_nothing, small_bins
from test_torch_cuda import elementwise_share, float64_twin_bwd, low_case
from test_torch_rasterize import (
    assert_culled_backward_changes_nothing,
    assert_may_hit_unchanged,
    assert_pair_cull_is_exact,
    assert_pair_warp_cull_is_exact,
    assert_warp_culled_sweep_changes_nothing,
)

torch.set_num_threads(2)

PROJ_RTOL, CONIC_RTOL = 1e-5, 5e-5
RAY_ATOL = 1e-6
ALPHA_RTOL, MASK_AGREE = 1e-5, 0.999
VJP_RTOL = 1e-5
IMG_ATOL, IMG_SHARE, IMG_MAX = 5e-5, 0.999, 1.2e-2
DEPTH_ATOL, ID_AGREE = 1e-5, 0.999
GRAD_P999, GRAD_MAX = 1e-4, 2e-3
W, H = 96, 64

DISTORTION = np.zeros(18, np.float32)
DISTORTION[[0, 1, 3, 6, 7, 8, 10]] = [0.1, -0.02, 0.05, 0.01, -0.005, 0.002, -0.001]


def to_jax(d):
    return jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})


def scene_arrays(seed=0, n=300):
    """tests/test_gut.py's scene: extent 3, scales exp(-2.5..-1)."""
    return interop.random_splat_arrays(seed, n, sh_degree=1, extent=3.0,
                                       scale_range=(-2.5, -1.0))


def cameras(w=W, h=H, shift=0.0, **kw):
    """A pinhole camera at z = -10 for both packages; ``shift`` moves the
    rolling-shutter end pose right along world x (tests/test_shutter.py)."""
    cam = tcam.look_at([0.2, -0.3, -10.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                       device="cpu")
    d = interop.camera_to_numpy(cam)
    vm_end = d["viewmat"].copy()
    r = vm_end[:3, :3]
    eye = -r.T @ vm_end[:3, 3]
    vm_end[:3, 3] = -r @ (eye + np.array([shift, 0, 0], np.float32))
    d.update(viewmat_end=vm_end, **kw)
    return interop.camera_from_numpy(d, "cpu"), jcam.make_camera(**d)


# ---- cameras and the shutter helpers ---------------------------------------

def test_camera_carries_the_new_fields_across():
    cam_t, cam_j = cameras(focus_dist=8.0, aperture=0.3, distortion=DISTORTION)
    for k, v in interop.camera_to_numpy(cam_t).items():
        np.testing.assert_array_equal(np.asarray(getattr(cam_j, k)), v)
    plain = tcam.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0], 32, 32, device="cpu")
    assert float(plain.aperture) == 0.0 and float(plain.focus_dist) == 1.0
    assert torch.equal(plain.viewmat_end, plain.viewmat)
    assert (plain.distortion == 0).all() and plain.distortion.shape == (18,)


def test_shutter_helpers_match_jax():
    rng = np.random.default_rng(0)
    cam_t, cam_j = cameras(shift=0.7)
    q_t = tcam.shutter_poses(cam_t)
    q_j = jcam.shutter_poses(cam_j)
    for (qt, tt_), (qj, tj) in zip(q_t, q_j):
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tt_.numpy(), np.asarray(tj))
    # a rotation with every Shepperd branch exercised by its sign pattern
    for seed in range(4):
        q = np.random.default_rng(seed).normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
                       np.float32)
        np.testing.assert_allclose(tcam.rotmat_to_quat(torch.from_numpy(rot)).numpy(),
                                   np.asarray(jcam.rotmat_to_quat(jnp.asarray(rot))),
                                   rtol=0, atol=1e-6)
    t = rng.uniform(0, 1, 50).astype(np.float32)
    for q1 in (q_t[1][0].numpy(), -q_t[1][0].numpy(), q_t[0][0].numpy()):
        np.testing.assert_allclose(
            tcam.quat_slerp(q_t[0][0], torch.from_numpy(q1), torch.from_numpy(t)).numpy(),
            np.asarray(jcam.quat_slerp(q_j[0][0], jnp.asarray(q1), jnp.asarray(t))),
            rtol=0, atol=1e-6)
    u = rng.uniform(-5, W + 5, 200).astype(np.float32)
    v = rng.uniform(-5, H + 5, 200).astype(np.float32)
    for shutter in tc.ShutterType:
        st = tcam.shutter_time(shutter, torch.from_numpy(u), torch.from_numpy(v), W, H)
        sj = jcam.shutter_time(jc.ShutterType(int(shutter)), jnp.asarray(u), jnp.asarray(v),
                               W, H)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    p = rng.normal(size=(3, 200)).astype(np.float32)
    tt_ = torch.from_numpy(t[:1].repeat(200))
    got = tcam.shutter_transform_cols(cam_t, tt_, *map(torch.from_numpy, p))
    want = jcam.shutter_transform_cols(cam_j, jnp.asarray(tt_.numpy()), *map(jnp.asarray, p))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


# ---- the UT projection -------------------------------------------------------

UT_CASES = {
    "pinhole": ({}, {}, 0.0),
    "fisheye": (dict(camera_type="FISHEYE"), {}, 0.0),
    "opencv": ({}, dict(distortion=DISTORTION), 0.0),
    "rolling": (dict(shutter="ROLLING_TOP_TO_BOTTOM"), {}, 0.6),
}


def named_cfgs(name_kw, **extra):
    """(JAX, port) RenderConfigs with enum fields given by name."""
    kw = dict(width=W, height=H, sh_degree=1)
    kw.update(extra)
    cj, ct = dict(kw), dict(kw)
    for field, enum in (("camera_type", "CameraType"), ("shutter", "ShutterType"),
                        ("pipeline", "Pipeline")):
        if field in name_kw:
            cj[field] = getattr(jc, enum)[name_kw[field]]
            ct[field] = getattr(tc, enum)[name_kw[field]]
    for field in ("temporal_samples",):
        if field in name_kw:
            cj[field] = ct[field] = name_kw[field]
    raster, rt = name_kw.get("raster", {}), name_kw.get("rt", {})
    return (jc.RenderConfig(**cj, raster=jc.RasterConfig(**raster), rt=jc.RtConfig(**rt)),
            tc.RenderConfig(**ct, raster=tc.RasterConfig(**raster), rt=tc.RtConfig(**rt)))


def assert_rows_close(a, b, rtol, scale=None):
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    if scale is None:
        scale = np.abs(a).max(axis=1, keepdims=True)
    err = (np.abs(a - b) / np.maximum(scale, 1e-30)).max()
    assert err <= rtol, err


@pytest.mark.parametrize("name", list(UT_CASES))
def test_ut_projection_matches_jax(name):
    cfg_kw, cam_kw, shift = UT_CASES[name]
    cj, ct = named_cfgs(cfg_kw)
    cam_t, cam_j = cameras(shift=shift, **cam_kw)
    d = interop.random_splat_arrays(4, 600, sh_degree=1, extent=8.0, scale_range=(-3.0, -0.5))
    pj = jax.jit(jproj.ut_project_splats, static_argnums=2)(to_jax(d).prepare(), cam_j, cj)
    pt = ut_project_splats(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t, ct)
    valid = np.asarray(pj.valid)
    np.testing.assert_array_equal(pt.valid.numpy(), valid)
    assert 50 < valid.sum() < valid.size, valid.sum()
    np.testing.assert_array_equal(pt.radius.numpy(), np.asarray(pj.radius))
    for f in ("xy", "depth", "color", "alpha"):
        a = np.asarray(getattr(pj, f))[valid]
        assert_rows_close(a.reshape(len(a), -1).T, getattr(pt, f).detach().numpy()[valid]
                          .reshape(len(a), -1).T, PROJ_RTOL)
    cj_ = np.asarray(pj.conic, np.float64)[valid]
    norm = np.sqrt(cj_[:, 0] ** 2 + 2 * cj_[:, 1] ** 2 + cj_[:, 2] ** 2)
    err = np.abs(pt.conic.detach().numpy()[valid] - cj_).max(axis=1) / norm
    assert err.max() <= CONIC_RTOL, err.max()


# ---- rays ---------------------------------------------------------------------

@pytest.mark.parametrize("name, cfg_kw, shift", [
    ("pinhole", {}, 0.0), ("fisheye", dict(camera_type="FISHEYE"), 0.0),
    ("rolling", dict(shutter="ROLLING_LEFT_TO_RIGHT"), 0.5)])
def test_build_tile_rays_matches_jax(name, cfg_kw, shift):
    cj, ct = named_cfgs(cfg_kw)
    cam_t, cam_j = cameras(shift=shift)
    if name == "fisheye":  # a narrow fisheye FOV, so corner pixels fall outside it
        dd = DISTORTION * 0
        dd[16] = 0.5
        cam_t, cam_j = cameras(distortion=dd)
        cam_t = dataclasses.replace(cam_t, distortion=torch.zeros(18))
        cam_j = dataclasses.replace(cam_j, distortion=jnp.zeros(18))
    got = trays.build_tile_rays(cam_t, ct).numpy()
    want = np.asarray(jrays.build_tile_rays(cam_j, cj))
    assert got.shape == want.shape == ((W // 16) * (H // 16), 8, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=RAY_ATOL)
    norms = np.linalg.norm(got[:, 0:3], axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)


def test_thin_lens_matches_jax_with_its_samples():
    """The lens, fed the JAX package's own uniforms (its key and split), is
    the JAX lens; only the stream the port draws from differs."""
    cj, ct = named_cfgs({})
    cam_t, cam_j = cameras(focus_dist=8.0, aperture=0.3)
    sample = 3
    want = np.asarray(jrays.build_tile_rays(cam_j, cj, sample_id=sample))
    key = jax.random.fold_in(jax.random.key(0x3D6F), jnp.asarray(sample, jnp.int32))
    k1, k2 = jax.random.split(key)
    shape = ((H // 16) * 16, (W // 16) * 16)
    r1 = torch.from_numpy(np.array(jax.random.uniform(k1, shape)))
    r2 = torch.from_numpy(np.array(jax.random.uniform(k2, shape)))
    plain = dataclasses.replace(cam_t, aperture=torch.tensor(0.0))
    flat = trays.build_tile_rays(plain, ct).numpy()           # no DoF
    full = flat.reshape(H // 16, W // 16, 8, 16, 16).transpose(0, 3, 1, 4, 2).reshape(
        H, W, 8)
    dirs, org = trays._thin_lens(torch.from_numpy(full[..., 0:3].copy()),
                                 torch.from_numpy(full[..., 3:6].copy()), r1, r2, cam_t)
    want_full = want.reshape(H // 16, W // 16, 8, 16, 16).transpose(0, 3, 1, 4, 2).reshape(
        H, W, 8)
    np.testing.assert_allclose(dirs.numpy(), want_full[..., 0:3], rtol=0, atol=RAY_ATOL)
    np.testing.assert_allclose(org.numpy(), want_full[..., 3:6], rtol=0, atol=RAY_ATOL)
    # the port's own stream: reproducible per sample id, new per sample
    a = trays.build_tile_rays(cam_t, ct, sample_id=sample)
    assert torch.equal(a, trays.build_tile_rays(cam_t, ct, sample_id=sample))
    assert not torch.equal(a, trays.build_tile_rays(cam_t, ct, sample_id=sample + 1))
    assert np.abs(a.numpy() - flat).max() > 1e-3


# ---- the gut3d response model ------------------------------------------------

def gut_block(seed, c=128):
    """(16, c) JAX-layout gut3d rows near a fan of rays from the origin, and
    the (8, 256) pixel context of those rays."""
    rng = np.random.default_rng(seed)
    block = np.zeros((16, c), np.float32)
    block[0:2] = rng.uniform(-1.0, 1.0, (2, c))
    block[2] = rng.uniform(4.0, 6.0, c)
    block[3:6] = np.exp(rng.uniform(-2.0, -0.3, (3, c)))
    block[6:9] = rng.uniform(0, 1, (3, c))
    q = rng.normal(size=(4, c))
    block[9:13] = q / np.linalg.norm(q, axis=0)
    block[13] = rng.uniform(0.05, 1.0, c)
    block[14] = block[2]
    pix = np.zeros((8, 256), np.float32)
    dirs = np.stack([rng.uniform(-0.2, 0.2, 256), rng.uniform(-0.2, 0.2, 256), np.ones(256)])
    pix[0:3] = dirs / np.linalg.norm(dirs, axis=0)
    pix[3:6] = rng.normal(scale=0.05, size=(3, 256))
    live = (np.arange(c) < c - 10)[None, :]
    return block, pix, live


def statics_pair(degree):
    kmin = max(0.0113, tresp.deg0_min_response(tc.RtConfig(kernel_degree=degree)))
    return (jr.RasterStatics(1, 1, model="gut3d", kernel_degree=degree,
                             kernel_min_response=kmin),
            tr.RasterStatics(1, 1, model="gut3d", kernel_degree=degree,
                             kernel_min_response=kmin))


@pytest.mark.parametrize("degree", tresp.KERNEL_DEGREES)
def test_gut3d_alpha_matches_jax(degree):
    block, pix, live = gut_block(degree)
    sj, st = statics_pair(degree)
    aj = np.asarray(jresp.gut3d_alpha(jnp.asarray(block), jnp.asarray(pix.T), None, None,
                                      jnp.asarray(live), sj))
    at = tresp.gut3d_alpha(torch.from_numpy(block[:15]), torch.from_numpy(pix),
                           torch.from_numpy(live), st).numpy()
    assert 0.05 < (aj > 0).mean() < 0.95, (aj > 0).mean()
    assert ((aj > 0) == (at > 0)).mean() >= MASK_AGREE
    both = (aj > 0) & (at > 0)
    assert np.abs(at - aj)[both].max() <= ALPHA_RTOL * aj.max()


@pytest.mark.parametrize("degree", tresp.KERNEL_DEGREES)
def test_gut3d_alpha_vjp_matches_autograd_and_jax(degree):
    block, pix, live = gut_block(10 + degree)
    sj, st = statics_pair(degree)
    rng = np.random.default_rng(degree)
    d_alpha = rng.normal(size=(256, block.shape[1])).astype(np.float32)
    rows = list(tresp.MODELS["gut3d"].geo_rows)
    got = tresp.gut3d_alpha_vjp(torch.from_numpy(block[:15]), torch.from_numpy(pix),
                                torch.from_numpy(live), st, torch.from_numpy(d_alpha)).numpy()
    b = torch.from_numpy(block[:15]).requires_grad_()
    (tresp.gut3d_alpha(b, torch.from_numpy(pix), torch.from_numpy(live), st)
     * torch.from_numpy(d_alpha)).sum().backward()
    auto = b.grad.numpy()[rows]
    _, vjp = jax.vjp(lambda x: jresp.gut3d_alpha(x, jnp.asarray(pix.T), None, None,
                                                 jnp.asarray(live), sj), jnp.asarray(block))
    (d_j,) = vjp(jnp.asarray(d_alpha))
    d_j = np.asarray(d_j)[rows]
    assert (np.abs(auto).max(axis=1) > 0).all()
    assert_rows_close(auto, got, VJP_RTOL)
    # the JAX alpha keeps a few entries the twin drops at a cutoff (rsqrt
    # rounds apart): compare the columns where both keep the same pairs
    aj = np.asarray(jresp.gut3d_alpha(jnp.asarray(block), jnp.asarray(pix.T), None, None,
                                      jnp.asarray(live), sj)) > 0
    at = tresp.gut3d_alpha(torch.from_numpy(block[:15]), torch.from_numpy(pix),
                           torch.from_numpy(live), st).numpy() > 0
    same = (aj == at).all(axis=0)
    assert same.mean() > 0.9
    assert_rows_close(d_j[:, same], got[:, same], VJP_RTOL,
                      scale=np.abs(d_j).max(axis=1, keepdims=True))


# ---- the twins' backward -----------------------------------------------------

def gut_bins(method, seed=2, n=400, degree=2):
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=1, pipeline=tc.Pipeline.MESH_3DGUT,
                          rt=tc.RtConfig(kernel_degree=degree),
                          raster=tc.RasterConfig(method=method, bucket_caps=(512, 256, 256, 128),
                                                 bucket_chunk=128))
    cam, _ = cameras(64, 48)
    prep = interop.splat_set_from_numpy(scene_arrays(seed, n), "cpu").prepare()
    proj = ut_project_splats(prep, cam, cfg)
    rows, ids = tp.gut_attr_rows(prep, proj, cfg)
    st = tp.gut_statics(tp.raster_statics(cfg), cfg)
    bins = tp.bin_for_cfg(proj, rows.detach(), ids, cfg, 0, st)
    return bins, st, cfg, trays.build_tile_rays(cam, cfg)


@pytest.mark.parametrize("method, degree", [("pairs", 2), ("bucket", 2), ("pairs", 3)])
def test_twin_backward_matches_autograd(method, degree):
    bins, st, cfg, pix = gut_bins(method, degree=degree)
    attrs = bins.attrs.detach().clone().requires_grad_()
    if method == "bucket":
        st = dataclasses.replace(st, chunk=cfg.raster.bucket_chunk)
        caps = cfg.raster.bucket_caps
        out, _ = rb.rasterize_buckets_ref(attrs, bins.ids, bins.bucket_starts, st, caps,
                                          pix_ctx=pix)
    else:
        out, _ = tr.rasterize_tiles_ref(attrs, bins.pair_id, bins.tile_start, bins.tile_count,
                                        st, pix_ctx=pix)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    g[:, 4] = 0.0  # the picked depth is not differentiated
    (d_auto,) = torch.autograd.grad((out * g).sum(), attrs)
    ctx = tr.bwd_context(out.detach(), g)
    if method == "bucket":
        d_twin = rb.rasterize_buckets_bwd_ref(bins.attrs, bins.bucket_starts, ctx, st, caps,
                                              pix_ctx=pix)
    else:
        d_twin = tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start, bins.tile_count, ctx,
                                            st, pix_ctx=pix)
    assert out[:, 3].min().item() < 0.05  # opaque pixels
    grad_rows = tresp.MODELS["gut3d"].grad_rows
    for r in range(grad_rows):
        scale = d_auto[r].abs().max().item()
        assert scale > 0, r
        assert (d_twin[r] - d_auto[r]).abs().max().item() <= VJP_RTOL * scale, r
    assert (d_twin[grad_rows:] == 0).all()


# ---- frames and gradients against the JAX package ----------------------------

# name: (JAX function, config keywords by name, camera keywords, rolling shift)
FRAMES = {
    "gut_slots": (j_gut, {}, {}, 0.0),
    "gut_exact_fisheye": (j_gut, dict(camera_type="FISHEYE", raster=dict(expansion="exact")),
                          {}, 0.0),
    "gut_bucket_rolling": (j_gut, dict(shutter="ROLLING_TOP_TO_BOTTOM",
                                       raster=dict(method="bucket")), {}, 0.4),
    "grt_pairs_opencv": (j_grt, dict(pipeline="RTX", rt=dict(kernel_degree=4)),
                         dict(distortion=DISTORTION), 0.0),
    "grt_bucket": (j_grt, dict(pipeline="RTX", raster=dict(method="bucket")), {}, 0.0),
}


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax(name):
    fn, cfg_kw, cam_kw, shift = FRAMES[name]
    cfg_kw = dict(cfg_kw)
    cfg_kw.setdefault("pipeline", "MESH_3DGUT")
    cj, ct = named_cfgs(cfg_kw)
    cam_t, cam_j = cameras(shift=shift, **cam_kw)
    d = scene_arrays(1)
    oj = fn(to_jax(d).prepare(), cam_j, cj, max_pairs=1 << 16)
    ot = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t, ct, max_pairs=1 << 16)
    assert bool(oj.overflow) == bool(ot.overflow) is False
    assert int(oj.num_pairs) == int(ot.num_pairs)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE, (diff > IMG_ATOL).mean()
        assert diff.max() <= IMG_MAX, diff.max()
    id_j, id_t = np.asarray(oj.splat_id), ot.splat_id.numpy()
    same = id_j == id_t
    assert same.mean() >= ID_AGREE, same.mean()
    both = same & (id_j >= 0)
    depth_ok = np.abs(ot.depth.numpy() - np.asarray(oj.depth)) <= DEPTH_ATOL
    assert depth_ok[both].mean() >= ID_AGREE
    assert float(ot.transmittance.min()) < 0.5  # the scene covers pixels


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_gut_gradients_match_jax(method):
    """Weighted image plus weighted transmittance through both packages'
    render_3dgut, the six SplatSet fields."""
    w, h = 64, 48
    d = scene_arrays(2, 200)
    rng = np.random.default_rng(7)
    wimg = rng.normal(size=(h, w, 3)).astype(np.float32)
    wt = rng.normal(size=(h, w)).astype(np.float32)
    cam_t, cam_j = cameras(w, h)
    raster = dict(method=method, bucket_caps=(512, 256, 256, 128))
    cj = jc.RenderConfig(width=w, height=h, sh_degree=1, pipeline=jc.Pipeline.MESH_3DGUT,
                         raster=jc.RasterConfig(**raster))
    ct = tc.RenderConfig(width=w, height=h, sh_degree=1, pipeline=tc.Pipeline.MESH_3DGUT,
                         raster=tc.RasterConfig(**raster))

    def loss_j(s):
        o = j_gut(s.prepare(), cam_j, cj, max_pairs=1 << 16)
        return jnp.sum(o.image * wimg) + jnp.sum(o.transmittance * wt)

    g_j = jax.jit(jax.grad(loss_j))(to_jax(d))
    s = interop.splat_set_from_numpy(d, "cpu")
    for f in interop.SPLAT_FIELDS:
        getattr(s, f).requires_grad_()
    o = render(s.prepare(), cam_t, ct, max_pairs=1 << 16)
    assert not bool(o.overflow)
    (torch.sum(o.image * torch.from_numpy(wimg))
     + torch.sum(o.transmittance * torch.from_numpy(wt))).backward()
    for f in interop.SPLAT_FIELDS:
        a = getattr(s, f).grad.numpy().astype(np.float64).ravel()
        b = np.asarray(getattr(g_j, f), np.float64).ravel()
        scale = np.abs(b).max()
        assert scale > 0, f
        rel = np.abs(a - b) / scale
        assert np.quantile(rel, 0.999) <= GRAD_P999, (f, np.quantile(rel, 0.999))
        assert rel.max() <= GRAD_MAX, (f, rel.max())


# ---- the port's own checks -------------------------------------------------------

def test_grt_depth_row_on_pairs_is_view_z_and_on_bucket_radial():
    """3DGRT orders the blend by radial distance on both paths, but the
    picked depth is view z on the pair path (radial distance replaces the
    sort key only) and the radial distance on the bucket path (it is the
    depth row the kernel merges on), as in the JAX package."""
    d = scene_arrays(3)
    cam, _ = cameras()
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    picked = {}
    for method in ("pairs", "bucket"):
        cfg = tc.RenderConfig(width=W, height=H, sh_degree=1, pipeline=tc.Pipeline.RTX,
                              raster=tc.RasterConfig(method=method))
        o = render(prep, cam, cfg)
        ids = o.splat_id.flatten()
        hit = ids >= 0
        assert hit.float().mean().item() > 0.3
        picked[method] = (ids[hit].long(), o.depth.flatten()[hit])
    proj = ut_project_splats(prep, cam, tc.RenderConfig(width=W, height=H, sh_degree=1))
    radial = torch.linalg.norm(prep.means - cam.position, dim=-1)
    ids, depth = picked["pairs"]
    assert torch.equal(depth, proj.depth[ids].detach())
    ids, depth = picked["bucket"]
    assert torch.equal(depth, radial[ids])
    assert (proj.depth[ids] - radial[ids]).abs().max().item() > 1e-3


def test_dof_temporal_samples_change_the_frame():
    """Thin-lens DoF at temporal_samples=4 (tests/test_gut.py:141): finite,
    and visibly changed by the aperture; blend and rays once per sample."""
    d = scene_arrays(4, 200)
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=1, pipeline=tc.Pipeline.MESH_3DGUT,
                          temporal_samples=4)
    cam, _ = cameras()
    dof, _ = cameras(focus_dist=8.0, aperture=0.3)
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    sharp, blurred = render(prep, cam, cfg), render(prep, dof, cfg)
    assert torch.isfinite(blurred.image).all()
    assert (sharp.image - blurred.image).abs().max().item() > 1e-3
    one = render(prep, cam, cfg.replace(temporal_samples=1))
    assert (sharp.image - one.image).abs().max().item() < 1e-6  # no lens: samples agree


def test_fisheye_on_3dgs_renders_pinhole_ewa():
    """The JAX ``project_splats`` is pinhole EWA whatever camera_type says;
    so is the port's."""
    d = scene_arrays(5, 200)
    cam, _ = cameras()
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=1)
    a = render(prep, cam, cfg)
    b = render(prep, cam, cfg.replace(camera_type=tc.CameraType.FISHEYE))
    assert torch.equal(a.image, b.image) and torch.equal(a.splat_id, b.splat_id)


def test_gut_rows_refuse_ids_past_2_24():
    n = 1 << 24
    proj = dataclasses.make_dataclass("P", ["xy"])(torch.zeros(1, 2).expand(n, 2))
    with pytest.raises(ValueError, match="2\\^24"):
        tp.gut_attr_rows(None, proj, tc.RenderConfig())


def test_gut_train_step_lowers_the_loss():
    """A MESH_3DGUT train_step reaches all six fields through the gut3d
    rows (means, scales and quats directly, color and opacity through the
    UT projection) and lowers the loss; on the CPU it launches nothing."""
    d = scene_arrays(6, 200)
    init = dict(d, sh_dc=d["sh_dc"] + np.random.default_rng(1).normal(
        scale=0.3, size=d["sh_dc"].shape).astype(np.float32),
        means=d["means"] + np.random.default_rng(2).normal(
            scale=0.02, size=d["means"].shape).astype(np.float32))
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=1, pipeline=tc.Pipeline.MESH_3DGUT)
    cam, _ = cameras(64, 48)
    with torch.no_grad():
        target = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg).image
    splats = interop.splat_set_from_numpy(init, "cpu")
    tcfg = tt.TrainConfig(scene_extent=3.0)
    opt = tt.make_optimizer(splats, tcfg)
    before = (tr.rasterize_tiles.launches_gut3d, tr.rasterize_tiles_bwd.launches_gut3d)
    losses = []
    for _ in range(4):
        loss, overflow = tt.train_step(splats, opt, cam, target, cfg, 0, tcfg)
        losses.append(float(loss))
        assert not bool(overflow)
        for f in interop.SPLAT_FIELDS:
            g = getattr(splats, f).grad
            assert torch.isfinite(g).all() and g.abs().max() > 0, f
    assert losses[-1] < losses[0], losses
    assert (tr.rasterize_tiles.launches_gut3d, tr.rasterize_tiles_bwd.launches_gut3d) == before


def test_entry_points_per_model():
    st = tr.RasterStatics(1, 1)
    assert tr.entry_name("rasterize_fwd", st) == "rasterize_fwd"
    gut = dataclasses.replace(st, model="gut3d")
    assert tr.entry_name("raster_bucket_bwd", gut) == "raster_bucket_bwd_gut3d"
    with pytest.raises(NotImplementedError, match="queue 2"):
        tr.entry_name("rasterize_fwd", dataclasses.replace(st, model="tri2d"))
    with pytest.raises(ValueError, match="pixel context"):
        tr.rasterize_tiles(torch.zeros((15, 0)), torch.zeros((0,), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32), gut)
    with pytest.raises(NotImplementedError, match="3DGRT"):
        tp.render_3dgrt_exact(None, None, tc.RenderConfig())


def test_bucket_path_adds_the_tails_beyond_the_ut_rect():
    """The pair path blends a splat only in the tiles of its UT rect, which
    bounds where opacity * response >= 0.01; the bucket path blends every
    candidate of a tile's window, so it also adds a mid or coarse splat's
    tail beyond its rect, where alpha lies between alpha_min (1/255) and
    about 0.01 (the JAX package does the same). At the default alpha_min
    the paths differ by about that much; with the tails cut (alpha_min
    0.02) they agree as the gs2d paths do."""
    d = interop.random_splat_arrays(3, 1200, sh_degree=1, extent=2.5, scale_range=(-4.5, -1.0))
    w, h = 256, 192
    cam = tcam.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device="cpu")
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    worst = []
    for alpha_min in (1 / 255, 0.02):
        outs = [render(prep, cam, tc.RenderConfig(
            width=w, height=h, sh_degree=1, pipeline=tc.Pipeline.MESH_3DGUT,
            raster=tc.RasterConfig(alpha_min=alpha_min, **raster)), max_pairs=1 << 20)
            for raster in (dict(expansion="exact"),
                           dict(method="bucket", bucket_caps=(1024, 1024, 512, 256)))]
        assert not any(bool(o.overflow) for o in outs)
        worst.append((outs[0].image - outs[1].image).abs().max().item())
    assert 1e-3 < worst[0] < 2e-2, worst
    assert worst[1] < 2e-4, worst


# ---- K4g's per-tile cull: the plain predicate --------------------------------

# name: (config keywords by name, camera keywords, rolling shift)
CULL_CAMERAS = {
    "pinhole": ({}, {}, 0.0),
    "fisheye": (dict(camera_type="FISHEYE"), {}, 0.0),
    "rolling": (dict(shutter="ROLLING_TOP_TO_BOTTOM"), {}, 0.4),
    "dof": ({}, dict(focus_dist=8.0, aperture=0.3), 0.0),
}


def cull_inputs(degree, camera, seed=4, n=300, w=W, h=H):
    """A 3DGUT bucket scene of mixed scales (tests/test_gut.py's scene, with
    mid and coarse splats) and its rays under ``camera``, at w x h."""
    cfg_kw, cam_kw, shift = CULL_CAMERAS[camera]
    _, cfg = named_cfgs(dict(cfg_kw, pipeline="MESH_3DGUT", rt=dict(kernel_degree=degree),
                             raster=dict(method="bucket", bucket_caps=(512, 256, 256, 128),
                                         bucket_chunk=128)), width=w, height=h)
    cam, _ = cameras(w, h, shift=shift, **cam_kw)
    d = interop.random_splat_arrays(seed, n, sh_degree=1, extent=3.0, scale_range=(-3.5, -0.5))
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    proj = ut_project_splats(prep, cam, cfg)
    rows, ids = tp.gut_attr_rows(prep, proj, cfg)
    st = tp.gut_statics(tp.raster_statics(cfg), cfg)
    bins = tp.bin_for_cfg(proj, rows.detach(), ids, cfg, 0, st)
    st = dataclasses.replace(st, chunk=cfg.raster.bucket_chunk)
    return bins.attrs, bins.bucket_starts, st, cfg.raster.bucket_caps, trays.build_tile_rays(
        cam, cfg)


def assert_gut_cull_is_exact(attrs, starts, st, caps, pix):
    """``tile_may_hit`` keeps every lane whose alpha passes the cutoffs at
    some pixel of its tile (tests/test_torch_bucket.py's check)."""
    may = rb.tile_may_hit(attrs, starts, st, caps, pix_ctx=pix)
    hit = rb.tile_lane_hits(attrs, starts, st, caps, pix_ctx=pix)
    assert hit.any()
    assert int((hit & ~may).sum()) == 0, "the cull dropped a lane that hits"
    return may, hit


@pytest.mark.parametrize("camera", list(CULL_CAMERAS))
@pytest.mark.parametrize("degree", tresp.KERNEL_DEGREES)
def test_gut3d_cull_is_exact(degree, camera):
    attrs, starts, st, caps, pix = cull_inputs(degree, camera)
    may, hit = assert_gut_cull_is_exact(attrs, starts, st, caps, pix)
    lists = rb._tile_lists(attrs, starts, st, caps, torch.arange(st.tiles_x * st.tiles_y))
    assert 0 < int(may.sum()) <= 0.7 * int((lists.cols >= 0).sum())  # mid, coarse lanes culled
    work = rb.bucket_work(attrs, starts, st, caps, pix_ctx=pix)
    assert work.hits <= work.kept_evals < work.evals and work.kept < work.tested <= work.live


def test_gut3d_cull_on_adversarial_rows():
    """Scales at the 1e-12 floor, opacity at alpha_min and one ulp either
    side, NaN and inf rows, a quaternion off the unit sphere: nothing that
    hits is culled, and the non-finite and floored rows are kept."""
    attrs, starts, st, caps, pix = cull_inputs(2, "rolling")
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    lists = rb._tile_lists(attrs, starts, st, caps, tiles)
    amin = float(np.float32(st.alpha_min))
    nan, inf = float("nan"), float("inf")
    edits = [{13: amin}, {13: float(np.nextafter(np.float32(amin), np.float32(1)))},
             {13: float(np.nextafter(np.float32(amin), np.float32(0)))},
             {3: 1e-12}, {3: 1e-12, 4: 1e-12, 5: 1e-12}, {3: 0.0}, {0: nan}, {13: nan},
             {4: inf}, {9: 2.0}, {5: nan}]
    attrs = attrs.clone()
    picked = torch.unique(lists.cols[lists.cols >= 0])[:len(edits)]
    for col, edit in zip(picked.tolist(), edits):
        for row, value in edit.items():
            attrs[row, col] = value
    may, _ = assert_gut_cull_is_exact(attrs, starts, st, caps, pix)
    at = lists.cols[:, None] == picked[None, :]
    kept = [bool(may[at[:, k]].all()) for k in range(len(edits))]
    assert all(kept[3:9]), kept


@pytest.mark.parametrize("camera", ["pinhole", "fisheye", "rolling"])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_gut3d_culled_sweep_changes_nothing(degree, camera):
    """K3g stages only the lanes the cull keeps: at 128x96 the twin's sweep
    without the culled lanes equals the twin's bit for bit
    (tests/test_torch_bucket.py's check)."""
    attrs, starts, st, caps, pix = cull_inputs(degree, camera, n=2500, w=128, h=96)
    ids = torch.arange(attrs.shape[1], dtype=torch.int32)  # each slot its own id
    culled = assert_culled_sweep_changes_nothing(attrs, ids, starts, st, caps, pix)
    assert culled > 0.3


# ---- K2g's per-tile cull of the pair lists -----------------------------------

def pair_cull_inputs(degree, camera, seed=4, n=1000, w=W, h=H):
    """cull_inputs' scene of mixed scales on the pair path (slots binning):
    (TileBins, statics, rays) at w x h."""
    cfg_kw, cam_kw, shift = CULL_CAMERAS[camera]
    _, cfg = named_cfgs(dict(cfg_kw, pipeline="MESH_3DGUT", rt=dict(kernel_degree=degree)),
                        width=w, height=h)
    cam, _ = cameras(w, h, shift=shift, **cam_kw)
    d = interop.random_splat_arrays(seed, n, sh_degree=1, extent=3.0, scale_range=(-3.5, -0.5))
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    proj = ut_project_splats(prep, cam, cfg)
    rows, ids = tp.gut_attr_rows(prep, proj, cfg)
    st = tp.gut_statics(tp.raster_statics(cfg), cfg)
    return tp.bin_for_cfg(proj, rows.detach(), ids, cfg, 0, st), st, trays.build_tile_rays(cam, cfg)


@pytest.mark.parametrize("camera", ["pinhole", "fisheye", "rolling"])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_gut3d_pair_cull_is_exact(degree, camera):
    bins, st, pix = pair_cull_inputs(degree, camera)
    may, _, live = assert_pair_cull_is_exact(bins, st, pix)
    assert may.sum() < live.sum()  # the UT rects are opacity-bounded: few pairs culled


@pytest.mark.parametrize("camera", ["pinhole", "fisheye", "rolling"])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_gut3d_culled_pair_backward_changes_nothing(degree, camera):
    """The pairs the cull drops change no gradient: the backward twin
    with them taken out equals the full sweep bit for bit, the culled
    columns exactly zero."""
    bins, st, pix = pair_cull_inputs(degree, camera)
    assert assert_culled_backward_changes_nothing(bins, st, pix) > 0.0


# ---- K1g's per-warp cull of the pair lists -----------------------------------

@pytest.mark.parametrize("camera", list(CULL_CAMERAS))
@pytest.mark.parametrize("degree", tresp.KERNEL_DEGREES)
def test_gut3d_pair_warp_cull_is_exact(degree, camera):
    """No (warp, pair) that hits some pixel of the warp is culled, and the
    cone of a warp's 32 rays culls a share of the (warp, pair)s: a fifth or
    more, but with DoF, whose lens spreads the rays' origins, less."""
    bins, st, pix = pair_cull_inputs(degree, camera)
    may, hit = assert_pair_warp_cull_is_exact(bins, st, pix)
    live = int(bins.num_pairs) * tresp.WARPS
    assert int(hit.sum()) <= int(may.sum()) < (1.0 if camera == "dof" else 0.8) * live


@pytest.mark.parametrize("camera", ["pinhole", "fisheye", "rolling"])
@pytest.mark.parametrize("degree", [0, 1, 2])
def test_gut3d_warp_culled_sweep_changes_nothing(degree, camera):
    """K1g's warps skip the (warp, pair)s the cull drops: the forward twin
    without them equals the full twin bit for bit."""
    bins, st, pix = pair_cull_inputs(degree, camera)
    _, culled = assert_warp_culled_sweep_changes_nothing(bins, st, pix)
    assert culled > 0.2


@pytest.mark.parametrize("degree, camera", [(0, "pinhole"), (2, "fisheye"), (5, "rolling"),
                                            (8, "pinhole")])
def test_gut3d_may_hit_tile_answers_unchanged(degree, camera):
    assert_may_hit_unchanged(*pair_cull_inputs(degree, camera))


# ---- the backward twins in float64 -------------------------------------------
#
# Two card cases sit under the elementwise gate of 99.9 % (K4 on the dense
# edge-row scene, K2g at degree 8; tests/test_torch_cuda.py
# test_low_gradient_cases_against_float64). The twins run in their input's
# dtype, so float64 gives the exact function's gradients: checked here
# against jax.grad at x64 of each tile's front-to-back blend with the JAX
# package's alpha model (1e-9 of each row's max; the two differ only in the
# order of their float64 sums), on scenes where no pixel's T falls to
# min_transmittance, so that no step freezes and the blend is the whole
# list's. Then the finding: on the two cases' own scenes the f32 twin
# itself leaves values of the opacity row beyond the elementwise limit of
# float64 (all within 1e-4 of each row's max), as the kernels do on the
# card: the divergence is f32's, not the kernels'.


def jax_blend_grad(attrs64, lists, st, pix, g):
    """jax.grad at x64 of sum(g_rgb . rgb) + sum(g_T T) over the tiles of
    ``lists`` ((tile, attribute columns front to back), ...), each blended
    without a freeze by the JAX package's alpha of ``st.model``; ``g`` the
    (T, 5, 256) cotangent."""
    sj = jr.RasterStatics(**dataclasses.asdict(st))
    alpha_fn = jresp.ALPHA_FNS[st.model]
    tiles = torch.tensor([t for t, _ in lists])
    px, py = (c.numpy() for c in tr._tile_pixel_coords(tiles, st.tiles_x, torch.float64))
    with jax.enable_x64(True):
        def loss(a):
            total = 0.0
            for b, (t, cols) in enumerate(lists):
                blk = a[:, cols]
                p = None if pix is None else jnp.asarray(pix[t].T.numpy(), jnp.float64)
                alpha = alpha_fn(blk, p, px[b], py[b], jnp.ones((1, len(cols)), bool), sj)
                q = 1.0 - alpha
                excl = jnp.concatenate([jnp.ones_like(q[:, :1]), jnp.cumprod(q, axis=1)[:, :-1]],
                                       axis=1)
                rgb = (alpha * excl) @ blk[tresp.ATTR_R:tresp.ATTR_B + 1].T
                total = total + jnp.sum(g[t, 0:3].T * rgb) + jnp.sum(g[t, 3] * jnp.prod(q, 1))
            return total

        return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(attrs64.numpy())))


def float64_case(name):
    """(twin's float64 d_attrs, jax.grad's, gradient rows, min T) of a
    sparse gs2d bucket scene or a sparse gut3d pair scene at degree 8."""
    g = np.random.default_rng(11).normal(size=(12, 5, 256))
    if name == "bucket_gs2d":
        bins, st, caps = small_bins(n=150, seed=4, scale_range=(-5.0, -1.0))
        a64, pix = bins.attrs.double(), None
        lists = rb._tile_lists(a64, bins.bucket_starts, st, caps,
                               torch.arange(st.tiles_x * st.tiles_y))
        per_tile = lists.cols.view(st.tiles_x * st.tiles_y, -1)
        cols = [(t, c[c >= 0].numpy()) for t, c in enumerate(per_tile)]
        out, _ = rb.rasterize_buckets_ref(a64, bins.ids, bins.bucket_starts, st, caps)
        d = rb.rasterize_buckets_bwd_ref(a64, bins.bucket_starts,
                                         tr.bwd_context(out, torch.from_numpy(g)), st, caps)
        rows = tr.GRAD_ROWS
    else:
        bins, st, _, pix = gut_bins("pairs", n=60, degree=8)
        a64, pix = bins.attrs.double(), pix.double()
        args = (bins.tile_start, bins.tile_count)
        cols = [(t, np.arange(int(s), int(s) + int(n))) for t, (s, n) in
                enumerate(zip(*args)) if int(n) > 0]
        out, _ = tr.rasterize_tiles_ref(a64, bins.pair_id, *args, st, pix_ctx=pix)
        d = tr.rasterize_tiles_bwd_ref(a64, *args, tr.bwd_context(out, torch.from_numpy(g)), st,
                                       pix_ctx=pix)
        rows = tresp.MODELS["gut3d"].grad_rows
    assert out.shape[0] == g.shape[0] and d.dtype == torch.float64
    cols = [(t, c) for t, c in cols if len(c)]
    return d.numpy(), jax_blend_grad(a64, cols, st, pix, g), rows, out[:, 3].min().item()


@pytest.mark.parametrize("name", ["bucket_gs2d", "pairs_gut3d"])
def test_float64_twin_backward_matches_jax_x64(name):
    d_twin, d_jax, rows, t_min = float64_case(name)
    assert t_min > tr.RasterStatics(1, 1).min_transmittance  # no step freezes
    for r in range(rows):
        scale = np.abs(d_jax[r]).max()
        assert scale > 0, r
        assert np.abs(d_twin[r] - d_jax[r]).max() <= 1e-9 * scale, r


@pytest.mark.parametrize("name", ["k4_dense", "k2g_deg8"])
def test_f32_twin_backward_against_float64(name):
    _, bins, st, caps, pix, rows, opacity = low_case(torch.device("cpu"), name)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(st.tiles_x * st.tiles_y, 5, 256)).astype(np.float32))
    out, _ = (rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, caps)
              if pix is None else tr.rasterize_tiles_ref(bins.attrs, bins.pair_id,
                                                         bins.tile_start, bins.tile_count, st,
                                                         pix_ctx=pix))
    ctx = tr.bwd_context(out, g)
    d32 = (rb.rasterize_buckets_bwd_ref(bins.attrs, bins.bucket_starts, ctx, st, caps)
           if pix is None else tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start,
                                                          bins.tile_count, ctx, st,
                                                          pix_ctx=pix)).double()
    d64 = float64_twin_bwd(bins, st, caps, pix, g)
    for r in range(rows):
        assert (d32[r] - d64[r]).abs().max().item() <= 1e-4 * d64[r].abs().max().item(), r
    assert elementwise_share(d32[opacity], d64[opacity]) < 1.0
