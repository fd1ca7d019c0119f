"""EWA projection and SH: the PyTorch port against the JAX package.

Tolerance: every float field of ProjectedSplats to 1e-5 relative to the
scale of its row (the row's largest entry; for the conic, the Frobenius norm
of the 2x2 matrix it packs, whose off-diagonal term cancels towards 0);
``valid`` and ``radius`` exactly. Both packages run the same f32 column
arithmetic, but XLA on the CPU contracts some multiply-adds into FMAs, and
the conic's determinant amplifies those last-ulp differences: against a
float64 evaluation of the default case, the port's conic is within 3.1e-6
and the JAX package's within 7.1e-6 (row-max relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import projection as jproj
from vk_gaussian_splatting_tpu.ops import sh as jsh
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import projection as tproj
from vk_gaussian_splatting_tpu_torch.ops import sh as tsh
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam

torch.set_num_threads(2)

RTOL = 1e-5
FIELDS = ("xy", "conic", "depth", "color", "alpha")

# (render kw, raster kw, sh format) — each case is one small jit on the JAX side
CASES = {
    "default_sh3": ({}, {}, "FLOAT32"),
    "sh0": (dict(sh_degree=0), {}, "FLOAT32"),
    "ms_aa_size_cull": ({}, dict(ms_antialiasing=True, size_culling=True,
                                 size_culling_min_px=3.0), "FLOAT32"),
    "point_cloud_scaled": (dict(splat_scale=1.5, opacity_gain=0.6),
                           dict(point_cloud_mode=True), "FLOAT32"),
    "sh_only_uint8": (dict(show_sh_only=True, sh_degree=2), {}, "UINT8"),
    "fp16_dilated": ({}, dict(dilation=0.8, frustum_dilation=0.05), "FLOAT16"),
}


@pytest.fixture(scope="module")
def scene():
    d = interop.random_splat_arrays(11, 3000, sh_degree=3, extent=4.0,
                                    scale_range=(-4.0, -1.0))
    cam_t = tcam.look_at([0.3, -0.5, -9.0], [0, 0, 0], [0, 1, 0], 128, 96,
                         fov_y_rad=0.9, device="cpu")
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))
    return d, cam_t, cam_j


def cfgs(name):
    kw, raster_kw, fmt = CASES[name]
    base = dict(width=128, height=96, **kw)
    return (jc.RenderConfig(**base, raster=jc.RasterConfig(**raster_kw)),
            tc.RenderConfig(**base, raster=tc.RasterConfig(**raster_kw)), fmt)


def assert_rows_close(a, b, rtol=RTOL, scale=None):
    """|a - b| <= rtol * scale, row by row; scale defaults to the row's
    largest |a|."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    if scale is None:
        scale = np.abs(a).max(axis=1, keepdims=True)
    err = (np.abs(a - b) / np.maximum(scale, 1e-30)).max()
    assert err <= rtol, err


def conic_norm(c):
    """Frobenius norm of the symmetric 2x2 matrices packed as (a, b, c)."""
    c = np.asarray(c, np.float64)
    return np.sqrt(c[:, 0:1] ** 2 + 2 * c[:, 1:2] ** 2 + c[:, 2:3] ** 2)


@pytest.mark.parametrize("name", list(CASES))
def test_project_splats_matches(scene, name):
    d, cam_t, cam_j = scene
    cj, ct, fmt = cfgs(name)
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
    pj = jax.jit(lambda s, c: jproj.project_splats(
        s.prepare(jc.ShFormat[fmt]), c, cj))(sj, cam_j)
    pt = tproj.project_splats(
        interop.splat_set_from_numpy(d, "cpu").prepare(tc.ShFormat[fmt]), cam_t, ct)
    valid = np.asarray(pj.valid)
    np.testing.assert_array_equal(valid, pt.valid.numpy())
    np.testing.assert_array_equal(np.asarray(pj.radius), pt.radius.numpy())
    assert 100 < valid.sum() < len(valid)  # some culled, many kept
    for f in FIELDS:
        a = np.asarray(getattr(pj, f))[valid]
        assert_rows_close(a, getattr(pt, f).numpy()[valid],
                          scale=conic_norm(a) if f == "conic" else None)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_sh_radiance_matches(degree):
    rng = np.random.default_rng(degree)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    coeffs = rng.normal(size=(500, 15, 3)).astype(np.float32)
    bj = np.asarray(jsh.sh_basis(jnp.asarray(dirs), degree))
    bt = tsh.sh_basis(torch.from_numpy(dirs), degree).numpy()
    np.testing.assert_array_equal(bj, bt)
    rj = np.asarray(jsh.eval_sh_radiance(jnp.asarray(coeffs), jnp.asarray(dirs), degree))
    rt = tsh.eval_sh_radiance(torch.from_numpy(coeffs), torch.from_numpy(dirs), degree).numpy()
    np.testing.assert_allclose(rt, rj, rtol=RTOL, atol=1e-6)


def test_sh_degree_clamps_to_stored():
    coeffs = torch.zeros((4, 3, 3))
    dirs = torch.nn.functional.normalize(torch.ones((4, 3)), dim=1)
    assert tsh.eval_sh_radiance(coeffs, dirs, 3).shape == (4, 3)
    assert tsh.eval_sh_radiance(torch.zeros((4, 0, 3)), dirs, 3).abs().sum() == 0


def test_ewa_project_cov_matches(scene):
    d, cam_t, cam_j = scene
    rng = np.random.default_rng(5)
    cov6 = rng.normal(size=(400, 6)).astype(np.float32)
    p_view = np.concatenate([rng.normal(size=(400, 2)),
                             rng.uniform(1, 9, (400, 1))], 1).astype(np.float32)
    args_j = (jnp.asarray(cov6), jnp.asarray(p_view), cam_j.fx, cam_j.fy,
              cam_j.viewmat[:3, :3], 0.7, 0.5)
    args_t = (torch.from_numpy(cov6), torch.from_numpy(p_view), cam_t.fx,
              cam_t.fy, cam_t.viewmat[:3, :3], 0.7, 0.5)
    a = np.asarray(jax.jit(jproj.ewa_project_cov)(*args_j))
    assert_rows_close(a, tproj.ewa_project_cov(*args_t).numpy(), scale=conic_norm(a))


def test_projected_splats_fields():
    names = [f.name for f in dataclasses.fields(tproj.ProjectedSplats)]
    assert names == [f.name for f in dataclasses.fields(jproj.ProjectedSplats)]


# ---------------------------------------------------------------------------
# sh_radiance: the plain version the CPU runs and the closed-form VJP twin of
# the backward kernel (the kernels themselves: tests/test_torch_cuda.py).
# ---------------------------------------------------------------------------

SH_DTYPES = {"f32": torch.float32, "f16": torch.float16, "u8": torch.uint8}
# (stored degree, requested degree, format, show_sh_only)
SH_MIX = [(1, 1, "f32", False), (2, 2, "f16", False), (3, 3, "f32", False),
          (3, 3, "f16", True), (3, 2, "u8", True), (2, 3, "f32", False),
          (3, 1, "f16", False), (1, 3, "u8", False)]


def sh_inputs(stored, fmt, dtype, seed=0, n=300):
    """Splats with a base colour in [-0.3, 1] and SH of spread 0.3, so that
    some of their rgb clamp at 0; leaves that require gradients where the
    format carries one. The SH stays in its format; means, colour and
    position take ``dtype``."""
    rng = np.random.default_rng(seed)
    m = {1: 3, 2: 8, 3: 15}[stored]
    coeffs = torch.from_numpy(rng.normal(0.0, 0.3, size=(n, m, 3)))
    sh = (coeffs.to(SH_DTYPES[fmt]) if fmt != "u8"
          else torch.round((coeffs.clamp(-1.0, 1.0) + 1.0) * 0.5 * 255.0).to(torch.uint8))
    means = torch.from_numpy(rng.uniform(-3.0, 3.0, size=(n, 3))).to(dtype)
    color = torch.from_numpy(rng.uniform(-0.3, 1.0, size=(n, 4))).to(dtype)
    position = torch.tensor([0.3, -0.2, -6.0], dtype=dtype)
    leaves = [t.requires_grad_() for t in (sh, means, color) if t.is_floating_point()]
    return sh, means, color, position, leaves


def vjp_pair(stored, requested, fmt, show, dtype):
    """(autograd through sh_radiance_ref, the closed-form twin), each as
    (d_sh, d_means, d_color) with None where nothing flows."""
    sh, means, color, position, _ = sh_inputs(stored, fmt, dtype)
    rgb = tsh.sh_radiance_ref(sh, means, color, position, requested, show)
    assert (rgb == 0).any() and (rgb > 0).any()  # the clamp's mask matters
    g = torch.from_numpy(np.random.default_rng(1).normal(size=rgb.shape)).to(rgb.dtype)
    wanted = [t for t in (sh, means, color) if t.requires_grad]
    got = torch.autograd.grad(rgb, wanted, g, allow_unused=True)
    auto = dict(zip([id(t) for t in wanted], got))
    auto = tuple(auto.get(id(t)) for t in (sh, means, color))
    twin = tsh.sh_radiance_bwd_ref(sh.detach(), means.detach(), color.detach(), position,
                                   requested, show, g)
    if show:  # no gradient reaches the base colour under show_sh_only
        auto = auto[:2] + (None,)
    return auto, twin


@pytest.mark.parametrize("stored, requested, fmt, show", SH_MIX)
def test_sh_vjp_twin_equals_autograd_float64(stored, requested, fmt, show):
    """Means, colour and cotangent in float64 (the SH in its format, read as
    float32 coefficients by the forward, whose gradient both sides round
    to float32 first): the closed form and autograd differ only by
    rounding, to 1e-12 in each gradient (their magnitudes are below 10
    here)."""
    auto, twin = vjp_pair(stored, requested, fmt, show, torch.float64)
    for name, a, t in zip(("d_sh", "d_means", "d_color"), auto, twin):
        assert (a is None) == (t is None), name
        if a is not None:
            assert a.dtype == t.dtype and a.shape == t.shape, name
            torch.testing.assert_close(t.to(torch.float64), a.to(torch.float64), rtol=0,
                                       atol=1e-12, msg=name)


@pytest.mark.parametrize("stored, requested, fmt, show", SH_MIX)
def test_sh_vjp_twin_equals_autograd_float32(stored, requested, fmt, show):
    """In float32, each gradient to 1e-6 of its largest entry, d_means to
    2e-6 (measured: 2.6e-7 at most): the twin's norm is sqrt(x*x + y*y +
    z*z), the forward's torch.linalg.norm, so the basis may differ in its
    last bit, and the closed form (g - u (u . g)) / n rounds in another
    order than autograd's chain through the norm. A float16 d_sh may round
    one float16 ulp apart (1e-3 of the entry)."""
    auto, twin = vjp_pair(stored, requested, fmt, show, torch.float32)
    for name, a, t in zip(("d_sh", "d_means", "d_color"), auto, twin):
        assert (a is None) == (t is None), name
        if a is not None:
            assert a.dtype == t.dtype and a.shape == t.shape, name
            rel = 1e-3 if a.dtype == torch.float16 else 2e-6 if name == "d_means" else 1e-6
            a, t = a.to(torch.float32), t.to(torch.float32)
            torch.testing.assert_close(t, a, rtol=0, atol=rel * float(a.abs().max()), msg=name)


@pytest.mark.parametrize("fmt", ["FLOAT32", "FLOAT16", "UINT8"])
@pytest.mark.parametrize("show", [False, True])
def test_splat_rgb_on_cpu_is_the_composition_it_had(fmt, show):
    """splat_rgb on CPU tensors: forward and gradients bit for bit those of
    the composition it was before the kernels (dirs, clamped norm,
    eval_sh_radiance over dequantize_sh, base or 0.5, clamp)."""
    from vk_gaussian_splatting_tpu_torch.scene.splat_set import dequantize_sh, random_splats

    g = torch.Generator().manual_seed(4)
    splats = random_splats(g, 400, sh_degree=3)
    splats.sh_rest.mul_(5.0)  # some colours below 0: the clamp matters
    for f in ("means", "sh_dc", "sh_rest"):
        getattr(splats, f).requires_grad_()
    cam = tcam.look_at([0.5, -0.4, -7.0], [0, 0, 0], [0, 1, 0], 64, 48, device="cpu")
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=3, show_sh_only=show)

    def old(prepared):
        rgb = prepared.color[:, :3]
        dirs = prepared.means - cam.position
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-12)
        rad = tsh.eval_sh_radiance(dequantize_sh(prepared.sh), dirs, cfg.sh_degree)
        rgb = torch.full_like(rgb, 0.5) + rad if show else rgb + rad
        return torch.clamp(rgb, min=0.0)

    results = []
    for fn in (old, lambda p: tproj.splat_rgb(p, cam, cfg)):
        prepared = splats.prepare(getattr(tc.ShFormat, fmt))
        rgb = fn(prepared)
        cot = torch.linspace(-1.0, 1.0, rgb.numel()).reshape(rgb.shape)
        leaves = [splats.means, splats.sh_dc] + ([splats.sh_rest] if fmt != "UINT8" else [])
        grads = torch.autograd.grad(rgb, leaves, cot, allow_unused=True)
        results.append((rgb.detach(), grads))
    (rgb_a, grads_a), (rgb_b, grads_b) = results
    assert (rgb_a == 0).any()
    assert torch.equal(rgb_a, rgb_b)
    for a, b in zip(grads_a, grads_b):
        assert (a is None and b is None) or torch.equal(a, b)


def test_sh_radiance_refuses_a_position_that_requires_grad():
    sh, means, color, position, _ = sh_inputs(3, "f32", torch.float32, n=8)
    with pytest.raises(NotImplementedError, match="camera position"):
        tsh.sh_radiance(sh, means, color, position.requires_grad_(), 3)


# ---------------------------------------------------------------------------
# project_splats: the plain version the CPU runs, the closed-form VJP twin of
# csrc/ewa_project.cu's backward and the kernel wrappers' refusals (the
# kernels themselves: tests/test_torch_cuda.py).
# ---------------------------------------------------------------------------

EWA_FLAGS = [(ms, pcm, sc) for ms in (False, True) for pcm in (False, True)
             for sc in (False, True)]


def ewa_scene(dtype, n=600, seed=0):
    """(prepared, camera, leaves) in ``dtype``, 96x64: random splats and, a
    tenth each, splats on the camera plane (|z| < 1e-6, replaced) and just
    off it (z = +-2e-3), splats far outside the frustum (|x/z| beyond the
    Jacobian's clamp), indefinite covariances (det <= 0, a negative
    det_orig / det) and zero ones (det_orig = 0: the Mip-Splatting
    compensation's sqrt at 0, whose gradient autograd makes inf or NaN).
    The leaves (means, cov3d, color) require grad; no SH."""
    from vk_gaussian_splatting_tpu_torch.scene.splat_set import (
        PreparedSplats,
        covariance_from_scale_rot,
    )

    rng = np.random.default_rng(seed)
    cam = tcam.look_at([0.3, -0.5, -6.0], [0, 0, 0], [0, 1, 0], 96, 64, fov_y_rad=0.9,
                       device="cpu")
    cam = dataclasses.replace(cam, **{f.name: getattr(cam, f.name).to(dtype)
                                      for f in dataclasses.fields(cam)})
    vm = cam.viewmat.double().numpy()
    rot, trans = vm[:3, :3], vm[:3, 3]
    k = n // 10
    means = rng.uniform(-3, 3, (n, 3))
    z = rng.choice([0.0, 3e-7, -4e-7, 2e-3, -2e-3], (k, 1))
    means[:k] = (np.concatenate([rng.uniform(-1, 1, (k, 2)), z], 1) - trans) @ rot
    far_x = rng.choice([-1, 1], (k, 1)) * rng.uniform(5, 40, (k, 1))
    means[k:2 * k] = (np.concatenate([far_x, rng.uniform(-1, 1, (k, 1)),
                                      rng.uniform(0.5, 4, (k, 1))], 1) - trans) @ rot
    scales = torch.from_numpy(rng.uniform(-4, -0.5, (n, 3)))
    quats = torch.from_numpy(rng.normal(size=(n, 4)))
    cov = covariance_from_scale_rot(scales.float(), quats.float(), 1.0).double().numpy()
    cov[2 * k:3 * k] = rng.normal(0, 0.3, (k, 6))
    cov[3 * k:3 * k + k // 2] = 0.0
    color = rng.uniform(0, 1, (n, 4))
    color[:, 3] = rng.uniform(1e-3, 1, n)
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (means, cov, color)]
    prep = PreparedSplats(means=leaves[0], cov3d=leaves[1], color=leaves[2],
                          sh=torch.zeros((n, 0, 3), dtype=dtype), scales_log=scales.to(dtype),
                          quats=quats.to(dtype))
    return prep, cam, leaves


def ewa_cfg(ms, pcm, sc):
    return tc.RenderConfig(width=96, height=64, sh_degree=0, raster=tc.RasterConfig(
        ms_antialiasing=ms, point_cloud_mode=pcm, size_culling=sc, size_culling_min_px=2.0))


def ewa_vjp_pair(dtype, ms, pcm, sc):
    """(autograd through project_splats_ref, the closed-form twin), each as
    (d_means, d_cov3d, d_color), for random cotangents of xy, conic, depth
    and alpha on every splat."""
    prep, cam, leaves = ewa_scene(dtype)
    cfg = ewa_cfg(ms, pcm, sc)
    out = tproj.project_splats_ref(prep, cam, cfg)
    p = tcam.view_transform_points(cam.viewmat, prep.means.detach())
    cov2d = tproj.ewa_project_cov(prep.cov3d.detach(), p, cam.fx, cam.fy, cam.viewmat[:3, :3],
                                  0.5 * cfg.width / cam.fx, 0.5 * cfg.height / cam.fy)
    dil = cfg.raster.dilation
    a, b, c = cov2d[:, 0] + dil, cov2d[:, 1], cov2d[:, 2] + dil
    tan_x = 0.5 * cfg.width / cam.fx
    assert (p[:, 2].abs() < 1e-6).any()  # the z replacement bites
    assert ((p[:, 0] / p[:, 2]).abs() > 1.3 * tan_x).any()  # the Jacobian's clamp bites
    assert (a * c - b * b <= 0).any() and (out.valid.sum() > 100)
    g = torch.Generator().manual_seed(1)
    cots = [torch.randn(t.shape, generator=g, dtype=torch.float64).to(dtype)
            for t in (out.xy, out.conic, out.depth, out.alpha)]
    auto = torch.autograd.grad([out.xy, out.conic, out.depth, out.alpha], leaves, cots)
    twin = tproj.project_splats_bwd_ref(*[t.detach() for t in leaves], cam, cfg, *cots)
    return auto, twin


def assert_grads_close(auto, twin, rel):
    """Each gradient within ``rel`` of its leaf's norm (over its finite
    entries); inf and NaN where autograd has them (the zero covariances
    under Mip-Splatting), and the colour's columns 0-2 zero."""
    for name, a, t in zip(("d_means", "d_cov3d", "d_color"), auto, twin):
        assert a.dtype == t.dtype and a.shape == t.shape, name
        finite = torch.isfinite(a)
        scale = float(a[finite].norm())
        torch.testing.assert_close(t, a, rtol=0, atol=rel * scale, equal_nan=True, msg=name)
    assert (twin[2][:, :3] == 0).all()


@pytest.mark.parametrize("ms, pcm, sc", EWA_FLAGS)
def test_ewa_vjp_twin_equals_autograd_float64(ms, pcm, sc):
    """In float64 the closed form and autograd differ only by rounding: each
    gradient to 1e-12 of its leaf's norm (measured: 2.3e-16 at most)."""
    auto, twin = ewa_vjp_pair(torch.float64, ms, pcm, sc)
    assert_grads_close(auto, twin, 1e-12)
    assert ms == (not bool(torch.isfinite(auto[1]).all()))  # sqrt(0)'s gradient only with MS


@pytest.mark.parametrize("ms, pcm, sc", EWA_FLAGS)
def test_ewa_vjp_twin_equals_autograd_float32(ms, pcm, sc):
    """In float32, each gradient to 1e-6 of its leaf's norm (measured:
    1.4e-7 at most): the closed form sums the chain rule's terms in
    another order than autograd's graph."""
    auto, twin = ewa_vjp_pair(torch.float32, ms, pcm, sc)
    assert_grads_close(auto, twin, 1e-6)


def test_ewa_vjp_twin_with_absent_cotangents():
    """A cotangent left out counts as zero; with none for alpha, nothing
    flows through the Mip-Splatting compensation (no NaN from the zero
    covariances), as autograd gives it when alpha is not used."""
    prep, cam, leaves = ewa_scene(torch.float64)
    cfg = ewa_cfg(True, False, False)
    out = tproj.project_splats_ref(prep, cam, cfg)
    g = torch.Generator().manual_seed(2)
    d_xy = torch.randn(out.xy.shape, generator=g, dtype=torch.float64)
    d_conic = torch.randn(out.conic.shape, generator=g, dtype=torch.float64)
    auto = torch.autograd.grad([out.xy, out.conic], leaves, [d_xy, d_conic], allow_unused=True)
    twin = tproj.project_splats_bwd_ref(*[t.detach() for t in leaves], cam, cfg, d_xy, d_conic)
    assert auto[2] is None and (twin[2] == 0).all()
    for a, t in zip(auto[:2], twin[:2]):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(t, a, rtol=0, atol=1e-12 * float(a.norm()))


@pytest.mark.parametrize("field", list(tproj.CAMERA_FIELDS))
def test_project_splats_refuses_a_camera_that_requires_grad(field):
    prep, cam, _ = ewa_scene(torch.float32, n=40)
    cam = dataclasses.replace(cam, **{field: getattr(cam, field).clone().requires_grad_()})
    with pytest.raises(NotImplementedError, match="camera"):
        tproj.project_splats(prep, cam, ewa_cfg(False, False, False))


def ewa_wrapper_inputs(n=40):
    prep, cam, _ = ewa_scene(torch.float32, n=n)
    return ([t.detach() for t in (prep.means, prep.cov3d, prep.color, prep.scales_log)], cam,
            ewa_cfg(False, False, True))


@pytest.mark.parametrize("what, err, match", [
    ("means_f64", TypeError, "means of dtype"),
    ("cov3d_shape", ValueError, "cov3d of shape"),
    ("color_shape", ValueError, "color of shape"),
    ("viewmat_shape", ValueError, "viewmat of shape"),
    ("fx_f64", TypeError, "fx of dtype"),
    ("near_shape", ValueError, "near of shape"),
    ("scales_shape", ValueError, "scales_log"),
    ("on_cpu", ValueError, "CUDA device"),
])
def test_ewa_project_refuses_bad_inputs(what, err, match):
    """The forward wrapper checks dtypes, shapes and the device before any
    launch, so the refusals show without a card."""
    (means, cov3d, color, scales), cam, cfg = ewa_wrapper_inputs()
    if what == "means_f64":
        means = means.double()
    elif what == "cov3d_shape":
        cov3d = cov3d[:, :5]
    elif what == "color_shape":
        color = color[:-1]
    elif what == "viewmat_shape":
        cam = dataclasses.replace(cam, viewmat=cam.viewmat[:3])
    elif what == "fx_f64":
        cam = dataclasses.replace(cam, fx=cam.fx.double())
    elif what == "near_shape":
        cam = dataclasses.replace(cam, near=cam.near[None])
    elif what == "scales_shape":
        scales = scales[:, :2]
    with pytest.raises(err, match=match):
        tproj.ewa_project(means, cov3d, color, scales, cam, cfg)


@pytest.mark.parametrize("what, match", [("d_xy", "d_xy"), ("d_conic", "d_conic"),
                                         ("d_depth", "d_depth"), ("d_alpha", "d_alpha"),
                                         ("none", "CUDA device")])
def test_ewa_project_bwd_refuses_bad_cotangents(what, match):
    (means, cov3d, color, _), cam, cfg = ewa_wrapper_inputs()
    n = means.shape[0]
    cots = dict(d_xy=torch.zeros((n, 2)), d_conic=torch.zeros((n, 3)), d_depth=torch.zeros(n),
                d_alpha=torch.zeros(n))
    if what != "none":
        cots[what] = cots[what][:-1]
    with pytest.raises(ValueError, match=match):
        tproj.ewa_project_bwd(means, cov3d, color, cam, cfg, **cots)


@pytest.mark.parametrize("ms, pcm, sc", [(False, False, False), (True, True, True)])
def test_project_splats_on_cpu_takes_the_plain_path(ms, pcm, sc):
    """CPU tensors: project_splats is project_splats_ref, forward and
    gradients bit for bit, and no kernel is launched."""
    launches = (tproj.ewa_project.launches, tproj.ewa_project_bwd.launches)
    results = []
    for fn in (tproj.project_splats, tproj.project_splats_ref):
        prep, cam, leaves = ewa_scene(torch.float32)
        out = fn(prep, cam, ewa_cfg(ms, pcm, sc))
        g = torch.Generator().manual_seed(3)
        fields = [out.xy, out.conic, out.depth, out.alpha]
        cots = [torch.randn(t.shape, generator=g) for t in fields]
        grads = torch.autograd.grad(fields, leaves, cots)
        results.append([getattr(out, f.name).detach() for f in dataclasses.fields(out)]
                       + list(grads))
    for a, b in zip(*results):
        assert torch.equal(a, b) or (torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a[~a.isnan()], b[~b.isnan()]))
    assert (tproj.ewa_project.launches, tproj.ewa_project_bwd.launches) == launches
