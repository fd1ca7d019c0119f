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
