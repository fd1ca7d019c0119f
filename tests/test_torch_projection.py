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
                         fov_y_rad=0.9)
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
        interop.splat_set_from_numpy(d).prepare(tc.ShFormat[fmt]), cam_t, ct)
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
