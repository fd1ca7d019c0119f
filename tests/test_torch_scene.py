"""Scene model, cameras and PLY loading: the PyTorch port against the JAX package.

Tolerance: 1e-6 relative, to the scale of each row: its largest entry, and
for a packed covariance its trace (the sum of its eigenvalues), since
off-diagonal terms cancel towards 0, where an elementwise relative error
means nothing. XLA on the CPU contracts multiply-adds into FMAs and rounds
exp differently in the last ulp, so the packages are not bit-equal; each is
within 9e-7 (trace-relative) of a float64 evaluation of the covariance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_gaussian_splatting_tpu.config import ShFormat as JShFormat
from vk_gaussian_splatting_tpu.io.ply import load_ply as j_load_ply
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.config import ShFormat
from vk_gaussian_splatting_tpu_torch.io import load_ply, load_scene
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam
from vk_gaussian_splatting_tpu_torch.scene import splat_set as tss

torch.set_num_threads(2)

GOLDEN_PLY = os.path.join(os.path.dirname(__file__), "..", "assets", "golden",
                          "golden_scene.ply")
RTOL = 1e-6


def assert_rows_close(a, b, rtol=RTOL, scale=None):
    """|a - b| <= rtol * scale, row by row; scale defaults to the row's
    largest |a|."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    if scale is None:
        scale = np.abs(a).max(axis=1, keepdims=True)
    err = (np.abs(a - b) / np.maximum(scale, 1e-30)).max()
    assert err <= rtol, err


def assert_cov_close(a, b):
    """Packed (xx, xy, xz, yy, yz, zz) covariances, to their trace."""
    a = np.asarray(a, np.float64)
    assert_rows_close(a, b, scale=a[:, [0, 3, 5]].sum(axis=1, keepdims=True))


@pytest.fixture(scope="module")
def arrays():
    return interop.random_splat_arrays(7, 2000, sh_degree=3,
                                       scale_range=(-4.0, -1.0))


def to_jax(d):
    return jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("fmt", ["FLOAT32", "FLOAT16", "UINT8"])
def test_prepared_splats_match(arrays, fmt):
    pj = jax.jit(lambda s: s.prepare(JShFormat[fmt]))(to_jax(arrays))
    pt = interop.splat_set_from_numpy(arrays).prepare(ShFormat[fmt])
    assert_cov_close(pj.cov3d, pt.cov3d.numpy())
    for f in ("means", "color", "scales_log", "quats"):
        assert_rows_close(getattr(pj, f), getattr(pt, f).numpy())
    sh_j, sh_t = np.asarray(pj.sh), pt.sh.numpy()
    assert sh_j.dtype == sh_t.dtype
    np.testing.assert_array_equal(sh_j, sh_t)
    np.testing.assert_array_equal(np.asarray(jss.dequantize_sh(pj.sh)),
                                  tss.dequantize_sh(pt.sh).numpy())
    assert pt.max_sh_degree == pj.max_sh_degree == 3


def test_covariance_scale_multiplier(arrays):
    j = jss.covariance_from_scale_rot(jnp.asarray(arrays["scales"]),
                                      jnp.asarray(arrays["quats"]), 1.7)
    t = tss.covariance_from_scale_rot(torch.from_numpy(arrays["scales"]),
                                      torch.from_numpy(arrays["quats"]), 1.7)
    assert_cov_close(j, t.numpy())


@pytest.mark.parametrize("src,dst", [("RDF", "RUB"), ("RUB", "LUF"), ("RUF", "RDB")])
def test_convert_coordinates_match(arrays, src, dst):
    j = to_jax(arrays).convert_coordinates(jss.CoordinateSystem[src],
                                           jss.CoordinateSystem[dst])
    t = interop.splat_set_from_numpy(arrays).convert_coordinates(
        tss.CoordinateSystem[src], tss.CoordinateSystem[dst])
    for k, v in interop.splat_set_to_numpy(t).items():
        np.testing.assert_array_equal(np.asarray(getattr(j, k)), v)
    for a, b in zip(jss.coordinate_flips(jss.CoordinateSystem[src], jss.CoordinateSystem[dst]),
                    tss.coordinate_flips(tss.CoordinateSystem[src], tss.CoordinateSystem[dst])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("eye,w,h,fov", [([0.3, -0.5, -10.0], 128, 96, 0.9),
                                         ([2.0, 1.0, 5.0], 1920, 1080, 0.6)])
def test_camera_matches(eye, w, h, fov):
    cj = jcam.look_at(eye, [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=fov)
    ct = tcam.look_at(eye, [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=fov)
    for k, v in interop.camera_to_numpy(ct).items():
        np.testing.assert_array_equal(np.asarray(getattr(cj, k)), v)
    np.testing.assert_allclose(ct.position.numpy(), np.asarray(cj.position),
                               rtol=RTOL, atol=1e-6)
    # the round trip through interop feeds the JAX constructor the same numbers
    cj2 = jcam.make_camera(**interop.camera_to_numpy(ct))
    np.testing.assert_array_equal(np.asarray(cj2.viewmat), np.asarray(cj.viewmat))
    assert interop.camera_from_numpy(interop.camera_to_numpy(ct)).fx == ct.fx


def test_view_transform_matches(arrays):
    ct = tcam.look_at([0.3, -0.5, -10.0], [0, 0, 0], [0, 1, 0], 64, 48)
    cj = jcam.make_camera(**interop.camera_to_numpy(ct))
    pj = jax.jit(jcam.view_transform_points)(cj.viewmat, jnp.asarray(arrays["means"]))
    pt = tcam.view_transform_points(ct.viewmat, torch.from_numpy(arrays["means"]))
    assert_rows_close(pj, pt.numpy())


def test_load_ply_matches():
    j = j_load_ply(GOLDEN_PLY)
    t = load_scene(GOLDEN_PLY)
    for k, v in interop.splat_set_to_numpy(t).items():
        np.testing.assert_array_equal(np.asarray(getattr(j, k)), v)
    assert t.num_splats == 27627 and t.max_sh_degree == j.max_sh_degree
    raw = load_ply(GOLDEN_PLY, to_rub=False)
    np.testing.assert_array_equal(raw.means[:, 1:].numpy(), -t.means[:, 1:].numpy())


def test_load_scene_rejects_unported_formats(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_scene(str(tmp_path / "scene.spz"))
    with pytest.raises(ValueError):
        load_scene(str(tmp_path / "scene.xyz"))


def test_random_splats_seeded_and_shaped():
    a = tss.random_splats(torch.Generator().manual_seed(3), 500, sh_degree=2)
    b = tss.random_splats(torch.Generator().manual_seed(3), 500, sh_degree=2)
    for k, v in interop.splat_set_to_numpy(a).items():
        np.testing.assert_array_equal(v, getattr(b, k).numpy())
        assert v.dtype == np.float32 and v.shape[0] == 500
    assert a.sh_rest.shape == (500, 8, 3) and a.max_sh_degree == 2
    assert float(a.means.abs().max()) <= 3.0
    assert -5.0 <= float(a.scales.min()) and float(a.scales.max()) <= -3.0
    assert tss.random_splats(torch.Generator(), 4, sh_degree=0).sh_rest.shape == (4, 0, 3)
