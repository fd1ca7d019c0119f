"""render_3dgs end to end: the PyTorch port (its CPU twin of the blender)
against the JAX package (interpret-mode kernel), plus the golden gate, the
probes (empty scene, a size not a multiple of 16, a tiny slot budget) and
what the port must refuse.

Tolerances as tests/test_torch_rasterize.py: image and transmittance 5e-5
max abs; picked depth 1e-5 where both picked the same splat; picked id
equal on at least 99.9% of pixels; num_pairs and overflow exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.render import render, render_3dgs
from vk_gaussian_splatting_tpu_torch.io import load_ply

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "assets", "golden")
IMG_ATOL = 5e-5
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999

# name: (scene seed, n, scale_range, render kw, raster kw, max_pairs, overflow)
CASES = {
    "default": (0, 2500, (-3.5, -1.5), {}, {}, 0, False),
    "exact": (0, 2500, (-3.5, -1.5), {}, dict(expansion="exact"), 1 << 16, False),
    "odd_size_background": (1, 1500, (-3.5, -1.5),
                            dict(width=120, height=90, background=(0.1, 0.2, 0.3)),
                            {}, 0, False),
    "tiny_slots_overflow": (2, 600, (-2.0, -0.5), {}, dict(slots_k=4), 0, True),
    "empty_behind_camera": (3, 500, (-3.5, -1.5), {}, {}, 0, False),
}


def render_both(name):
    seed, n, scale_range, kw, raster_kw, max_pairs, _ = CASES[name]
    base = {**dict(width=128, height=96, sh_degree=1), **kw}
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)
    if name == "empty_behind_camera":
        d["means"][:, 2] = -20.0 - np.abs(d["means"][:, 2])
    cam_t = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], base["width"],
                       base["height"], fov_y_rad=0.9)
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))
    cj = jc.RenderConfig(**base, raster=jc.RasterConfig(**raster_kw))
    ct = tc.RenderConfig(**base, raster=tc.RasterConfig(**raster_kw))
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
    oj = j_render(sj.prepare(), cam_j, cj, max_pairs=max_pairs)
    ot = render(interop.splat_set_from_numpy(d).prepare(), cam_t, ct,
                   max_pairs=max_pairs)
    return oj, ot


@pytest.mark.parametrize("name", list(CASES))
def test_render_matches_jax(name):
    oj, ot = render_both(name)
    assert bool(oj.overflow) == bool(ot.overflow) == CASES[name][-1]
    assert int(oj.num_pairs) == int(ot.num_pairs)
    img_j, img_t = np.asarray(oj.image), ot.image.numpy()
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(ot.transmittance.numpy(), np.asarray(oj.transmittance),
                               rtol=0, atol=IMG_ATOL)
    id_j, id_t = np.asarray(oj.splat_id), ot.splat_id.numpy()
    assert id_t.dtype == np.int32
    same = id_j == id_t
    assert same.mean() >= ID_AGREE, same.mean()
    both = same & (id_j >= 0)
    np.testing.assert_allclose(ot.depth.numpy()[both], np.asarray(oj.depth)[both],
                               rtol=0, atol=DEPTH_ATOL)
    if name == "empty_behind_camera":
        assert int(ot.num_pairs) == 0
        assert (ot.transmittance == 1).all() and (ot.splat_id == -1).all()
        assert (ot.image == 0).all()
    elif name == "odd_size_background":
        assert img_t.shape == (90, 120, 3)
        uncovered = ot.transmittance.numpy() == 1
        assert uncovered.any()
        np.testing.assert_array_equal(img_t[uncovered],
                                      np.broadcast_to([0.1, 0.2, 0.3], img_t[uncovered].shape)
                                      .astype(np.float32))
    else:
        assert float(ot.transmittance.min()) < 0.5  # the scene covers pixels


def test_golden_gate_on_cpu_twin():
    splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"))
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9)
    ref = np.load(os.path.join(GOLDEN, "golden_view0.npy")).astype(np.float32)
    out = render(splats.prepare(), cam, cfg)
    img = np.clip(out.image.numpy(), 0, 1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((img - ref) ** 2)), 1e-12))
    assert psnr > 45, psnr


def test_repeat_render_is_bit_equal():
    d = interop.random_splat_arrays(5, 800, sh_degree=1, scale_range=(-3.5, -1.5))
    prep = interop.splat_set_from_numpy(d).prepare()
    cfg = gt.RenderConfig(width=64, height=48, sh_degree=1)
    cam = gt.look_at([0, 0, -9.0], [0, 0, 0], [0, 1, 0], 64, 48, fov_y_rad=0.9)
    a, b = render(prep, cam, cfg), render(prep, cam, cfg)
    for f in ("image", "transmittance", "depth", "splat_id"):
        assert torch.equal(getattr(a, f), getattr(b, f))


UNPORTED = {
    "bucket": dict(raster=tc.RasterConfig(method="bucket")),
    "stochastic": dict(stochastic=tc.StochasticMode.SPLAT),
    "temporal": dict(temporal_samples=2),
    "packed": dict(raster=tc.RasterConfig(pair_format="packed")),
    "atrous": dict(denoise="atrous"),
    "fisheye": dict(camera_type=tc.CameraType.FISHEYE),
    "rtx": dict(pipeline=tc.Pipeline.RTX),
    "gut": dict(pipeline=tc.Pipeline.MESH_3DGUT),
    "hybrid": dict(pipeline=tc.Pipeline.HYBRID),
    "hybrid_gut": dict(pipeline=tc.Pipeline.HYBRID_3DGUT),
}


@pytest.fixture(scope="module")
def tiny():
    d = interop.random_splat_arrays(6, 50, sh_degree=0)
    cam = gt.look_at([0, 0, -9.0], [0, 0, 0], [0, 1, 0], 32, 32)
    return interop.splat_set_from_numpy(d).prepare(), cam


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_config_raises(tiny, name):
    prep, cam = tiny
    cfg = tc.RenderConfig(width=32, height=32, **UNPORTED[name])
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        render(prep, cam, cfg)


def test_host_order_raises(tiny):
    prep, cam = tiny
    with pytest.raises(NotImplementedError, match="host_order"):
        render_3dgs(prep, cam, tc.RenderConfig(width=32, height=32),
                       host_order=torch.arange(50))


@pytest.mark.parametrize("raster", [dict(tile_size=8), dict(method="cells"),
                                    dict(expansion="dense")])
def test_invalid_config_raises(tiny, raster):
    prep, cam = tiny
    cfg = tc.RenderConfig(width=32, height=32,
                          raster=dataclasses.replace(tc.RasterConfig(), **raster))
    with pytest.raises(ValueError):
        render(prep, cam, cfg)


def test_exact_expansion_needs_budget(tiny):
    prep, cam = tiny
    cfg = tc.RenderConfig(width=32, height=32,
                          raster=tc.RasterConfig(expansion="exact"))
    with pytest.raises(ValueError, match="max_pairs"):
        render(prep, cam, cfg)


def test_package_never_imports_jax():
    code = ("import sys, pkgutil, importlib, vk_gaussian_splatting_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'vk_gaussian_splatting_tpu.'))"
            " or m == 'vk_gaussian_splatting_tpu']\n"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
