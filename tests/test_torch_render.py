"""render_3dgs end to end: the PyTorch port (its CPU twin of the blender)
against the JAX package (interpret-mode kernel), plus the golden gate, the
probes (empty scene, a size not a multiple of 16, a tiny slot budget) and
the configs earlier slices of the port refused, through ``render``.

Tolerances as tests/test_torch_rasterize.py: image and transmittance 5e-5
abs, on at least 99.9 % of channels and none beyond 1.2e-2 (the flip-aware
gate of tests/test_torch_gut.py: a cutoff that the two packages' roundings
put on opposite sides drops one splat's contribution at a few pixels, as one
of three full runs under xdist saw on the "default" case, 21 of 36,864
channels up to 0.0099; the port's frame is the same at 1-8 torch threads
and the JAX frame at 1-8 cores, so the source is not proven yet); picked depth 1e-5 where both picked the
same splat; picked id equal on at least 99.9% of pixels; num_pairs and
overflow exactly.
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
from vk_gaussian_splatting_tpu.render.pipelines import render as j_dispatch
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgrt as j_grt
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgut as j_gut
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import lights as jl
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.render import render, render_3dgs
from vk_gaussian_splatting_tpu_torch.io import load_ply

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "assets", "golden")
IMG_ATOL, IMG_SHARE, IMG_MAX = 5e-5, 0.999, 1.2e-2
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
                       base["height"], fov_y_rad=0.9, device="cpu")
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))
    cj = jc.RenderConfig(**base, raster=jc.RasterConfig(**raster_kw))
    ct = tc.RenderConfig(**base, raster=tc.RasterConfig(**raster_kw))
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
    oj = j_render(sj.prepare(), cam_j, cj, max_pairs=max_pairs)
    ot = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t, ct,
                   max_pairs=max_pairs)
    return oj, ot


@pytest.mark.parametrize("name", list(CASES))
def test_render_matches_jax(name):
    oj, ot = render_both(name)
    assert bool(oj.overflow) == bool(ot.overflow) == CASES[name][-1]
    assert int(oj.num_pairs) == int(ot.num_pairs)
    img_j, img_t = np.asarray(oj.image), ot.image.numpy()
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    for a, b in ((img_t, img_j), (ot.transmittance.numpy(), np.asarray(oj.transmittance))):
        diff = np.abs(a - b)
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE, (diff > IMG_ATOL).sum()
        assert diff.max() <= IMG_MAX, diff.max()
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
    splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device="cpu")
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    w, h = meta["recipe"]["res"]
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                     device="cpu")
    ref = np.load(os.path.join(GOLDEN, "golden_view0.npy")).astype(np.float32)
    out = render(splats.prepare(), cam, cfg)
    img = np.clip(out.image.numpy(), 0, 1)
    psnr = 10 * np.log10(1.0 / max(float(np.mean((img - ref) ** 2)), 1e-12))
    assert psnr > 45, psnr


def test_repeat_render_is_bit_equal():
    d = interop.random_splat_arrays(5, 800, sh_degree=1, scale_range=(-3.5, -1.5))
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    cfg = gt.RenderConfig(width=64, height=48, sh_degree=1)
    cam = gt.look_at([0, 0, -9.0], [0, 0, 0], [0, 1, 0], 64, 48, fov_y_rad=0.9,
                     device="cpu")
    a, b = render(prep, cam, cfg), render(prep, cam, cfg)
    for f in ("image", "transmittance", "depth", "splat_id"):
        assert torch.equal(getattr(a, f), getattr(b, f))


# MESH_3DGUT and RTX render now (tests/test_torch_gut.py), and so does a
# fisheye camera_type on 3DGS (pinhole EWA, as in the JAX package), the
# packed tier (tests/test_torch_packed.py; its four cases below),
# stochastic transparency with its post pass (tests/test_torch_stochastic.py;
# its six cases below), the hybrid pipelines (tests/test_torch_shadows.py;
# their three cases below) and their per-ray shadows (``rt.shadows="ray"``
# with a light, the 3DGRT tracer: the three former cases of this table,
# now RAY_SHADOWS below). No config value is refused any more.
RAY_SHADOWS = {
    "fisheye": dict(pipeline="HYBRID_3DGUT", camera_type="FISHEYE"),
    "hybrid": dict(pipeline="HYBRID"),
    "hybrid_gut": dict(pipeline="HYBRID_3DGUT"),
}

TINY = (6, 50)  # scene seed and splats of the 32x32 probes


@pytest.fixture(scope="module")
def tiny():
    d = interop.random_splat_arrays(*TINY, sh_degree=0)
    cam = gt.look_at([0, 0, -9.0], [0, 0, 0], [0, 1, 0], 32, 32, device="cpu")
    return interop.splat_set_from_numpy(d, "cpu").prepare(), cam


@pytest.mark.parametrize("name", list(RAY_SHADOWS))
def test_ray_shadow_config_renders_and_matches_jax(tiny, name):
    """The per-ray shadows with a light (``rt.shadows="ray"``) render
    through ``render`` on the CPU and its frame matches the JAX package's,
    at the gates of ``test_hybrid_config_renders_and_matches_jax``
    (tests/test_torch_shadows.py holds the shaded frames and the shadow
    rays to JAX's)."""
    prep, cam = tiny
    kw = RAY_SHADOWS[name]
    camera = kw.get("camera_type", "PINHOLE")
    common = dict(width=32, height=32)
    cj = jc.RenderConfig(**common, pipeline=jc.Pipeline[kw["pipeline"]],
                         camera_type=jc.CameraType[camera], rt=jc.RtConfig(shadows="ray"))
    ct = tc.RenderConfig(**common, pipeline=tc.Pipeline[kw["pipeline"]],
                         camera_type=tc.CameraType[camera], rt=tc.RtConfig(shadows="ray"))
    d = interop.random_splat_arrays(*TINY, sh_degree=0)
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    light_t = gt.scene.lights.make_light(position=(0.0, -6.0, 0.0), device="cpu")
    light_j = jl.make_light(position=(0.0, -6.0, 0.0))
    oj = j_dispatch(sj, jcam.make_camera(**interop.camera_to_numpy(cam)), cj, 1 << 14,
                    lights=(light_j,))
    ot = render(prep, cam, ct, 1 << 14, lights=(light_t,))
    assert isinstance(ot, gt.render.RenderOutput)
    assert float(ot.transmittance.min()) < (0.95 if camera == "FISHEYE" else 0.5)
    assert bool(oj.overflow) == bool(ot.overflow) and int(oj.num_pairs) == int(ot.num_pairs)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    assert (ot.splat_id.numpy() == np.asarray(oj.splat_id)).mean() >= ID_AGREE


# the former UNPORTED cases of the hybrid pipelines: the RenderConfig fields
# of each (no light: the headlight shades, unshadowed)
HYBRID = {
    "fisheye": dict(pipeline="HYBRID_3DGUT", camera_type="FISHEYE"),
    "hybrid": dict(pipeline="HYBRID"),
    "hybrid_gut": dict(pipeline="HYBRID_3DGUT"),
}


@pytest.mark.parametrize("name", list(HYBRID))
def test_hybrid_config_renders_and_matches_jax(tiny, name):
    """Each config renders through ``render`` on the CPU (its RenderOutput,
    as the JAX dispatch returns ``render_hybrid(...)[0]``) and matches the
    JAX package's frame: 3DGS at this file's gates, the gut3d frames at the
    flip-aware ones (>= 99.9 % of channels within 5e-5, none beyond
    1.2e-2); ids >= 99.9 %."""
    prep, cam = tiny
    kw = HYBRID[name]
    camera = kw.get("camera_type", "PINHOLE")
    cj = jc.RenderConfig(width=32, height=32, pipeline=jc.Pipeline[kw["pipeline"]],
                         camera_type=jc.CameraType[camera])
    ct = tc.RenderConfig(width=32, height=32, pipeline=tc.Pipeline[kw["pipeline"]],
                         camera_type=tc.CameraType[camera])
    d = interop.random_splat_arrays(*TINY, sh_degree=0)
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    oj = j_dispatch(sj, jcam.make_camera(**interop.camera_to_numpy(cam)), cj, 1 << 14)
    ot = render(prep, cam, ct, 1 << 14)
    assert isinstance(ot, gt.render.RenderOutput)
    # the scene covers pixels (under the fisheye lens it is small and faint)
    assert float(ot.transmittance.min()) < (0.95 if camera == "FISHEYE" else 0.5)
    assert bool(oj.overflow) == bool(ot.overflow) and int(oj.num_pairs) == int(ot.num_pairs)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    assert (ot.splat_id.numpy() == np.asarray(oj.splat_id)).mean() >= ID_AGREE


# the former UNPORTED cases of the packed tier: (pipeline, raster method)
PACKED = {
    "bucket_packed": ("MESH", "bucket"),
    "packed": ("MESH", "pairs"),
    "rtx": ("RTX", "pairs"),
    "gut_bucket_packed": ("MESH_3DGUT", "bucket"),
}


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_config_renders_and_matches_jax(tiny, name):
    """Each config renders on the CPU and matches the JAX package's packed
    frame: 3DGS at this file's tolerances, the gut3d frames at the
    flip-aware gates of tests/test_torch_gut.py (>= 99.9 % of channels
    within 5e-5, none beyond 1.2e-2); ids >= 99.9 %."""
    prep, cam = tiny
    pipeline, method = PACKED[name]
    kw = dict(width=32, height=32)
    cj = jc.RenderConfig(**kw, pipeline=jc.Pipeline[pipeline], raster=jc.RasterConfig(
        method=method, pair_format="packed"))
    ct = tc.RenderConfig(**kw, pipeline=tc.Pipeline[pipeline], raster=tc.RasterConfig(
        method=method, pair_format="packed"))
    d = interop.random_splat_arrays(*TINY, sh_degree=0)
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    fn = {"MESH": j_render, "RTX": j_grt, "MESH_3DGUT": j_gut}[pipeline]
    oj = fn(sj, jcam.make_camera(**interop.camera_to_numpy(cam)), cj)
    ot = render(prep, cam, ct)
    assert float(ot.transmittance.min()) < 0.5  # the scene covers pixels
    assert bool(oj.overflow) == bool(ot.overflow)
    diff = np.abs(ot.image.numpy() - np.asarray(oj.image))
    if pipeline == "MESH":
        assert diff.max() <= IMG_ATOL, diff.max()
    else:
        assert (diff <= IMG_ATOL).mean() >= ID_AGREE and diff.max() <= 1.2e-2, diff.max()
    assert (ot.splat_id.numpy() == np.asarray(oj.splat_id)).mean() >= ID_AGREE


# the former UNPORTED cases of stochastic transparency and post: the
# RenderConfig fields of each (the raster fields default)
STOCHASTIC = {
    "stochastic": dict(stochastic="SPLAT"),
    "temporal": dict(temporal_samples=2),
    "atrous": dict(denoise="atrous"),
    "gut": dict(pipeline="MESH_3DGUT", stochastic="SPLAT"),
    "gut_atrous": dict(pipeline="MESH_3DGUT", denoise="atrous"),
    "rtx_stochastic": dict(pipeline="RTX", stochastic="ANYHIT"),
}


@pytest.mark.parametrize("name", list(STOCHASTIC))
def test_stochastic_config_renders_and_matches_jax(tiny, name):
    """Each config renders on the CPU and matches the JAX package's frame:
    >= 99.9 % of channels within 5e-5 (a stochastic accept flips only where
    the packages' alphas straddle its uniform), the gut3d frames also none
    beyond 1.2e-2 (tests/test_torch_gut.py); ids >= 99.9 %."""
    prep, cam = tiny
    kw = dict(STOCHASTIC[name])
    pipeline = kw.pop("pipeline", "MESH")
    mode = kw.pop("stochastic", "NONE")
    cj = jc.RenderConfig(width=32, height=32, pipeline=jc.Pipeline[pipeline],
                         stochastic=jc.StochasticMode[mode], **kw)
    ct = tc.RenderConfig(width=32, height=32, pipeline=tc.Pipeline[pipeline],
                         stochastic=tc.StochasticMode[mode], **kw)
    d = interop.random_splat_arrays(*TINY, sh_degree=0)
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    fn = {"MESH": j_render, "RTX": j_grt, "MESH_3DGUT": j_gut}[pipeline]
    oj = fn(sj, jcam.make_camera(**interop.camera_to_numpy(cam)), cj)
    ot = render(prep, cam, ct)
    assert float(ot.transmittance.min()) < 0.5  # the scene covers pixels
    diff = np.abs(ot.image.numpy() - np.asarray(oj.image))
    assert np.isfinite(diff).all()
    assert (diff <= IMG_ATOL).mean() >= IMG_SHARE, (diff > IMG_ATOL).mean()
    if pipeline != "MESH":
        assert diff.max() <= IMG_MAX, diff.max()
    tdiff = np.abs(ot.transmittance.numpy() - np.asarray(oj.transmittance))
    assert (tdiff <= IMG_ATOL).mean() >= IMG_SHARE
    assert (ot.splat_id.numpy() == np.asarray(oj.splat_id)).mean() >= ID_AGREE


# host_order renders since the host-sorted path was ported
# (tests/test_torch_host_order.py holds it against the JAX package); what
# these two still see raise is an order that is not one index per splat
def assert_host_order_renders(prep, cam, cfg):
    order = torch.argsort(prep.means[:, 2], stable=True)  # front to back from z = -9
    out = render_3dgs(prep, cam, cfg, host_order=order)
    ref = render_3dgs(prep, cam, cfg)
    assert float(out.transmittance.min()) < 0.5 and not bool(out.overflow)
    assert (out.image - ref.image).abs().max().item() <= 1e-5
    for bad in (torch.arange(49), torch.arange(50.0)):
        with pytest.raises(ValueError, match="host_order"):
            render_3dgs(prep, cam, cfg, host_order=bad)


def test_host_order_raises(tiny):
    prep, cam = tiny
    assert_host_order_renders(prep, cam, tc.RenderConfig(width=32, height=32))


def test_bucket_host_order_raises(tiny):
    prep, cam = tiny
    assert_host_order_renders(prep, cam, tc.RenderConfig(
        width=32, height=32, raster=tc.RasterConfig(method="bucket")))


def test_render_is_bit_equal_across_input_alignments():
    """ROADMAP queue 3's hypothesis for the rare flip of the "default" case:
    that the host BLAS rounds the view_transform_points matmul apart for
    inputs at other alignments. The case's arrays and camera placed at
    offsets of 0-15 floats from an allocation render the same frame bit
    for bit, so alignment is not the source."""
    seed, n, scale_range, kw, _, _, _ = CASES["default"]
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)
    cfg = tc.RenderConfig(width=128, height=96, sh_degree=1)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 128, 96, fov_y_rad=0.9,
                     device="cpu")

    def at_offset(a, k):
        flat = torch.empty(a.numel() + k, dtype=torch.float32)[k:]
        return flat.copy_(a.reshape(-1)).view(a.shape)

    ref = None
    for k in range(16):
        s = gt.SplatSet(**{f: at_offset(torch.from_numpy(d[f]), k)
                           for f in interop.SPLAT_FIELDS})
        vm = at_offset(cam.viewmat, k)
        prep = s.prepare()
        assert prep.means.data_ptr() % 64 == 4 * k % 64
        out = render(prep, dataclasses.replace(cam, viewmat=vm, viewmat_end=vm), cfg)
        if ref is None:
            ref = out
        for f in ("image", "transmittance", "depth", "splat_id"):
            assert torch.equal(getattr(out, f), getattr(ref, f)), (k, f)


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
