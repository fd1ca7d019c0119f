"""The inspection tools on the CPU: the port's render/helpers.py (grid and
gizmo overlays) and debug.py (pixel traces) against the JAX package's, the
JAX package's behavioural tests of both on the port, and a scan of the
port's sources for any import of JAX or of the JAX package.

Tolerances:
- the grid and the three gizmo modes at 128x96, on a random image and
  depth buffer: 1e-5 (the same elementwise operations; the default 48
  ring segments' angles are ``jnp.linspace``'s float32 values bit for
  bit);
- ``pixel_trace``: splat ids equal to JAX's; depth, alpha, T, weight and
  the radiance within 1e-5; its final colour and T within 2e-5 of the
  port's rendered pixel (tests/test_compare_debug.py's gate);
- ``pixel_trace_gut``, depth and radial order: ids equal, the rest within
  1e-5 of JAX's, and the final colour within 2e-2 of the port's
  ``render_3dgut`` / ``render_3dgrt`` pixel (JAX's gate: the raster blend
  bins by the UT footprint and freezes per step);
- ``format_trace``: the same text as JAX's for the same trace.

No JAX raster program is built here (about 25 s alone).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu import debug as jdebug
from vk_gaussian_splatting_tpu.ops.projection import project_splats as j_project
from vk_gaussian_splatting_tpu.render import helpers as jh
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import debug as tdebug
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import raytrace
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.render import helpers as th
from vk_gaussian_splatting_tpu_torch.render import render_3dgrt, render_3dgs, render_3dgut

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
HELPER_ATOL = 1e-5
TRACE_ATOL = 1e-5
RENDER_ATOL = 2e-5
GUT_RENDER_ATOL = 2e-2
W, H = 128, 96


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def both_cameras(eye, center, up=(0, 1, 0), w=W, h=H, fov=0.8):
    cam_t = gt.look_at(eye, center, up, w, h, fov_y_rad=fov, device="cpu")
    return jcam.make_camera(**interop.camera_to_numpy(cam_t)), cam_t


def buffers(seed=0):
    """A random image and a depth buffer with a share of background (0)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 14.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.3] = 0.0
    return img, depth


# ---- helpers -----------------------------------------------------------------------------

GRID_VIEWS = {"oblique": ([0, 3, -8], [0, 0, 0]), "down": ([0.3, 6, 0.01], [0, -1, 0]),
              "far": ([5, 2.5, -40], [0, 0, 30])}


@pytest.mark.parametrize("view", list(GRID_VIEWS))
def test_grid_matches_jax(view):
    img, depth = buffers(1)
    cj, ct = both_cameras(*GRID_VIEWS[view], up=(0, 0, 1) if view == "down" else (0, 1, 0))
    cfg_j, cfg_t = jc.RenderConfig(width=W, height=H), tc.RenderConfig(width=W, height=H)
    for kw in (dict(plane_y=-1.0), dict(plane_y=0.0, base_spacing=0.5, opacity=0.8,
                                        fade_distance=30.0)):
        want = np.asarray(jh.render_grid_overlay(jnp.asarray(img), jnp.asarray(depth), cj,
                                                 cfg_j, **kw))
        got = th.render_grid_overlay(torch.from_numpy(img), torch.from_numpy(depth), ct,
                                     cfg_t, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(np_(got), want, rtol=0, atol=HELPER_ATOL)
        assert np.abs(np_(got) - img).max() > 0.05  # the grid shows


@pytest.mark.parametrize("mode", ["translate", "scale", "rotate"])
def test_gizmo_matches_jax(mode):
    img, depth = buffers(2)
    cj, ct = both_cameras([2, 2, -6], [0, 0, 0])
    cfg_j, cfg_t = jc.RenderConfig(width=W, height=H), tc.RenderConfig(width=W, height=H)
    for origin, size, thick in (((0.2, 0.1, 0.3), 1.5, 2.0), ((-0.5, 0.4, 1.0), 0.8, 3.5)):
        want = np.asarray(jh.render_gizmo_overlay(jnp.asarray(img), jnp.asarray(depth), cj,
                                                  cfg_j, origin=origin, size=size, mode=mode,
                                                  thickness_px=thick))
        got = th.render_gizmo_overlay(torch.from_numpy(img), torch.from_numpy(depth), ct, cfg_t,
                                      origin=np.asarray(origin), size=size, mode=mode,
                                      thickness_px=thick)
        np.testing.assert_allclose(np_(got), want, rtol=0, atol=HELPER_ATOL)
        assert np.abs(np_(got) - img).max() > 0.3


def test_ring_angles_are_jax_linspace_and_axis_spacing_is_finite():
    np.testing.assert_array_equal(th.ring_angles(48, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0, 2 * jnp.pi, 49)))
    for n in (7, 15):  # XLA's quotient may round one ulp apart at other counts
        got, want = th.ring_angles(n, "cpu").numpy(), np.asarray(jnp.linspace(0, 2 * jnp.pi, n + 1))
        assert np.abs(got - want).max() <= np.spacing(np.float32(2 * np.pi))
    coord = torch.tensor([-2.5, -0.5, 0.5, 1.5, 2.5, 0.3])
    # round half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    np.testing.assert_array_equal(torch.round(coord).numpy(), np.asarray(jnp.round(
        jnp.asarray(coord.numpy()))))
    assert np.isfinite(np.float32(1e30))
    m = th._line_mask(coord, 1e30, torch.full_like(coord, 0.5)).numpy()
    np.testing.assert_allclose(m, np.clip(1.5 - np.abs(coord.numpy()) / 0.5, 0, 1))
    xs = torch.tensor([[0.5, 1.5, 2.5, 3.5, 4.5]])
    assert th._checker(xs, torch.zeros_like(xs)).tolist() == [[0.0, 0.0, 1.0, 1.0, 0.0]]


def blank():
    return torch.zeros((H, W, 3)), torch.zeros((H, W))


def test_grid_draws_below_horizon_only():
    """tests/test_helpers.py's, on the port."""
    cfg = tc.RenderConfig(width=W, height=H)
    img, depth = blank()
    down = gt.look_at([0, 3, 0.01], [0, -1, 0], [0, 0, 1], W, H, device="cpu")
    out = np_(th.render_grid_overlay(img, depth, down, cfg, plane_y=-1.0))
    assert np.isfinite(out).all() and out.sum() > 50.0
    up = gt.look_at([0, 3, 0.01], [0, 7, 0], [0, 0, 1], W, H, device="cpu")
    assert np_(th.render_grid_overlay(img, depth, up, cfg, plane_y=-1.0)).sum() == 0.0


def test_grid_occluded_by_scene_depth():
    """tests/test_helpers.py's, on the port."""
    cfg = tc.RenderConfig(width=W, height=H)
    img, _ = blank()
    cam = gt.look_at([0, 3, -8], [0, 0, 0], [0, 1, 0], W, H, device="cpu")
    free = np_(th.render_grid_overlay(img, torch.zeros((H, W)), cam, cfg, plane_y=-1.0))
    blocked = np_(th.render_grid_overlay(img, torch.full((H, W), 0.5), cam, cfg, plane_y=-1.0))
    assert blocked.sum() < 0.5 * free.sum()


def test_gizmo_axis_colors_present():
    """tests/test_helpers.py's, on the port."""
    cfg = tc.RenderConfig(width=W, height=H)
    img, depth = blank()
    cam = gt.look_at([2, 2, -6], [0, 0, 0], [0, 1, 0], W, H, device="cpu")
    for mode in ("translate", "scale", "rotate"):
        out = np_(th.render_gizmo_overlay(img, depth, cam, cfg, origin=(0, 0, 0), size=1.0,
                                          mode=mode))
        assert np.isfinite(out).all()
        for ch in range(3):
            others = [c for c in range(3) if c != ch]
            dom = ((out[..., ch] > 0.4) & (out[..., ch] > out[..., others[0]] + 0.1)
                   & (out[..., ch] > out[..., others[1]] + 0.1))
            assert dom.any(), (mode, ch)


# ---- pixel traces --------------------------------------------------------------------------

TRACE_FIELDS = ("depth", "alpha", "transmittance", "weight", "radiance", "final_color")


def assert_traces_close(got, want):
    np.testing.assert_array_equal(got.splat_id, want.splat_id)
    for f in TRACE_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0, atol=TRACE_ATOL,
                                   err_msg=f)
    assert abs(got.final_transmittance - want.final_transmittance) <= TRACE_ATOL


@pytest.fixture(scope="module")
def gs_scene():
    d = interop.random_splat_arrays(60, 200, sh_degree=0, scale_range=(-2.5, -1.2))
    pj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    pt = interop.splat_set_from_numpy(d, "cpu").prepare()
    cj, ct = both_cameras([0, 0, -9], [0, 0, 0], w=64, h=48)
    cfg_j = jc.RenderConfig(width=64, height=48, sh_degree=0)
    cfg_t = tc.RenderConfig(width=64, height=48, sh_degree=0)
    return (j_project(pj, cj, cfg_j), cfg_j), (project_splats(pt, ct, cfg_t), cfg_t, pt, ct)


def test_pixel_trace_matches_jax_and_the_frame(gs_scene):
    (proj_j, cfg_j), (proj_t, cfg_t, pt, ct) = gs_scene
    out = render_3dgs(pt, ct, cfg_t, 32768)
    img, trans = np_(out.image), np_(out.transmittance)
    ys, xs = np.nonzero(trans < 0.8)
    picked = list(zip(ys, xs))[::37][:10]
    assert len(picked) >= 3
    for y, x in picked + [(0, 0)]:
        got = tdebug.pixel_trace(proj_t, int(x), int(y), cfg_t)
        assert_traces_close(got, jdebug.pixel_trace(proj_j, int(x), int(y), cfg_j))
        np.testing.assert_allclose(got.final_color, img[y, x], atol=RENDER_ATOL)
        np.testing.assert_allclose(got.final_transmittance, trans[y, x], atol=RENDER_ATOL)
    # the cap keeps the nearest contributors
    y, x = picked[0]
    full = tdebug.pixel_trace(proj_t, int(x), int(y), cfg_t)
    cut = tdebug.pixel_trace(proj_t, int(x), int(y), cfg_t, max_entries=2)
    np.testing.assert_array_equal(cut.splat_id, full.splat_id[:2])
    assert_traces_close(cut, jdebug.pixel_trace(proj_j, int(x), int(y), cfg_j, max_entries=2))


def test_format_trace_matches_jax(gs_scene):
    (proj_j, cfg_j), (proj_t, cfg_t, _, _) = gs_scene
    for x, y in ((32, 24), (30, 20), (0, 0)):
        tt = tdebug.pixel_trace(proj_t, x, y, cfg_t)
        tj = jdebug.pixel_trace(proj_j, x, y, cfg_j)
        for trace in (tt, tj):
            assert tdebug.format_trace(trace) == jdebug.format_trace(trace)
            assert tdebug.format_trace(trace, limit=3) == jdebug.format_trace(trace, limit=3)
    text = tdebug.format_trace(tt)
    assert "final color" in text and "contributors" in text


@pytest.fixture(scope="module")
def gut_scene():
    d = interop.random_splat_arrays(61, 220, sh_degree=1, extent=2.0, scale_range=(-2.5, -1.2))
    pj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    pt = interop.splat_set_from_numpy(d, "cpu").prepare()
    cj, ct = both_cameras([0, 0, -6], [0, 0, 0], w=64, h=48, fov=0.9)
    return pj, pt, cj, ct


@pytest.mark.parametrize("order", ["depth", "radial"])
def test_pixel_trace_gut_matches_jax_and_the_frame(gut_scene, order):
    pj, pt, cj, ct = gut_scene
    cfg_t = tc.RenderConfig(width=64, height=48, sh_degree=1)
    cfg_j = jc.RenderConfig(width=64, height=48, sh_degree=1)
    render = render_3dgut if order == "depth" else render_3dgrt
    img = np_(render(pt, ct, cfg_t, max_pairs=1 << 16).image)
    for x, y in [(32, 24), (20, 30), (45, 12)]:
        got = tdebug.pixel_trace_gut(pt, ct, x, y, cfg_t, order=order)
        assert len(got.splat_id) > 0
        assert_traces_close(got, jdebug.pixel_trace_gut(pj, cj, x, y, cfg_j, order=order))
        np.testing.assert_allclose(got.final_color, img[y, x], atol=GUT_RENDER_ATOL)
    # a splat scale and a fisheye ray reach the same numbers as JAX's
    for kw in (dict(splat_scale=1.3), dict(camera_type=1)):
        got = tdebug.pixel_trace_gut(pt, ct, 40, 20, cfg_t.replace(**kw), order=order)
        want = jdebug.pixel_trace_gut(pj, cj, 40, 20, cfg_j.replace(**kw), order=order)
        assert_traces_close(got, want)


def test_pixel_trace_gut_takes_the_splat_frames(gut_scene, monkeypatch):
    """The port's tracer response reads the (19, N) rows of _splat_frames
    (the scales already times cfg.splat_scale), where the JAX one reads the
    14 rows of _splat_rows and the scale; the colours are the frames' rows
    FRAME_RGB..FRAME_RGB+2 (rows 10-12 of _splat_rows)."""
    _, pt, _, ct = gut_scene
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=1, splat_scale=1.3)
    seen = []
    real = raytrace._chunk_alpha_t

    def spy(block, o, d, *args, **kw):
        seen.append((block, args, kw))
        return real(block, o, d, *args, **kw)

    monkeypatch.setattr(tdebug, "_chunk_alpha_t", spy)
    tr = tdebug.pixel_trace_gut(pt, ct, 32, 24, cfg)
    (block, args, kw), = seen
    assert block.shape == (19, pt.num_splats) and kw == {}
    assert args == (cfg.rt.kernel_degree, cfg.rt.alpha_min, cfg.rt.alpha_clamp)
    np.testing.assert_allclose(np_(block[3:6]).T, np.exp(np_(pt.scales_log)) * 1.3, rtol=1e-6)
    colors, _ = raytrace.splat_view_colors(pt, ct.position, cfg)
    ids = tr.splat_id
    np.testing.assert_array_equal(np_(block[raytrace.FRAME_RGB:raytrace.FRAME_RGB + 3]).T[ids],
                                  np_(colors)[ids])


def test_pixel_ray_matches_jax(gut_scene):
    _, _, cj, ct = gut_scene
    for cam_type in (0, 1):
        cfg_t = tc.RenderConfig(width=64, height=48, camera_type=tc.CameraType(cam_type))
        cfg_j = jc.RenderConfig(width=64, height=48, camera_type=jc.CameraType(cam_type))
        for x, y in ((0, 0), (63, 47), (20, 31)):
            o_t, d_t = tdebug._pixel_ray(ct, x, y, cfg_t)
            o_j, d_j = jdebug._pixel_ray(cj, x, y, cfg_j)
            np.testing.assert_allclose(o_t, o_j, rtol=0, atol=1e-6)
            np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-7)
            assert abs(np.linalg.norm(d_t) - 1.0) < 1e-6


# ---- no JAX anywhere in the port ------------------------------------------------------

# an import of JAX or of the JAX package, also inside a function body or by name
JAX_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+vk_gaussian_splatting_tpu\b(?!_)"
    r"|from\s+vk_gaussian_splatting_tpu\b(?!_))"
    r"|vk_gaussian_splatting_tpu\.|import_module\(\s*['\"](jax|vk_gaussian_splatting_tpu)\b(?!_)"
    r"|__import__\(\s*['\"](jax|vk_gaussian_splatting_tpu)\b(?!_)")


def jax_imports(text: str) -> list[str]:
    return [line for line in text.splitlines() if JAX_IMPORT.search(line)]


def test_package_sources_never_import_jax():
    """A scan of every source file of the port, which sees lazy imports
    inside function bodies (the JAX package's debug.pixel_trace_gut has one)
    that the import walk of tests/test_torch_render.py cannot."""
    root = os.path.join(REPO, "vk_gaussian_splatting_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    assert len(files) > 40
    bad = {}
    for path in files:
        with open(path) as f:
            hits = jax_imports(f.read())
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not jax_imports(f.read())
    # the scan catches what it must
    for line in ("    import jax.numpy as jnp", "    from jax import lax",
                 "    from vk_gaussian_splatting_tpu.ops.raytrace import _splat_rows",
                 "import vk_gaussian_splatting_tpu as gs",
                 "x = importlib.import_module('jax')"):
        assert jax_imports("def f():\n" + line), line
    for line in ("from vk_gaussian_splatting_tpu_torch.ops import raytrace",
                 "import vk_gaussian_splatting_tpu_torch as gt",
                 '"""counterpart of ``vk_gaussian_splatting_tpu/debug.py``"""'):
        assert not jax_imports(line), line
