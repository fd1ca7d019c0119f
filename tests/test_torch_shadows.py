"""Deep shadow maps on the CPU: the port's render/shadows.py and K1's
multi-iso form (its plain twin) against the JAX package's, on one numpy
input. The JAX kernel runs in interpret mode, as tests/test_shadows.py runs
it.

Tolerances:
- ``shadow_tint``, ``scene_bounds``, ``light_camera``: 1e-6 (float32
  operations in the same order; norms and 3x3 products may sum in another).
- ``sample_shadow``, ``sample_shadow_colored``, ``sample_shadow_cube`` on
  given breakpoints: the same staircase levels exactly, at points inside,
  behind and off the map (texel centres, so no rounding moves a texel);
  the coloured values within 1e-6.
- the multi-iso twin: rows 0-3 equal the gs2d twin's bit for bit, row 4 + k
  the gs2d twin's pick at depth_iso = ISO_LEVELS[k] bit for bit; autograd
  through it equal to autograd through the gs2d twin bit for bit.
- ``render_deep_shadow_map``, ``render_cube_shadow_map`` against JAX: on
  texels some splat covers (a breakpoint in either), >= 99.9 % of the
  breakpoints equal within 1e-5 of their size; the others are flips (one
  package picks a level at another splat, or none, where T lands within
  rounding of a level: JAX forms T as a lane scan, the twin as a cumprod;
  counted); the tint within 1e-5.
- ``make_shadow_fn``: the cube map for an enclosed point light, the cone
  otherwise, the coloured path with ``rt.shadow_color_strength`` > 0; its
  lookups equal JAX's on >= 99.9 % of the points.

JAX programs built here: the map blends at 64^2 and 32^2 (the kernels'
interpret programs are cached per shape; about 10 s alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.render import shadows as js
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import lights as jl
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.render import shadows as ts
from vk_gaussian_splatting_tpu_torch.render.deferred import surface_points as td_surface
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    bin_for_cfg,
    gs_attr_rows,
    raster_statics,
    render_hybrid,
)
from vk_gaussian_splatting_tpu_torch.scene import lights as tl

torch.set_num_threads(2)

RTOL = 1e-6
BP_RTOL, BP_AGREE = 1e-5, 0.999
TINT_ATOL = 1e-5
LOOKUP_AGREE = 0.999
MAP_RES, CUBE_RES = 64, 32
IMG_ATOL_H = 5e-5


# ---- shared inputs ---------------------------------------------------------------

def blocker_arrays(seed=0, n=150):
    """tests/test_shadows.py's blocker: a dense opaque blob at the origin."""
    d = interop.random_splat_arrays(seed, n, sh_degree=0, extent=0.6, scale_range=(-1.2, -0.8))
    d["opacities"][:] = 6.0
    return d


def both_prepared(d):
    pj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    return pj, interop.splat_set_from_numpy(d, "cpu").prepare()


LIGHTS = {  # name: make_light keywords
    "point": dict(light_type=tl.LightType.POINT, position=(0.0, -8.0, 0.0), intensity=1.5),
    "spot": dict(light_type=tl.LightType.SPOT, position=(3.0, -6.0, -2.0),
                 direction=(-0.3, 1.0, 0.2)),
    "directional": dict(light_type=tl.LightType.DIRECTIONAL, direction=(0.2, 1.0, 0.1)),
    "enclosed": dict(light_type=tl.LightType.POINT, position=(0.05, 0.0, 0.0)),
    "overhead": dict(light_type=tl.LightType.DIRECTIONAL, direction=(0.0, 1.0, 0.0),
                     intensity=1.5),
}


def both_lights(name):
    kw = dict(LIGHTS[name])
    kind = kw.pop("light_type")
    return (jl.make_light(jl.LightType(int(kind)), **kw),
            tl.make_light(kind, **kw, device="cpu"))


def cfgs(**kw):
    base = dict(width=64, height=64, sh_degree=0)
    base.update(kw)
    return jc.RenderConfig(**base), tc.RenderConfig(**base)


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


# ---- pure functions ---------------------------------------------------------------

@pytest.mark.parametrize("threshold, strength", [(0.0, 0.0), (0.2, 1.0), (0.8, 0.5)])
def test_shadow_tint_matches_jax(threshold, strength):
    rng = np.random.default_rng(1)
    t = rng.uniform(-0.1, 1.1, 257).astype(np.float32)
    rad = rng.uniform(0.0, 2.0, (257, 3)).astype(np.float32)
    rad[:20] *= 1e-4  # below the normalisation's floor
    got = ts.shadow_tint(torch.from_numpy(t), torch.from_numpy(rad), threshold, strength)
    want = js.shadow_tint(jnp.asarray(t), jnp.asarray(rad), threshold, strength)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("name", ["point", "spot", "directional"])
def test_scene_bounds_and_light_camera_match_jax(name):
    pj, pt = both_prepared(blocker_arrays())
    cj, rj = js.scene_bounds(pj)
    ct, rt = ts.scene_bounds(pt)
    np.testing.assert_allclose(np_(ct), np.asarray(cj), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(float(rt), float(rj), rtol=RTOL)
    lj, lt = both_lights(name)
    cam_j = js.light_camera(lj, cj, rj, MAP_RES)
    cam_t = ts.light_camera(lt, ct, rt, MAP_RES)
    for f in interop.CAMERA_FIELDS:
        want = np.asarray(getattr(cam_j, f))
        np.testing.assert_allclose(np_(getattr(cam_t, f)), want, rtol=RTOL,
                                   atol=RTOL * max(1.0, float(np.abs(want).max())), err_msg=f)


def map_pair(cam_t, res, seed):
    """A DeepShadowMap in both packages on one camera, with seeded
    staircases: four ascending breakpoints a texel, a quarter of the texels
    without some or all of them, and a tint."""
    rng = np.random.default_rng(seed)
    bp = np.sort(rng.uniform(4.0, 12.0, (res, res, 4)), axis=-1).astype(np.float32)
    cut = rng.integers(0, 5, (res, res))  # levels picked at this texel
    bp[np.arange(4)[None, None, :] >= cut[..., None]] = 0.0
    tint = rng.uniform(0.05, 1.0, (res, res, 3)).astype(np.float32)
    jmap = js.DeepShadowMap(cam=jcam.make_camera(**interop.camera_to_numpy(cam_t)),
                            breakpoints=jnp.asarray(bp), tint=jnp.asarray(tint))
    tmap = ts.DeepShadowMap(cam=cam_t, breakpoints=torch.from_numpy(bp),
                            tint=torch.from_numpy(tint))
    return jmap, tmap


def texel_points(cam_t, res, rng, n, depth_range=(2.0, 14.0), margin=0):
    """World points at texel centres (and ``margin`` texels beyond the map's
    edge), at view depths away from the texel's breakpoints' rounding: f64
    unprojection, then float32."""
    vm = cam_t.viewmat.double().numpy()
    f, c = float(cam_t.fx), float(cam_t.cx)
    i = rng.integers(-margin, res + margin, n) + 0.5
    j = rng.integers(-margin, res + margin, n) + 0.5
    z = rng.uniform(*depth_range, n)
    p_view = np.stack([(i - c) / f * z, (j - c) / f * z, z], 1)
    return ((p_view - vm[:3, 3]) @ vm[:3, :3]).astype(np.float32)


def away_from_breakpoints(pts, tmap, offset=0.05, gap=1e-3):
    """The points whose depth less the offset lies more than ``gap`` from
    every breakpoint of their texel (a comparison there is exact in both)."""
    z, _, _, vi, ui = ts._texels(torch.from_numpy(pts), tmap)
    bp = tmap.breakpoints[vi, ui]
    return ((z - offset)[:, None] - bp).abs().amin(dim=1).numpy() > gap


def test_sample_shadow_matches_jax():
    _, pt = both_prepared(blocker_arrays())
    _, lt = both_lights("point")
    c, r = ts.scene_bounds(pt)
    cam_t = ts.light_camera(lt, c, r, MAP_RES)
    jmap, tmap = map_pair(cam_t, MAP_RES, seed=2)
    rng = np.random.default_rng(3)
    inside = texel_points(cam_t, MAP_RES, rng, 3000)
    off = texel_points(cam_t, MAP_RES, rng, 400, margin=40)
    behind = texel_points(cam_t, MAP_RES, rng, 200, depth_range=(-6.0, -0.5))
    is_behind = np.repeat([False, True], [len(inside) + len(off), len(behind)])
    pts = np.concatenate([inside, off, behind])
    keep = away_from_breakpoints(pts, tmap)
    pts, is_behind = pts[keep], is_behind[keep]
    got = ts.sample_shadow(torch.from_numpy(pts), tmap).numpy()
    want = np.asarray(js.sample_shadow(jnp.asarray(pts), jmap))
    np.testing.assert_array_equal(got, want)
    # past the deepest breakpoint is opaque (0), so 0.05 never reads out
    levels = np.float32([0.0, 0.25, 0.5, 0.75, 1.0])
    assert np.array_equal(np.unique(got), levels)  # every level and the unshadowed 1 occur
    assert is_behind.sum() > 100 and (got[is_behind] == 1.0).all()  # behind the light
    for threshold, strength in ((0.2, 1.0), (0.0, 0.4)):
        got = ts.sample_shadow_colored(torch.from_numpy(pts), tmap, threshold, strength)
        want = js.sample_shadow_colored(jnp.asarray(pts), jmap, threshold, strength)
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL, atol=RTOL)


def test_sample_shadow_cube_matches_jax():
    _, lt = both_lights("enclosed")
    faces_j, faces_t = [], []
    for k, axes in enumerate(ts._CUBE_AXES):
        cam_t = ts._light_view(torch.tensor(axes, dtype=torch.float32), lt.position,
                               0.5 * CUBE_RES / 1.05, CUBE_RES, 1e-3, 20.0)
        jm, tm = map_pair(cam_t, CUBE_RES, seed=10 + k)
        faces_j.append(jm)
        faces_t.append(tm)
    rng = np.random.default_rng(4)
    d = rng.normal(size=(4000, 3))
    pts = (np.asarray(LIGHTS["enclosed"]["position"])
           + d / np.linalg.norm(d, axis=1, keepdims=True) * rng.uniform(2.0, 14.0, (4000, 1)))
    pts = pts.astype(np.float32)
    keep = np.ones(len(pts), bool)
    for tm in faces_t:
        keep &= away_from_breakpoints(pts, tm)
    pts = pts[keep]
    got = ts.sample_shadow_cube(torch.from_numpy(pts), ts.CubeShadowMap(faces_t)).numpy()
    want = np.asarray(js.sample_shadow_cube(jnp.asarray(pts), js.CubeShadowMap(faces_j)))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 5


# ---- the multi-iso form's twin ------------------------------------------------------

def shadow_bins(res=MAP_RES):
    """The blocker scene's cone map bins from the point light, as
    ``render_deep_shadow_map`` bins them."""
    _, pt = both_prepared(blocker_arrays())
    _, lt = both_lights("point")
    c, r = ts.scene_bounds(pt)
    cam = ts.light_camera(lt, c, r, res)
    _, ct = cfgs()
    return ts.shadow_map_bins(pt, cam, ct.replace(width=res, height=res), 1 << 18)


def test_multi_iso_twin_rows_equal_gs2d_twin():
    bins, st = shadow_bins()
    assert tr.form_of(st) == "gs2d_iso" and tr.LAUNCH_COUNTER["gs2d_iso"] == "launches_iso"
    out, ids = tr.rasterize_bins(bins, st)
    assert out.shape == (st.tiles_x * st.tiles_y, tr.ISO_OUT_ROWS, tr.PIX)
    assert (ids == -1).all()
    gs2d = dataclasses.replace(st, multi_iso=False)
    ref, _ = tr.rasterize_bins(bins, gs2d)
    assert torch.equal(out[:, :4], ref[:, :4])
    for k, level in enumerate(ts.ISO_LEVELS):
        pick, _ = tr.rasterize_bins(bins, dataclasses.replace(gs2d, depth_iso=level))
        assert torch.equal(out[:, 4 + k], pick[:, 4]), k
        assert (out[:, 4 + k] > 0).any(), k
    # deeper levels are picked at the same pair or later: never nearer
    d = out[:, 4:8]
    both = (d[:, :-1] > 0) & (d[:, 1:] > 0)
    assert (d[:, 1:][both] >= d[:, :-1][both]).all()
    assert ((d[:, 1:] > 0) <= (d[:, :-1] > 0)).all()


def test_multi_iso_autograd_equals_gs2d():
    bins, st = shadow_bins()
    gs2d = dataclasses.replace(st, multi_iso=False)
    g = torch.randn((st.tiles_x * st.tiles_y, 4, tr.PIX), generator=torch.Generator().manual_seed(0))
    grads = []
    for s in (st, gs2d):
        attrs = bins.attrs.detach().clone().requires_grad_()
        out, _ = tr.rasterize_tiles(attrs, bins.pair_id, bins.tile_start, bins.tile_count, s)
        (out[:, :4] * g).sum().backward()
        twin = bins.attrs.detach().clone().requires_grad_()
        ref, _ = tr.rasterize_tiles_ref(twin, bins.pair_id, bins.tile_start, bins.tile_count, s)
        (ref[:, :4] * g).sum().backward()
        grads += [attrs.grad, twin.grad]
    assert grads[0].abs().max() > 0
    # the same backward twin (K2's gs2d form's) and the same autograd graph
    assert torch.equal(grads[0], grads[2]) and torch.equal(grads[1], grads[3])
    assert tr.rasterize_tiles_bwd.launches_iso == 0  # no backward form of its own


def test_multi_iso_refusals():
    bins, st = shadow_bins()
    args = (bins.attrs, bins.pair_id, bins.tile_start, bins.tile_count)
    for bad, err, match in (
            (dict(stochastic=True), NotImplementedError, "deterministic gs2d"),
            (dict(iso_thresholds=(0.75, 0.5, 0.25)), ValueError, "4 thresholds")):
        s = dataclasses.replace(st, **bad)
        with pytest.raises(err, match=match):
            tr.rasterize_tiles(*args, s)
        with pytest.raises(err, match=match):
            tr.entry_name("rasterize_fwd", s)
    for model in ("gut3d", "gs2dp", "gs2d_clip"):
        s = dataclasses.replace(st, model=model)
        with pytest.raises(NotImplementedError, match="deterministic gs2d"):
            tr.entry_name("rasterize_fwd", s)
        rows = tr.MODELS[model].rows
        with pytest.raises(NotImplementedError, match="deterministic gs2d"):
            tr.rasterize_tiles_ref(torch.zeros((rows, 0)), torch.zeros((0,), dtype=torch.int32),
                                   bins.tile_start, bins.tile_count, s)
    for name in ("raster_bucket_fwd", "raster_bucket_bwd"):
        with pytest.raises(NotImplementedError, match="queue 2"):
            tr.entry_name(name, st)
    with pytest.raises(NotImplementedError, match="queue 2"):
        rb.rasterize_buckets(types_bins(), st, (128,) * 4)
    with pytest.raises(NotImplementedError, match="gs2d's"):
        tr.entry_name("rasterize_bwd", st)
    assert tr.entry_name("rasterize_fwd", st) == "rasterize_fwd_iso"


def types_bins():
    return dataclasses.make_dataclass("B", ["attrs", "ids", "bucket_starts"])(
        torch.zeros((10, 0)), torch.zeros((0,), dtype=torch.int32),
        torch.zeros((1,), dtype=torch.int32))


# ---- the maps against JAX ------------------------------------------------------------

def breakpoints_agree(got, want):
    """(share of breakpoints on covered texels within BP_RTOL, flips, count):
    covered where either map has a breakpoint."""
    got, want = np_(got), np.asarray(want)
    covered = (got > 0).any(-1) | (want > 0).any(-1)
    g, w = got[covered], want[covered]
    ok = np.abs(g - w) <= BP_RTOL * np.maximum(np.abs(w), 1e-30)
    return ok.mean(), int((~ok).sum()), ok.size


@pytest.fixture(scope="module")
def blocker():
    d = blocker_arrays()
    return both_prepared(d)


def test_deep_shadow_map_matches_jax(blocker):
    pj, pt = blocker
    cj, ct = cfgs()
    lj, lt = both_lights("point")
    mj = js.render_deep_shadow_map(pj, lj, cj, res=MAP_RES)
    mt = ts.render_deep_shadow_map(pt, lt, ct, res=MAP_RES)
    for f in interop.CAMERA_FIELDS:
        np.testing.assert_allclose(np_(getattr(mt.cam, f)), np.asarray(getattr(mj.cam, f)),
                                   rtol=RTOL, atol=1e-4, err_msg=f)
    share, flips, n = breakpoints_agree(mt.breakpoints, mj.breakpoints)
    print(f"cone map: {n} breakpoints on covered texels, {flips} flips")
    assert n > 400 and share >= BP_AGREE, (share, flips)
    np.testing.assert_allclose(np_(mt.tint), np.asarray(mj.tint), rtol=0, atol=TINT_ATOL)
    # the blocker shadows the point behind it and not the one beside it
    t = ts.sample_shadow(torch.tensor([[0.0, 4.0, 0.0], [6.0, 4.0, 0.0]]), mt)
    assert float(t[0]) < 0.3 and float(t[1]) > 0.9


def test_cube_shadow_map_matches_jax(blocker):
    pj, pt = blocker
    cj, ct = cfgs()
    lj, lt = both_lights("enclosed")
    mj = js.render_cube_shadow_map(pj, lj, cj, res=CUBE_RES)
    mt = ts.render_cube_shadow_map(pt, lt, ct, res=CUBE_RES)
    assert len(mt.faces) == 6
    total = flips = 0
    for fj, ft in zip(mj.faces, mt.faces):
        np.testing.assert_allclose(np_(ft.cam.viewmat), np.asarray(fj.cam.viewmat),
                                   rtol=RTOL, atol=RTOL)
        _, f, n = breakpoints_agree(ft.breakpoints, fj.breakpoints)
        total, flips = total + n, flips + f
        np.testing.assert_allclose(np_(ft.tint), np.asarray(fj.tint), rtol=0, atol=TINT_ATOL)
    print(f"cube map: {total} breakpoints on covered texels, {flips} flips")
    assert total > 400 and flips <= (1 - BP_AGREE) * total, (flips, total)


@pytest.mark.parametrize("name, strength, cube", [("point", 0.0, False),
                                                  ("enclosed", 0.0, True),
                                                  ("overhead", 1.0, False)])
def test_make_shadow_fn_matches_jax(blocker, name, strength, cube):
    pj, pt = blocker
    rt_kw = dict(shadow_color_strength=strength, shadow_transmittance_threshold=0.1 * strength)
    cj, ct = cfgs()
    cj = cj.replace(rt=dataclasses.replace(cj.rt, **rt_kw))
    ct = ct.replace(rt=dataclasses.replace(ct.rt, **rt_kw))
    lj, lt = both_lights(name)
    res = CUBE_RES if cube else MAP_RES
    fn_j = js.make_shadow_fn(pj, (lj,), cj, res=res)
    fn_t = ts.make_shadow_fn(pt, (lt,), ct, res=res)
    # the choice: the cube map for the enclosed point light alone
    center, radius = ts.scene_bounds(pt)
    assert (int(lt.type) == tl.LightType.POINT
            and float(torch.linalg.norm(lt.position - center)) < float(radius)) == cube
    rng = np.random.default_rng(5)
    pts = rng.uniform(-3.0, 3.0, (4000, 3)).astype(np.float32)
    got, want = np_(fn_t(torch.from_numpy(pts), lt)), np.asarray(fn_j(jnp.asarray(pts), lj))
    assert got.shape == want.shape == ((4000, 3) if strength > 0 else (4000,))
    close = np.abs(got - want) <= (TINT_ATOL if strength > 0 else 0.0)
    close = close.all(-1) if strength > 0 else close
    print(f"make_shadow_fn {name}: {int((~close).sum())} of {len(pts)} lookups differ")
    assert close.mean() >= LOOKUP_AGREE
    lit = got.min(-1) if strength > 0 else got
    assert (lit < 0.5).any() and (lit == 1.0).any()  # shadowed and unshadowed points


def test_ray_shadows_without_lights_render(blocker):
    """``rt.shadows="ray"`` with no light: the headlight shades, unshadowed,
    on both hybrid pipelines (no shadow function is built)."""
    _, pt = blocker
    cam = gt.look_at([0, -2.0, -12.0], [0, 2.0, 0], [0, 1, 0], 32, 32, device="cpu")
    for pipeline in (tc.Pipeline.HYBRID, tc.Pipeline.HYBRID_3DGUT):
        cfg = tc.RenderConfig(width=32, height=32, sh_degree=0, pipeline=pipeline)
        cfg = cfg.replace(rt=dataclasses.replace(cfg.rt, shadows="ray"))
        out, shaded, _ = render_hybrid(pt, cam, cfg, lights=())
        assert torch.isfinite(shaded).all() and float(out.transmittance.min()) < 0.5


# ---- render_hybrid against JAX --------------------------------------------------------
#
# The JAX ``render_hybrid`` is jitted, and under jit its ``make_shadow_fn``
# cannot read the light's distance, so it gives every light the cone map;
# outside jit (its ``__wrapped__`` function) it gives an enclosed point
# light the cube map, as the port always does. The cases with an enclosed
# light compare with the function outside jit.

HYBRID_RES = 64  # the cone maps' size; the cube faces take min(res, 256)
HYBRID = {  # name: (pipeline, camera type, lights)
    "hybrid": ("HYBRID", "PINHOLE", ("point", "enclosed_slab")),
    "hybrid_gut": ("HYBRID_3DGUT", "PINHOLE", ("overhead",)),
    "hybrid_gut_fisheye": ("HYBRID_3DGUT", "FISHEYE", ("overhead",)),
}
LIGHTS["enclosed_slab"] = dict(light_type=tl.LightType.POINT, position=(1.5, 2.5, 1.0),
                               intensity=2.0)


def hybrid_arrays():
    """tests/test_shadows.py's hybrid scene: the blocker and a receiver slab
    below it (y = 4)."""
    blob = blocker_arrays()
    slab = interop.random_splat_arrays(1, 200, sh_degree=0, extent=4.0, scale_range=(-1.5, -1.0))
    slab["means"] = (slab["means"] * np.float32([1.0, 0.05, 1.0])
                     + np.float32([0.0, 4.0, 0.0])).astype(np.float32)
    slab["opacities"][:] = 4.0
    return {k: np.concatenate([blob[k], slab[k]]) for k in blob}


def jax_surface_points(depth, cam):
    """deferred_shade's world positions, in the JAX package's operations."""
    h, w = depth.shape
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                          jnp.arange(w, dtype=jnp.float32) + 0.5, indexing="ij")
    d_cam = jnp.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, jnp.ones_like(xs)], -1)
    return cam.position + jnp.matmul(d_cam * depth[..., None], cam.viewmat[:3, :3],
                                     precision=jax.lax.Precision.HIGHEST)


def frame_gate(diff, atol, gut):
    """>= 99.9 % within ``atol`` (the p99.9), the median within it; the gs2d
    frames also none beyond 1.2e-2 (the gut3d frames flip whole cutoff
    contributions: never the max)."""
    ok = np.median(diff) <= atol and np.quantile(diff, BP_AGREE) <= atol
    return ok and (gut or diff.max() <= 1.2e-2)


@pytest.fixture(scope="module")
def hybrid_inputs():
    d = hybrid_arrays()
    return both_prepared(d)


@pytest.mark.parametrize("name", list(HYBRID))
def test_render_hybrid_matches_jax(hybrid_inputs, name):
    from vk_gaussian_splatting_tpu.render.pipelines import render_hybrid as j_hybrid
    pj, pt = hybrid_inputs
    pipeline, camera_type, light_names = HYBRID[name]
    cj, ct = cfgs(pipeline=pipeline, camera_type=camera_type)
    cj = cj.replace(pipeline=jc.Pipeline[pipeline], camera_type=jc.CameraType[camera_type])
    ct = ct.replace(pipeline=tc.Pipeline[pipeline], camera_type=tc.CameraType[camera_type])
    cam_t = gt.look_at([0, -2.0, -12.0], [0, 2.0, 0], [0, 1, 0], 64, 64, device="cpu")
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))
    lights = [both_lights(n) for n in light_names]
    lj, lt = tuple(a for a, _ in lights), tuple(b for _, b in lights)
    center, radius = ts.scene_bounds(pt)
    enclosed = [int(light.type) == tl.LightType.POINT
                and float(torch.linalg.norm(light.position - center)) < float(radius)
                for light in lt]
    fn = j_hybrid.__wrapped__ if any(enclosed) else j_hybrid
    oj, sj, nj = fn(pj, cam_j, cj, 1 << 16, lights=lj, shadow_res=HYBRID_RES)
    ot, st_, nt = render_hybrid(pt, cam_t, ct, 1 << 16, lights=lt, shadow_res=HYBRID_RES)
    gut = pipeline == "HYBRID_3DGUT"
    assert float(ot.transmittance.min()) < 0.5 and bool(oj.overflow) == bool(ot.overflow)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        assert frame_gate(np.abs(np_(a) - np.asarray(b)), IMG_ATOL_H, gut)
    same = np.asarray(oj.splat_id) == np_(ot.splat_id)
    assert same.mean() >= BP_AGREE
    cover = ((1 - np_(ot.transmittance) > 1e-2) & (1 - np.asarray(oj.transmittance) > 1e-2))
    ndiff = np.abs(np_(nt) - np.asarray(nj))[cover]
    assert frame_gate(ndiff, 1e-4, gut), ndiff.max()

    # a shaded pixel beyond the gate must read another staircase level in
    # one of its lights' lookups (or sit on a raster flip: another pick)
    fn_t = ts.make_shadow_fn(pt, lt, ct, HYBRID_RES)
    wt = td_surface(ot.depth, cam_t)
    beyond = (np.abs(np_(st_) - np.asarray(sj)) > 1e-4).any(-1)
    levels_differ = np.zeros(same.shape, bool)
    if beyond.any():  # the JAX lookups (its maps again), only where needed
        fn_j = js.make_shadow_fn(pj, lj, cj, HYBRID_RES)
        wj = jax_surface_points(oj.depth, cam_j)
        for a, b in zip(lt, lj):
            la, lb = np_(fn_t(wt, a)), np.asarray(fn_j(wj, b))
            levels_differ |= (la != lb) if la.ndim == 2 else (la != lb).any(-1)
    covered = (np_(ot.depth) > 0) | (np.asarray(oj.depth) > 0)
    shaded_levels = np.unique(np_(fn_t(wt, lt[0]))[np_(ot.depth) > 0])
    unexplained = beyond & ~levels_differ & same
    print(f"{name}: {int(beyond.sum())} shaded pixels beyond 1e-4 of {beyond.size}, "
          f"{int((beyond & levels_differ).sum())} with another staircase level, "
          f"{int((beyond & ~same).sum())} on another pick, {int(unexplained.sum())} unexplained; "
          f"levels read {shaded_levels.tolist()}")
    assert unexplained.sum() <= (1 - BP_AGREE) * covered.sum()
    assert frame_gate(np.abs(np_(st_) - np.asarray(sj))[~levels_differ], 1e-4, gut)
    assert len(shaded_levels) >= 2  # the lights' maps shadow some covered pixels
    # shadows change the shaded frame (tests/test_shadows.py:62-68)
    unlit = render_hybrid(pt, cam_t, ct, 1 << 16, lights=(), shadow_res=HYBRID_RES)[1]
    assert np.abs(np_(st_) - np_(unlit)).max() > 1e-3


# ---- per-ray shadows (rt.shadows="ray") ------------------------------------------------
#
# make_ray_shadow_fn traces one ray per point toward the light
# (ops/raytrace.trace_splats; tests/test_torch_raytrace.py holds the tracer
# to JAX's): its answers within 1e-4 on >= 99.9 % of the points and none
# beyond 1.2e-2 (a contribution flipped at a response cutoff); the hybrid
# frames with it at this file's hybrid gates.

RAY_ATOL, RAY_MAX = 1e-4, 1.2e-2


def ray_shadow_gate(got, want, label):
    per = np.abs(np_(got) - np.asarray(want)).reshape(len(want), -1).max(axis=1)
    print(f"{label}: max {per.max():.3e}, {int((per > RAY_ATOL).sum())} of {len(per)} beyond "
          f"{RAY_ATOL}")
    assert (per <= RAY_ATOL).mean() >= BP_AGREE and per.max() <= RAY_MAX, per.max()


def occluder_quads(illum, transmittance):
    """tests/test_shadows.py:188's quad as a mesh occluder, in both
    packages: a 2 x 2 square at y = -6 over the point light (0, -8, 0),
    whose shadow on the plane y = -4 is the square |x|, |z| < 2."""
    from vk_gaussian_splatting_tpu.io.obj import ObjMaterial as JObjMaterial
    from vk_gaussian_splatting_tpu.io.obj import ObjMesh as JObjMesh
    from vk_gaussian_splatting_tpu.render import mesh_raster as jmr
    from vk_gaussian_splatting_tpu_torch.io.obj import ObjMaterial, ObjMesh
    from vk_gaussian_splatting_tpu_torch.render import mesh_buffers_from_obj

    pos = np.float32([[-1, -6, -1], [1, -6, -1], [1, -6, 1], [-1, -6, 1]])
    nrm = np.tile(np.float32([[0, -1, 0]]), (4, 1))
    idx, mats = np.int32([[0, 1, 2], [0, 2, 3]]), np.zeros(2, np.int32)
    mat = dict(diffuse=(0.5, 0.5, 0.5), transmittance=transmittance, ior=1.5, illum=illum)
    return (jmr.mesh_buffers_from_obj(JObjMesh(pos, nrm, idx, mats, [JObjMaterial(**mat)])),
            mesh_buffers_from_obj(ObjMesh(pos, nrm, idx, mats, [ObjMaterial(**mat)]),
                                  device="cpu"))


RAY_SHADOW_CASES = {  # name: (lights, rt fields, mesh occluder (illum, transmittance))
    "scalar": (("point", "directional", "enclosed"), {}, None),
    "colored": (("point", "overhead"), dict(shadow_transmittance_threshold=0.2,
                                            shadow_color_strength=1.0), None),
    "glass": (("point",), {}, (4, (0.9, 0.1, 0.1))),
    "opaque": (("point",), {}, (0, (0.0, 0.0, 0.0))),
}


@pytest.mark.parametrize("case", list(RAY_SHADOW_CASES))
def test_make_ray_shadow_fn_matches_jax(hybrid_inputs, case):
    """make_ray_shadow_fn against JAX on the hybrid scene at 2000 points:
    scalar T for a point, a directional and an enclosed light; the coloured
    (..., 3) answer; a glass and an opaque quad as mesh occluders
    (tests/test_shadows.py:80, :152, :188). The answers shadow some points
    and (but for the light inside the blocker) not others; under the quad
    glass tints by its transmittance and opaque blacks out, beside it the
    points on y = -4 (below the splats) are lit."""
    pj, pt = hybrid_inputs
    light_names, rt_kw, occluder = RAY_SHADOW_CASES[case]
    cj, ct = cfgs()
    cj = cj.replace(rt=dataclasses.replace(cj.rt, shadows="ray", **rt_kw))
    ct = ct.replace(rt=dataclasses.replace(ct.rt, shadows="ray", **rt_kw))
    kw_j, kw_t = {}, {}
    if occluder is not None:
        kw_j["meshes"], kw_t["meshes"] = occluder_quads(*occluder)
    fn_j = js.make_ray_shadow_fn(pj, cj, **kw_j)
    fn_t = ts.make_ray_shadow_fn(pt, ct, **kw_t)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3.0, 3.0, (2000, 3)).astype(np.float32)
    pts[:200, 1] = -4.0  # on the plane of the quad's shadow, below the splats
    for name in light_names:
        lj, lt = both_lights(name)
        got, want = fn_t(torch.from_numpy(pts), lt), fn_j(jnp.asarray(pts), lj)
        assert got.shape == want.shape == ((2000,) if case == "scalar" else (2000, 3))
        ray_shadow_gate(got, want, f"{case} {name}")
        lit = np_(got).reshape(2000, -1).min(axis=1)
        assert (lit < 0.5).any() and (name == "enclosed" or (lit > 0.9).any())
    if occluder is not None:
        t = np_(got)[:200]
        side = np.abs(pts[:200, [0, 2]]).max(axis=1)
        under, beside = side < 1.9, side > 2.1
        assert under.sum() > 10 and beside.sum() > 10
        assert (t[beside] > 0.99).all()
        if case == "glass":
            assert (t[under, 0] > 4 * t[under, 1]).all()
        else:
            assert (t[under] == 0.0).all()


@pytest.mark.parametrize("pipeline", ["HYBRID", "HYBRID_3DGUT"])
def test_render_hybrid_ray_shadows_matches_jax(hybrid_inputs, pipeline):
    """render_hybrid with ``rt.shadows="ray"`` and two lights against the
    JAX frame: image, T, ids and normals as ``test_render_hybrid_matches_jax``,
    the shaded frame at the hybrid gates; the ray shadows darken the frame
    (against the unlit one)."""
    from vk_gaussian_splatting_tpu.render.pipelines import render_hybrid as j_hybrid
    pj, pt = hybrid_inputs
    cj, ct = cfgs()
    cj = cj.replace(pipeline=jc.Pipeline[pipeline], rt=dataclasses.replace(cj.rt, shadows="ray"))
    ct = ct.replace(pipeline=tc.Pipeline[pipeline], rt=dataclasses.replace(ct.rt, shadows="ray"))
    cam_t = gt.look_at([0, -2.0, -12.0], [0, 2.0, 0], [0, 1, 0], 64, 64, device="cpu")
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))
    lights = [both_lights(n) for n in ("point", "overhead")]
    lj, lt = tuple(a for a, _ in lights), tuple(b for _, b in lights)
    oj, sj, nj = j_hybrid(pj, cam_j, cj, 1 << 16, lights=lj)
    ot, st_, nt = render_hybrid(pt, cam_t, ct, 1 << 16, lights=lt)
    gut = pipeline == "HYBRID_3DGUT"
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        assert frame_gate(np.abs(np_(a) - np.asarray(b)), IMG_ATOL_H, gut)
    same = np.asarray(oj.splat_id) == np_(ot.splat_id)
    assert same.mean() >= BP_AGREE
    cover = ((1 - np_(ot.transmittance) > 1e-2) & (1 - np.asarray(oj.transmittance) > 1e-2))
    assert frame_gate(np.abs(np_(nt) - np.asarray(nj))[cover], 1e-4, gut)
    diff = np.abs(np_(st_) - np.asarray(sj))
    print(f"{pipeline} ray-shadowed frame: max {diff.max():.3e}, "
          f"{int((diff.max(-1) > 1e-4).sum())} pixels beyond 1e-4, {int((~same).sum())} picks apart")
    assert frame_gate(diff, 1e-4, gut)
    unlit = render_hybrid(pt, cam_t, ct, 1 << 16, lights=())[1]
    assert np.abs(np_(st_) - np_(unlit)).max() > 1e-3
