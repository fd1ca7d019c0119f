"""Lighting on the raster path on the CPU: the port's render/deferred.py,
``quat_to_rotmat`` and ``render_3dgs_lit`` against the JAX package's, on one
numpy input (the JAX kernels in interpret mode, as tests/test_lighting.py
runs them).

Tolerances:
- ``quat_to_rotmat``, ``compute_splat_normals``: 1e-6 (float32 operations
  in the same order; the 3x3 products and norms may sum in another), with
  splats of none, one and two thin axes (all three branches).
- ``instance_index_image``: exact.
- ``deferred_shade`` on given buffers, with one material, per-set
  materials, and shadow functions answering (H, W) and (H, W, 3): 1e-5.
- ``render_3dgs_lit``: the image, T, depth and ids at the gs2d gates of
  tests/test_torch_render.py (5e-5 on >= 99.9 % of values, none beyond
  1.2e-2; ids on >= 99.9 % of pixels; depth within 1e-5 where the ids
  agree); the normals within 1e-4 where 1 - T > 1e-2 (where 1 - T is near 0
  the division by it is ill-conditioned); the shaded image within 1e-4 on
  >= 99.9 % of channels (a flipped pick moves a pixel's world position, as
  the ids' gate allows), none beyond 1.2e-2.
- the gradient of a weighted sum of the shaded image with respect to the
  PreparedSplats fields against ``jax.grad``: 1e-5 of each field's max
  (the render-level gradient gate of the gs2d frame); it crosses the
  normal buffer and the shade. ``jax.grad`` is NaN for every splat that
  shares a tile with a pixel no splat touches (the normal buffer's
  ``jnp.linalg.norm`` of a zero vector has a NaN gradient, and the blend's
  backward sums 0 * NaN over the tile's pixels; ROADMAP.md queue 3), where
  torch's norm has the zero subgradient: so the compared scene has a
  backdrop that touches every pixel, and on the scene with empty pixels the
  port's gradient must be finite where JAX's is NaN.

JAX programs built here: two lit frames and one gradient (about 35 s
alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.render import deferred as jd
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs_lit as j_lit
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import lights as jl
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.render import deferred as td
from vk_gaussian_splatting_tpu_torch.render import render_3dgs_lit
from vk_gaussian_splatting_tpu_torch.scene import lights as tl
from vk_gaussian_splatting_tpu_torch.scene.splat_set import PreparedSplats, quat_to_rotmat

torch.set_num_threads(2)

RTOL = 1e-6
SHADE_ATOL = 1e-5
IMG_ATOL, IMG_SHARE, IMG_MAX = 5e-5, 0.999, 1.2e-2
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999
NORMAL_ATOL, COVERAGE_MIN = 1e-4, 1e-2
LIT_ATOL = 1e-4
GRAD_RTOL = 1e-5
W, H = 64, 48
PREPARED_FIELDS = ("means", "cov3d", "color", "sh", "scales_log", "quats")


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def scene_arrays(seed=0, n=200, thin=True):
    """The lit scene (tests/test_lighting.py's make_scene sizes): splats of
    scale e^-2.5..e^-1.2 before a camera at z = -10, with one thin axis on
    every fifth splat and two on every seventh (below 1e-3)."""
    d = interop.random_splat_arrays(seed, n, sh_degree=0, scale_range=(-2.5, -1.2))
    if thin:
        d["scales"][::5, 1] = -8.0
        d["scales"][::7, 0] = -9.0
        d["scales"][::7, 2] = -8.5
    return d


def both_prepared(d):
    return (jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare(),
            interop.splat_set_from_numpy(d, "cpu").prepare())


def both_cameras(w=W, h=H):
    cam_t = gt.look_at([0.3, -0.4, -10.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                       device="cpu")
    return jcam.make_camera(**interop.camera_to_numpy(cam_t)), cam_t


LIGHTS = (
    dict(light_type=tl.LightType.POINT, position=(2.0, -3.0, -6.0), intensity=1.5,
         attenuation=tl.AttenuationMode.QUADRATIC),
    dict(light_type=tl.LightType.SPOT, position=(-3.0, -2.0, -8.0), direction=(0.3, 0.2, 1.0),
         color=(1.0, 0.8, 0.6), inner_cone_deg=10.0, outer_cone_deg=25.0),
    dict(light_type=tl.LightType.DIRECTIONAL, direction=(0.2, 1.0, 0.5), intensity=0.7),
)


def both_lights():
    js_, ts_ = [], []
    for kw in LIGHTS:
        kw = dict(kw)
        kind = kw.pop("light_type")
        att = kw.pop("attenuation", tl.AttenuationMode.NONE)
        js_.append(jl.make_light(jl.LightType(int(kind)), attenuation=jl.AttenuationMode(int(att)),
                                 **kw))
        ts_.append(tl.make_light(kind, attenuation=att, **kw, device="cpu"))
    return tuple(js_), tuple(ts_)


MATERIALS = (
    dict(diffuse=(0.9, 0.8, 0.7), ambient=(0.1, 0.1, 0.12), specular=(0.4, 0.4, 0.4),
         shininess=16.0, emission=(0.05, 0.0, 0.02)),
    dict(diffuse=(0.3, 0.6, 0.9), ambient=(0.2, 0.15, 0.1), specular=(0.8, 0.7, 0.6),
         shininess=3.0, emission=(0.0, 0.1, 0.0)),
)


def both_materials(per_set: bool):
    mats = MATERIALS if per_set else MATERIALS[:1]
    mj = tuple(jd.DeferredMaterial(**m) for m in mats)
    mt = tuple(td.DeferredMaterial(**m) for m in mats)
    return (mj, mt) if per_set else (mj[0], mt[0])


# ---- pure functions ------------------------------------------------------------------

def test_quat_to_rotmat_matches_jax():
    q = np.random.default_rng(0).normal(size=(300, 4)).astype(np.float32)
    q[:3] = [[0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 0, 2]]
    got = quat_to_rotmat(torch.from_numpy(q))
    want = jss.quat_to_rotmat(jnp.asarray(q))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL, atol=RTOL)
    r = got[3:].double()
    eye = torch.eye(3, dtype=torch.float64).expand_as(r)
    assert torch.allclose(r @ r.transpose(1, 2), eye, atol=1e-5)


def test_compute_splat_normals_matches_jax():
    d = scene_arrays(n=300)
    pj, pt = both_prepared(d)
    cj, ct = both_cameras()
    thin = (np.exp(d["scales"]) < 1e-3).sum(1)
    assert {0, 1, 2} <= set(thin.tolist())  # every branch runs
    for scale in (1.0, 0.5):
        got = td.compute_splat_normals(pt, ct.position, splat_scale=scale)
        want = jd.compute_splat_normals(pj, cj.position, splat_scale=scale)
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL, atol=RTOL)
    n = np_(got)
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
    to_cam = np_(ct.position) - d["means"]
    assert (np.sum(n * to_cam, axis=1) >= -1e-6).all()  # outward


def test_instance_index_image_is_exact():
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 700, (H, W)).astype(np.int32)
    ids[0, :4] = [0, 199, 200, 699]
    for base in ((0, 700), (0, 200, 700), (0, 200, 450, 700)):
        got = td.instance_index_image(torch.from_numpy(ids), base)
        want = jd.instance_index_image(jnp.asarray(ids), base)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np_(got), np.asarray(want))
    assert np_(got)[0, :4].tolist() == [0, 0, 1, 2]


def shading_buffers(seed=2):
    """Seeded G-buffers: an image, T, normals (some zero: uncovered), picked
    depths (some 0: no pick), and a per-pixel set index."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    trans = rng.uniform(0, 1, (H, W)).astype(np.float32)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm[rng.uniform(size=(H, W)) < 0.1] = 0.0
    depth = rng.uniform(6.0, 14.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    sets = rng.integers(0, 2, (H, W)).astype(np.int32)
    return img, trans, nrm, depth, sets


def shadow_fns():
    """The same shadow function in both packages: (H, W) or (H, W, 3)."""
    def mono_j(p, light):
        return 0.5 + 0.5 * jnp.sin(p[..., 0] * 1.3 + light.intensity)

    def mono_t(p, light):
        return 0.5 + 0.5 * torch.sin(p[..., 0] * 1.3 + light.intensity)

    def rgb_j(p, light):
        return 0.5 + 0.5 * jnp.cos(p * jnp.asarray([0.7, 1.1, 1.9]))

    def rgb_t(p, light):
        return 0.5 + 0.5 * torch.cos(p * torch.tensor([0.7, 1.1, 1.9]))

    return {"none": (None, None), "mono": (mono_j, mono_t), "rgb": (rgb_j, rgb_t)}


@pytest.mark.parametrize("material, shadow", [("one", "none"), ("per_set", "none"),
                                              ("one", "mono"), ("per_set", "rgb"),
                                              ("headlight", "none")])
def test_deferred_shade_matches_jax(material, shadow):
    img, trans, nrm, depth, sets = shading_buffers()
    cj, ct = both_cameras()
    lj, lt = both_lights()
    if material == "headlight":
        lj, lt = (), ()
    mj, mt = both_materials(material == "per_set")
    sj, st_ = shadow_fns()[shadow]
    cfg_j, cfg_t = jc.RenderConfig(width=W, height=H), tc.RenderConfig(width=W, height=H)
    per_set = material == "per_set"
    want = jd.deferred_shade(jnp.asarray(img), jnp.asarray(trans), jnp.asarray(nrm),
                             jnp.asarray(depth), cj, cfg_j, list(lj), mj, shadow_fn=sj,
                             set_index_img=jnp.asarray(sets) if per_set else None)
    got = td.deferred_shade(torch.from_numpy(img), torch.from_numpy(trans),
                            torch.from_numpy(nrm), torch.from_numpy(depth), ct, cfg_t, list(lt),
                            mt, shadow_fn=st_,
                            set_index_img=torch.from_numpy(sets) if per_set else None)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=SHADE_ATOL, atol=SHADE_ATOL)
    uncovered = (np.linalg.norm(nrm, axis=-1) <= 1e-3) | (depth <= 0)
    np.testing.assert_array_equal(np_(got)[uncovered], img[uncovered])
    assert np.abs(np_(got) - img)[~uncovered].max() > 1e-2  # the shade changes covered pixels


def test_per_set_materials_need_an_index():
    img, trans, nrm, depth, _ = shading_buffers()
    _, ct = both_cameras()
    _, mt = both_materials(True)
    with pytest.raises(ValueError, match="set_index_img"):
        td.deferred_shade(*(torch.from_numpy(a) for a in (img, trans, nrm, depth)), ct,
                          tc.RenderConfig(width=W, height=H), None, mt)
    d = scene_arrays(n=50)
    _, pt = both_prepared(d)
    with pytest.raises(ValueError, match="instance_base"):
        render_3dgs_lit(pt, ct, tc.RenderConfig(width=W, height=H, sh_degree=0), material=mt)


# ---- render_3dgs_lit against JAX --------------------------------------------------------

def lit_scene(per_set: bool):
    """One scene, or two translated copies of it as two instances
    (instance_base (0, n, 2n)), by hand."""
    d = scene_arrays(n=150)
    if not per_set:
        return d, ()
    e = {k: v.copy() for k, v in d.items()}
    e["means"] = e["means"] * 0.6 + np.float32([1.5, 0.5, 1.0])
    n = d["means"].shape[0]
    return {k: np.concatenate([d[k], e[k]]) for k in d}, (0, n, 2 * n)


@pytest.fixture(scope="module", params=["one", "per_set"])
def lit(request):
    per_set = request.param == "per_set"
    d, base = lit_scene(per_set)
    pj, pt = both_prepared(d)
    cj, ct = both_cameras()
    lj, lt = both_lights()
    mj, mt = both_materials(per_set)
    cfg_j = jc.RenderConfig(width=W, height=H, sh_degree=0, background=(0.1, 0.2, 0.3))
    cfg_t = tc.RenderConfig(width=W, height=H, sh_degree=0, background=(0.1, 0.2, 0.3))
    oj = j_lit(pj, cj, cfg_j, 0, lights=lj, material=mj, instance_base=base)
    ot = render_3dgs_lit(pt, ct, cfg_t, 0, lights=lt, material=mt, instance_base=base)
    return oj, ot


def test_lit_frame_matches_jax(lit):
    (oj, _, _), (ot, _, _) = lit
    assert bool(oj.overflow) == bool(ot.overflow) and int(oj.num_pairs) == int(ot.num_pairs)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(np_(a) - np.asarray(b))
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    id_j, id_t = np.asarray(oj.splat_id), np_(ot.splat_id)
    same = id_j == id_t
    assert same.mean() >= ID_AGREE
    both = same & (id_j >= 0)
    assert both.mean() > 0.2
    np.testing.assert_allclose(np_(ot.depth)[both], np.asarray(oj.depth)[both], rtol=0,
                               atol=DEPTH_ATOL)


def test_lit_normals_match_jax(lit):
    (oj, _, nj), (ot, _, nt) = lit
    cover = (1.0 - np_(ot.transmittance) > COVERAGE_MIN) & (
        1.0 - np.asarray(oj.transmittance) > COVERAGE_MIN)
    assert cover.mean() > 0.2
    diff = np.abs(np_(nt) - np.asarray(nj))[cover]
    assert diff.max() <= NORMAL_ATOL, diff.max()
    np.testing.assert_allclose(np.linalg.norm(np_(nt)[cover], axis=-1), 1.0, atol=1e-5)


def test_lit_shaded_matches_jax(lit):
    (oj, sj, _), (ot, st_, _) = lit
    diff = np.abs(np_(st_) - np.asarray(sj))
    print(f"shaded: max {diff.max():.3e}, share within {LIT_ATOL:g} "
          f"{(diff <= LIT_ATOL).mean():.6f}")
    assert (diff <= LIT_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    covered = np_(ot.depth) > 0
    assert np.abs(np_(st_) - np_(ot.image))[covered].max() > 1e-2


def with_backdrop(d, z=5.0):
    """``d`` and nine wide splats at depth ``z``: behind it at z = 5 they
    touch every pixel; behind the camera (z = -30) none."""
    gx, gy = np.meshgrid([-6.0, 0.0, 6.0], [-6.0, 0.0, 6.0])
    k = gx.size
    back = dict(means=np.stack([gx.ravel(), gy.ravel(), np.full(k, z)], 1),
                scales=np.full((k, 3), 1.4), quats=np.tile([1.0, 0.0, 0.0, 0.0], (k, 1)),
                opacities=np.zeros(k), sh_dc=np.full((k, 3), 0.3), sh_rest=np.zeros((k, 0, 3)))
    return {f: np.concatenate([d[f], back[f].astype(np.float32)]) for f in d}


def lit_gradients(d, cj, ct, lj, lt, mj, mt, w):
    """(jax.grad, the port's autograd) of sum(w * shaded) in the
    PreparedSplats fields."""
    pj, pt = both_prepared(d)
    cfg_j = jc.RenderConfig(width=W, height=H, sh_degree=0)
    cfg_t = tc.RenderConfig(width=W, height=H, sh_degree=0)

    def loss_j(p):
        return jnp.sum(j_lit(p, cj, cfg_j, 0, lights=lj, material=mj)[1] * w)

    gj = jax.grad(loss_j)(pj)
    leaves = {f: getattr(pt, f).detach().clone().requires_grad_() for f in PREPARED_FIELDS}
    shaded = render_3dgs_lit(PreparedSplats(**leaves), ct, cfg_t, 0, lights=lt, material=mt)[1]
    (shaded * torch.from_numpy(w)).sum().backward()
    return gj, leaves


def test_lit_gradient_matches_jax():
    """jax.grad of sum(w * shaded) in the PreparedSplats fields against the
    port's autograd (K2's twin for both passes, the binning backward, the
    normals and the shade), on a scene that touches every pixel; with empty
    pixels the port's gradient stays finite where JAX's is NaN."""
    d = scene_arrays(n=120)
    cj, ct = both_cameras()
    lj, lt = both_lights()
    mj, mt = both_materials(False)
    w = np.random.default_rng(3).uniform(-1, 1, (H, W, 3)).astype(np.float32)
    # the same shapes twice (one JAX program): the backdrop behind the camera
    gj, leaves = lit_gradients(with_backdrop(d, z=-30.0), cj, ct, lj, lt, mj, mt, w)
    assert np.isnan(np.asarray(gj.means)).any()  # the reference's NaN (empty pixels)
    assert all(bool(torch.isfinite(leaves[f].grad).all()) for f in PREPARED_FIELDS
               if leaves[f].numel())
    gj, leaves = lit_gradients(with_backdrop(d), cj, ct, lj, lt, mj, mt, w)
    for f in PREPARED_FIELDS:
        want = np.asarray(getattr(gj, f))
        if want.size == 0:
            continue
        got = np_(leaves[f].grad)
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        print(f"{f}: max err / field max {err / max(scale, 1e-30):.3e}")
        assert scale > 0 and err <= GRAD_RTOL * scale, (f, err, scale)
