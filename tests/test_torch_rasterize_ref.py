"""The port's naive oracle (ops/rasterize_ref.py) against the JAX
package's, on the CPU, both fed the same numpy inputs: the JAX package's
projection of one numpy scene (96 x 64 pixels, 300 splats of
tests/test_rasterize.py's shapes), its pixel rays, and the same prepared
splats. Gates: images and transmittance within 1e-5 absolute (f32 sums in
another order); the gut3d oracles flip-aware, as the port's gut3d gates
(>= 99.9 % of channels within 1e-5, none beyond 1.2e-2: a splat-pixel at
the response cutoff may flip on rounding); gradients within 1e-5 of each
field's largest magnitude. Then the oracle against the port's own frames
at the JAX tests' bounds (tests/test_rasterize.py, tests/test_gut.py).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_gaussian_splatting_tpu.config import RenderConfig as JaxRenderConfig
from vk_gaussian_splatting_tpu.ops import rasterize_ref as jref
from vk_gaussian_splatting_tpu.ops.projection import project_splats as jax_project
from vk_gaussian_splatting_tpu.ops.projection import ut_project_splats as jax_ut_project
from vk_gaussian_splatting_tpu.render.rays import build_tile_rays as jax_tile_rays
from vk_gaussian_splatting_tpu.scene.cameras import look_at as jax_look_at
from vk_gaussian_splatting_tpu.scene.splat_set import SplatSet as JaxSplatSet
import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import rasterize_ref as ref
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu_torch.render import render_3dgs, render_3dgut

torch.set_num_threads(2)

W, H, N = 96, 64, 300
ATOL = 1e-5
GUT_SHARE, GUT_MAX = 0.999, 1.2e-2
GRAD_TOL = 1e-5
BG = (0.1, 0.2, 0.3)
PROJ_FIELDS = ("xy", "conic", "depth", "radius", "color", "alpha", "valid")


@pytest.fixture(scope="module")
def scene():
    d = interop.random_splat_arrays(0, N, sh_degree=1, scale_range=(-3.0, -1.0))
    jcfg = JaxRenderConfig(width=W, height=H, sh_degree=1)
    jcam = jax_look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9)
    jprep = JaxSplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    proj = {k: np.asarray(getattr(jax_project(jprep, jcam, jcfg), k)) for k in PROJ_FIELDS}
    ut = {k: np.asarray(getattr(jax_ut_project(jprep, jcam, jcfg), k)) for k in PROJ_FIELDS}
    rays = np.asarray(jax_tile_rays(jcam, jcfg))
    full = rays.reshape(H // 16, W // 16, 8, 16, 16).transpose(0, 3, 1, 4, 2).reshape(H, W, 8)
    return dict(d=d, jcfg=jcfg, jprep=jprep, proj=proj, ut=ut, dirs=full[..., 0:3].copy(),
                origins=full[..., 3:6].copy())


def _port_proj(arrays):
    return ProjectedSplats(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


def _jax_proj(arrays):
    from vk_gaussian_splatting_tpu.ops.projection import ProjectedSplats as JaxProj
    return JaxProj(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _close(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _flip_aware(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert (diff <= ATOL).mean() >= GUT_SHARE and diff.max() <= GUT_MAX, diff.max()


def test_rasterize_naive_matches_jax(scene):
    rc = gt.RasterConfig()
    img, t = ref.rasterize_naive(_port_proj(scene["proj"]), W, H, rc, BG)
    jimg, jt = jref.rasterize_naive(_jax_proj(scene["proj"]), W, H, scene["jcfg"].raster, BG)
    _close(img.numpy(), jimg)
    _close(t.numpy(), jt)
    assert float(t.min()) < 0.9


def test_blend_ftb_matches_jax():
    rng = np.random.default_rng(5)
    alpha = rng.uniform(0, 0.999, (50, 40)).astype(np.float32)
    alpha[rng.random(alpha.shape) < 0.5] = 0.0
    color = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    rgb, t = ref.blend_ftb(torch.from_numpy(alpha), torch.from_numpy(color), BG)
    jrgb, jt = jref.blend_ftb(jnp.asarray(alpha), jnp.asarray(color), BG)
    _close(rgb.numpy(), jrgb)
    _close(t.numpy(), jt)


def _gut_args(scene, port: bool):
    d = scene["d"]
    if port:
        prepared = interop.splat_set_from_numpy(d, "cpu").prepare()
        return prepared, torch.from_numpy(scene["dirs"]), torch.from_numpy(scene["origins"])
    return scene["jprep"], jnp.asarray(scene["dirs"]), jnp.asarray(scene["origins"])


@pytest.mark.parametrize("fn", ["rasterize_naive_gut", "raytrace_naive_exact"])
@pytest.mark.parametrize("degree", [2, 4])
def test_gut_oracles_match_jax(scene, fn, degree):
    rc = gt.RasterConfig()
    prepared, dirs, origins = _gut_args(scene, port=True)
    img, t = getattr(ref, fn)(prepared, _port_proj(scene["ut"]), dirs, origins, rc,
                              kernel_degree=degree, splat_scale=1.1, background=BG)
    jprep, jdirs, jorigins = _gut_args(scene, port=False)
    jimg, jt = getattr(jref, fn)(jprep, _jax_proj(scene["ut"]), jdirs, jorigins,
                                 scene["jcfg"].raster, kernel_degree=degree,
                                 splat_scale=1.1, background=BG)
    _flip_aware(img.numpy(), jimg)
    _flip_aware(t.numpy(), jt)
    assert float(t.min()) < 0.9


def test_rasterize_naive_gradient_matches_jax(scene):
    rng = np.random.default_rng(7)
    w_img = rng.normal(size=(H, W, 3)).astype(np.float32)
    w_t = rng.normal(size=(H, W)).astype(np.float32)
    grad_fields = ("xy", "conic", "color", "alpha")

    proj = _port_proj(scene["proj"])
    for f in grad_fields:
        getattr(proj, f).requires_grad_(True)
    img, t = ref.rasterize_naive(proj, W, H)
    (torch.sum(img * torch.from_numpy(w_img)) + torch.sum(t * torch.from_numpy(w_t))).backward()

    def loss(p):
        i, tt = jref.rasterize_naive(p, W, H)
        return jnp.sum(i * w_img) + jnp.sum(tt * w_t)

    jg = jax.grad(loss, allow_int=True)(_jax_proj(scene["proj"]))
    for f in grad_fields:
        g = getattr(proj, f).grad.numpy()
        jgf = np.asarray(getattr(jg, f))
        scale = np.abs(jgf).max()
        assert scale > 0, f
        assert np.abs(g - jgf).max() <= GRAD_TOL * scale, (f, np.abs(g - jgf).max(), scale)


def test_oracles_bound_the_port_frames(scene):
    """The port's 3DGS frame within 1.5e-4 of rasterize_naive (the blender
    freezes a pixel once T < 1e-4), its 3DGUT frame within 3e-5 of
    rasterize_naive_gut (tests/test_rasterize.py, tests/test_gut.py)."""
    cfg = gt.RenderConfig(width=W, height=H, sh_degree=1)
    cam = gt.look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9, device="cpu")
    prepared = interop.splat_set_from_numpy(scene["d"], "cpu").prepare()
    out = render_3dgs(prepared, cam, cfg, max_pairs=65536)
    img, t = ref.rasterize_naive(_port_proj(scene["proj"]), W, H, cfg.raster)
    np.testing.assert_allclose(out.image.numpy(), img.numpy(), atol=1.5e-4, rtol=1e-4)
    np.testing.assert_allclose(out.transmittance.numpy(), t.numpy(), atol=1.5e-4, rtol=1e-4)
    out = render_3dgut(prepared, cam, cfg, max_pairs=65536)
    _, dirs, origins = _gut_args(scene, port=True)
    img, t = ref.rasterize_naive_gut(prepared, _port_proj(scene["ut"]), dirs, origins,
                                     cfg.raster, kernel_degree=cfg.rt.kernel_degree)
    np.testing.assert_allclose(out.image.numpy(), img.numpy(), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(out.transmittance.numpy(), t.numpy(), atol=3e-5)
