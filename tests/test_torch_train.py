"""Training on the CPU: render-level gradients, the loss, Adam and the
densification helpers of the PyTorch port against the JAX package, plus a
finite-difference check, the overfit test and a checkpoint round trip.

Tolerances, each with its reason:
- render-level gradients of the six SplatSet fields: 1e-5 of each field's
  max abs. The two packages round the projection and the blend differently
  (XLA on the CPU contracts multiply-adds into FMAs; the suffix of the
  blend backward is a difference divided by 1 - alpha).
- losses (l1, ssim, rgb_loss) 1e-6 absolute, their image gradients 1e-5 of
  the max: f32 sums of a few thousand terms in another order.
- Adam against optax: the loss trajectories to 1e-5 relative. Parameters
  only where the first step's gradient is above 1e-3 of the field's max:
  with eps 1e-15 an Adam step is about +-lr whatever the gradient's size,
  so rounding noise that flips the sign of a near-zero gradient moves the
  parameter by 2 lr. There, within 1e-3 lr per step plus 1e-6.
- the finite-difference check: as tests/test_golden.py:93-119, 2e-2 of
  max(|fd|, |g|, 1).

JAX programs built here: jax.grad of render_3dgs for two expansions (two
Pallas programs each) and one train_step (two), six in all.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu import train as jt
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch import train as tt
from vk_gaussian_splatting_tpu_torch.io import load_ply
from vk_gaussian_splatting_tpu_torch.render import render

torch.set_num_threads(2)

REPO = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(REPO, "assets", "golden")
FIELDS = interop.SPLAT_FIELDS
GRAD_RTOL = 1e-5
LOSS_ATOL = 1e-6


def to_jax(d):
    return jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})


def leaf_splats(d):
    s = interop.splat_set_from_numpy(d, "cpu")
    for f in FIELDS:
        getattr(s, f).requires_grad_()
    return s


def cam_pair(w, h, eye=(0.2, -0.3, -9.0)):
    cam_t = gt.look_at(list(eye), [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9, device="cpu")
    return cam_t, jcam.make_camera(**interop.camera_to_numpy(cam_t))


def assert_fields_close(got: dict, want: dict, rtol):
    for f in FIELDS:
        a, b = np.asarray(got[f], np.float64), np.asarray(want[f], np.float64)
        scale = np.abs(b).max()
        assert scale > 0, f"{f}: the reference gradient is zero"
        err = np.abs(a - b).max() / scale
        assert err <= rtol, (f, err)


@pytest.mark.parametrize("expansion, max_pairs", [("slots", 0), ("exact", 1 << 16)])
def test_render_gradients_match_jax(expansion, max_pairs):
    """Weighted image plus weighted transmittance, as test_rasterize.py:117-143."""
    d = interop.random_splat_arrays(0, 2500, sh_degree=1, scale_range=(-3.5, -1.5))
    w, h = 128, 96
    rng = np.random.default_rng(7)
    wimg = rng.normal(size=(h, w, 3)).astype(np.float32)
    wt = rng.normal(size=(h, w)).astype(np.float32)
    cam_t, cam_j = cam_pair(w, h)
    raster = dict(expansion=expansion)
    cj = jc.RenderConfig(width=w, height=h, sh_degree=1, raster=jc.RasterConfig(**raster))
    ct = tc.RenderConfig(width=w, height=h, sh_degree=1, raster=tc.RasterConfig(**raster))

    def loss_j(s):
        o = j_render(s.prepare(), cam_j, cj, max_pairs=max_pairs)
        return jnp.sum(o.image * wimg) + jnp.sum(o.transmittance * wt)

    g_j = jax.jit(jax.grad(loss_j))(to_jax(d))
    s = leaf_splats(d)
    o = render(s.prepare(), cam_t, ct, max_pairs=max_pairs)
    assert not bool(o.overflow)
    (torch.sum(o.image * torch.from_numpy(wimg))
     + torch.sum(o.transmittance * torch.from_numpy(wt))).backward()
    assert_fields_close({f: getattr(s, f).grad.numpy() for f in FIELDS},
                        {f: np.asarray(getattr(g_j, f)) for f in FIELDS}, GRAD_RTOL)


@pytest.fixture(scope="module")
def golden_small():
    meta = json.load(open(os.path.join(GOLDEN, "meta.json")))
    assert meta["recipe"]["res"]
    splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device="cpu")
    cfg = tc.RenderConfig(width=128, height=96, sh_degree=0)
    cam = gt.look_at([0, -1.5, -7.0], [0, 0.5, 0], [0, 1, 0], cfg.width, cfg.height,
                     fov_y_rad=0.9, device="cpu")
    return splats, cfg, cam


def test_golden_gradients_finite_difference(golden_small):
    """The central-difference check of tests/test_golden.py:93-119 through
    the port: d(sum image^2)/d opacity of 4 high-gradient splats. The sum
    is taken in float64, so the difference quotient sees the image's f32
    rounding and not the sum's (a float32 sum of 36,864 squares is
    quantized at ~1e-4, and 2 eps = 0.02 turns that into ~1e-2)."""
    splats, cfg, cam = golden_small

    def loss(op):
        s = dataclasses.replace(splats, opacities=op)
        return torch.sum(render(s.prepare(), cam, cfg).image.double() ** 2)

    op0 = splats.opacities.clone().requires_grad_()
    loss(op0).backward()
    g = op0.grad.numpy()
    rng = np.random.default_rng(0)
    idx = rng.choice(np.nonzero(np.abs(g) > np.quantile(np.abs(g), 0.99))[0], 4,
                     replace=False)
    eps = 1e-2
    with torch.no_grad():
        for i in idx:
            op = splats.opacities.clone()
            op[i] += eps
            lp = float(loss(op))
            op[i] -= 2 * eps
            lm = float(loss(op))
            fd = (lp - lm) / (2 * eps)
            assert abs(fd - g[i]) < 2e-2 * max(abs(fd), abs(g[i]), 1.0), (i, fd, g[i])


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fj, ft in ((jt.l1_loss, tt.l1_loss), (jt.ssim, tt.ssim), (jt.rgb_loss, tt.rgb_loss)):
        assert abs(float(fj(ja, jb)) - float(ft(ta, tb))) <= LOSS_ATOL, fj.__name__
    assert abs(float(tt.ssim(ta, ta)) - 1.0) < 1e-5
    assert float(tt.ssim(ta, tb)) < 0.9
    # the loss's image gradient, through the blur's edge padding
    g_j = np.asarray(jax.grad(jt.rgb_loss)(ja, jb))
    tp = ta.clone().requires_grad_()
    tt.rgb_loss(tp, tb).backward()
    assert np.abs(tp.grad.numpy() - g_j).max() <= 1e-5 * np.abs(g_j).max()


def overfit_scene():
    """The scene of tests/test_train.py:33-63 from numpy: 120 splats, SH 0,
    a 64x48 view, and the target's means and sh_dc jittered."""
    d = interop.random_splat_arrays(0, 120, sh_degree=0, scale_range=(-2.2, -1.2))
    rng = np.random.default_rng(1)
    init = dict(d)
    init["means"] = (d["means"] + 0.1 * rng.normal(size=d["means"].shape)).astype(np.float32)
    init["sh_dc"] = (d["sh_dc"] + 0.3 * rng.normal(size=d["sh_dc"].shape)).astype(np.float32)
    return d, init


def test_adam_steps_match_optax():
    d, init = overfit_scene()
    w, h = 64, 48
    cam_t, cam_j = cam_pair(w, h, eye=(0, 0, -9))
    cj = jc.RenderConfig(width=w, height=h, sh_degree=0)
    ct = tc.RenderConfig(width=w, height=h, sh_degree=0)
    tcfg_j = jt.TrainConfig(scene_extent=3.0, lr_means=2e-3)
    tcfg_t = tt.TrainConfig(scene_extent=3.0, lr_means=2e-3)
    target = np.array(j_render(to_jax(d).prepare(), cam_j, cj).image)

    opt = jt.make_optimizer(tcfg_j)
    sj = to_jax(init)
    state = opt.init(sj)
    losses_j = []
    for _ in range(3):
        sj, state, loss, _ = jt.train_step(sj, state, cam_j, jnp.asarray(target), cj, 0,
                                           tcfg_j, opt)
        losses_j.append(float(loss))

    st = interop.splat_set_from_numpy(init, "cpu")
    opt_t = tt.make_optimizer(st, tcfg_t)
    losses_t, first_grads = [], None
    for _ in range(3):
        loss, _ = tt.train_step(st, opt_t, cam_t, torch.from_numpy(target), ct, 0, tcfg_t)
        losses_t.append(float(loss))
        if first_grads is None:
            first_grads = {f: torch.zeros_like(getattr(st, f)) if getattr(st, f).grad is None
                           else getattr(st, f).grad.clone() for f in FIELDS}
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert losses_t[-1] < losses_t[0]

    lrs = {g["name"]: g["lr"] for g in opt_t.param_groups}
    for f in FIELDS:
        g = first_grads[f].abs().numpy()
        if g.size == 0:  # sh_rest of an SH-0 scene
            continue
        sure = g > 1e-3 * g.max()
        got = getattr(st, f).detach().numpy()[sure]
        want = np.asarray(getattr(sj, f))[sure]
        assert np.abs(got - want).max() <= 3 * 1e-3 * lrs[f] + 1e-6, f
        assert sure.mean() > 0.2, f


def test_overfit_single_view():
    """A jittered splat set recovers a rendered target (test_train.py:33-63)."""
    d, init = overfit_scene()
    w, h = 64, 48
    cfg = tc.RenderConfig(width=w, height=h, sh_degree=0)
    cam = gt.look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], w, h, device="cpu")
    with torch.no_grad():
        target = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg).image
    splats = interop.splat_set_from_numpy(init, "cpu")
    tcfg = tt.TrainConfig(scene_extent=3.0, lr_means=2e-3)
    opt = tt.make_optimizer(splats, tcfg)

    def psnr(img):
        return 10 * np.log10(1.0 / float(torch.mean((img - target) ** 2)))

    with torch.no_grad():
        p0 = psnr(render(splats.prepare(), cam, cfg).image)
    losses = []
    for _ in range(60):
        loss, overflow = tt.train_step(splats, opt, cam, target, cfg, 0, tcfg)
        losses.append(float(loss))
    assert not bool(overflow)
    with torch.no_grad():
        p1 = psnr(render(splats.prepare(), cam, cfg).image)
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])
    assert p1 > p0 + 3.0, (p0, p1)


def test_prune_densify_reset_match_jax():
    d = interop.random_splat_arrays(2, 100, sh_degree=1)
    d["opacities"][:50] = -10.0  # transparent half
    d["scales"][60:70] = np.log(0.5)  # big: these split
    pj = jt.prune_splats(to_jax(d))
    pt = tt.prune_splats(interop.splat_set_from_numpy(d, "cpu"))
    assert pt.num_splats == pj.num_splats == 50
    for k, v in interop.splat_set_to_numpy(pt).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(pj, k)))

    rng = np.random.default_rng(4)
    g = np.zeros((50, 3), np.float32)
    g[:30] = rng.normal(size=(30, 3))
    gj = jt.densify_split(pj, jnp.asarray(g), grad_threshold=0.5, seed=3)
    gtt = tt.densify_split(pt, torch.from_numpy(g), grad_threshold=0.5, seed=3)
    assert gtt.num_splats == gj.num_splats > 50
    for k, v in interop.splat_set_to_numpy(gtt).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(gj, k)))

    rj = jt.reset_opacities(gj, ceiling=0.01)
    rt = tt.reset_opacities(gtt, ceiling=0.01)
    np.testing.assert_allclose(rt.opacities.numpy(), np.asarray(rj.opacities), rtol=1e-6)
    assert float(torch.sigmoid(rt.opacities).max()) <= 0.01 + 1e-6


def test_checkpoint_roundtrip(tmp_path):
    d, init = overfit_scene()
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=0)
    cam = gt.look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], 64, 48, device="cpu")
    with torch.no_grad():
        target = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg).image
    tcfg = tt.TrainConfig(scene_extent=3.0)
    splats = interop.splat_set_from_numpy(init, "cpu")
    opt = tt.make_optimizer(splats, tcfg)
    tt.train_step(splats, opt, cam, target, cfg, 0, tcfg)
    path = str(tmp_path / "ckpt.pt")
    tt.save_checkpoint(path, splats, opt, step=42)
    assert os.listdir(tmp_path) == ["ckpt.pt"]  # no temporary file left behind
    s2, opt2, step = tt.load_checkpoint(path, tcfg, device="cpu")
    assert step == 42
    for f in FIELDS:
        assert torch.equal(getattr(s2, f), getattr(splats, f).detach())
    # resuming takes the same step as going on
    tt.train_step(splats, opt, cam, target, cfg, 0, tcfg)
    tt.train_step(s2, opt2, cam, target, cfg, 0, tcfg)
    for f in FIELDS:
        assert torch.equal(getattr(s2, f), getattr(splats, f)), f


def test_make_optimizer_groups():
    """One Adam group per field with the JAX package's learning rates,
    betas and eps (train.py:90-109 there)."""
    tcfg = tt.TrainConfig(scene_extent=3.0)
    opt = tt.make_optimizer(interop.splat_set_from_numpy(
        interop.random_splat_arrays(0, 4, sh_degree=0), "cpu"), tcfg)
    assert [g["name"] for g in opt.param_groups] == list(FIELDS)
    assert all(g["eps"] == 1e-15 and g["betas"] == (0.9, 0.999) for g in opt.param_groups)
    assert [g["lr"] for g in opt.param_groups] == [
        tcfg.lr_means * 3.0, tcfg.lr_scales, tcfg.lr_quats, tcfg.lr_opacities,
        tcfg.lr_sh_dc, tcfg.lr_sh_rest]
