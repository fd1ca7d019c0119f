"""Image metrics and the compare tool on the CPU: the port's ops/metrics.py
and ops/compare.py against the JAX package's, on seeded numpy images, and
FLIP's reference mode against a float64 transliteration of the shader.

Tolerances:
- ``mse``, ``psnr``, ``flip`` (the per-pixel map) and ``flip_mean``, both
  modes, on random 24x24 and 96x64 pairs: 1e-5 of JAX's (both sum the blur
  tap by tap in the same order; XLA may contract multiply-adds);
- ``flip_mean`` and ``flip`` against the float64 shader oracle of
  tests/test_instances_metrics.py: 1e-3 pooled, 2e-3 per pixel (the
  module's float32 against float64);
- the gradient of ``flip_mean`` (both modes, with inputs on the clip
  bounds): 1e-4 of the largest |jax.grad|;
- ``composite`` in all six modes: 1e-6; ``ImageCompare`` samples: 1e-5
  relative; its history keeps the newest ``history`` samples.

No JAX raster program is built here (about 50 s alone, most of it JAX's
FLIP, whose blur runs eagerly tap by tap).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_gaussian_splatting_tpu.ops import compare as jcmp
from vk_gaussian_splatting_tpu.ops import metrics as jm
from vk_gaussian_splatting_tpu_torch.ops import compare as tcmp
from vk_gaussian_splatting_tpu_torch.ops import metrics as tm

torch.set_num_threads(2)

ATOL = 1e-5
ORACLE_POOLED, ORACLE_PIXEL = 1e-3, 2e-3
GRAD_RTOL = 1e-4
COMPOSITE_ATOL = 1e-6
SIZES = [(24, 24), (64, 96)]


def image_pair(h, w, seed=1, noise=0.1):
    """A random image and a noisy copy clipped to [0, 1] (so some values sit
    on the clip bounds)."""
    rng = np.random.default_rng(seed + h * w)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    return a, b


def both(*arrays):
    return [jnp.asarray(x) for x in arrays], [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("h, w", SIZES)
def test_mse_psnr_match_jax(h, w):
    (aj, bj), (at, bt) = both(*image_pair(h, w))
    np.testing.assert_allclose(float(tm.mse(at, bt)), float(jm.mse(aj, bj)), rtol=ATOL)
    np.testing.assert_allclose(float(tm.psnr(at, bt)), float(jm.psnr(aj, bj)), rtol=ATOL)
    assert float(tm.mse(at, at)) == 0.0
    assert float(tm.psnr(at, at)) == pytest.approx(120.0)
    assert float(tm.psnr(at, bt, peak=2.0)) == pytest.approx(
        float(jm.psnr(aj, bj, peak=2.0)), rel=ATOL)


@pytest.mark.parametrize("approx", [False, True], ids=["reference", "approx"])
@pytest.mark.parametrize("h, w", SIZES)
def test_flip_matches_jax(h, w, approx):
    (aj, bj), (at, bt) = both(*image_pair(h, w))
    got = tm.flip(at, bt, approx=approx)
    want = np.asarray(jm.flip(aj, bj, approx=approx))
    assert got.shape == (h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(tm.flip_mean(at, bt, approx=approx)),
                               float(jm.flip_mean(aj, bj, approx=approx)), rtol=0, atol=ATOL)
    # a different viewing distance moves the reference mode's radii
    if not approx:
        np.testing.assert_allclose(tm.flip(at, bt, pixels_per_degree=20.0).numpy(),
                                   np.asarray(jm.flip(aj, bj, pixels_per_degree=20.0)),
                                   rtol=0, atol=ATOL)


def test_blur_radii_taps_and_border():
    """The five blurs of the reference mode: radius ceil(3 sigma) of the
    float32 3 sigma (65, 33, 17, 9 and 5 px at 67 pixels per degree), taps
    normalized in numpy float32, edge padding, and the features zero inside
    each radius of the border."""
    radii = [tm.gauss_radius(max(67.0 / (f * 6.28), 0.5)) for f in tm.FLIP_FREQUENCIES]
    assert radii == [65, 33, 17, 9, 5]
    lum = np.random.default_rng(2).uniform(0, 1, (40, 30)).astype(np.float32)
    for f in tm.FLIP_FREQUENCIES:
        sigma = max(67.0 / (f * 6.28), 0.5)
        got, r = tm._gauss_blur_lum(torch.from_numpy(lum), sigma)
        want, rj = jm._gauss_blur_lum(jnp.asarray(lum), sigma)
        assert r == rj
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    img = np.random.default_rng(3).uniform(0, 1, (40, 44, 3)).astype(np.float32)
    feats = tm._spatial_features(torch.from_numpy(img), 67.0).numpy()
    for i, r in enumerate(radii):
        inner = np.zeros((40, 44), bool)
        inner[r:40 - r, r:44 - r] = True
        assert (feats[..., i][~inner] == 0).all()
        assert (feats[..., i][inner] > 0).all()
    sob = tm._sobel_lum(torch.from_numpy(img)).numpy()
    assert (sob[[0, -1]] == 0).all() and (sob[:, [0, -1]] == 0).all() and (sob[1:-1, 1:-1] > 0).all()


def test_flip_reference_mode_matches_shader_oracle():
    """flip(reference mode) against a direct per-pixel float64
    transliteration of image_compare_metric.comp.slang's Reference path
    (the oracle of tests/test_instances_metrics.py)."""
    rng = np.random.default_rng(3)
    h = w = 24
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.12, a.shape), 0, 1).astype(np.float32)

    def srgb2lin(c):
        return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)

    m = np.array([[0.31670331, 0.70299344, -0.01969366],
                  [0.10938715, 0.87060437, 0.01990658],
                  [0.01840087, 0.10476914, 0.87470614]], np.float64)

    def to_ycxcz(img):
        lms = srgb2lin(img.astype(np.float64)) @ m.T
        kc = 5.0 ** (1 / 3)
        fl = 0.2 * kc * (1 - math.exp(-0.42 * kc))
        hunt = lms * fl
        return np.stack([hunt[..., 1], hunt[..., 0] - hunt[..., 1],
                         hunt[..., 1] - hunt[..., 2]], -1)

    def csf(f):
        return math.exp(-0.5 * f) / math.sqrt(1 + (f / 4.0) ** 2)

    lumw = np.array([0.2126, 0.7152, 0.0722])
    ppd = 67.0

    def features(img):
        lum = img.astype(np.float64) @ lumw
        out = np.zeros((h, w, 5))
        for i, f in enumerate((0.5, 1.0, 2.0, 4.0, 8.0)):
            sigma = max(ppd / (f * 6.28), 0.5)
            radius = int(np.ceil(3 * sigma))
            for y in range(h):
                for x in range(w):
                    if (y < radius or x < radius or y >= h - radius
                            or x >= w - radius):
                        continue  # shader border early-out -> feature 0
                    acc = wsum = 0.0
                    for dy in range(-radius, radius + 1):
                        wy = math.exp(-dy * dy / (2 * sigma * sigma))
                        for dx in range(-radius, radius + 1):
                            wgt = wy * math.exp(-dx * dx / (2 * sigma * sigma))
                            acc += lum[y + dy, x + dx] * wgt
                            wsum += wgt
                    out[y, x, i] = abs(lum[y, x] - acc / wsum) * csf(f)
        return out

    ya, yb = to_ycxcz(a), to_ycxcz(b)
    d = np.abs(ya - yb)
    color = d[..., 0] * csf(1.0) + (d[..., 1] + d[..., 2]) * csf(1.0) * 0.4
    feat = np.abs(features(a) - features(b)).sum(-1)
    total = np.clip(color + feat, 0, 1)
    oracle = (np.mean(total ** 3)) ** (1 / 3)

    ours = float(tm.flip_mean(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(ours - oracle) < ORACLE_POOLED, (ours, oracle)
    ours_map = tm.flip(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(ours_map, total, atol=ORACLE_PIXEL)


@pytest.mark.parametrize("approx", [False, True], ids=["reference", "approx"])
def test_flip_mean_gradient_matches_jax(approx):
    a, b = image_pair(24, 32, seed=4, noise=0.15)
    assert ((b == 0) | (b == 1)).any()  # some values on the clip bounds
    want = jax.grad(lambda x, y: jm.flip_mean(x, y, approx=approx), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    tm.flip_mean(at, bt, approx=approx).backward()
    for got, w in zip((at.grad, bt.grad), want):  # the reference's gradient too
        w = np.asarray(w)
        err = np.abs(got.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, err


def test_clip_passes_half_the_gradient_on_its_bounds():
    """jnp.clip is maximum then minimum, whose ties pass half the gradient;
    torch.clamp would pass all of it."""
    x = torch.tensor([-0.5, 0.0, 0.5, 1.0, 1.5], requires_grad=True)
    tm._clip(x, 0.0, 1.0).sum().backward()
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


def test_metrics_basics():
    """The JAX package's test_metrics_basics, on the port."""
    a = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (32, 48, 3)).astype(np.float32))
    assert float(tm.mse(a, a)) == 0.0
    assert float(tm.psnr(a, a)) >= 120.0 - 1e-3
    b = torch.clamp(a + 0.1, 0, 1)
    assert 15 < float(tm.psnr(a, b)) < 25
    assert float(tm.flip_mean(a, a)) < 1e-4
    assert float(tm.flip_mean(a, 1.0 - a)) > 0.05
    assert (float(tm.flip_mean(a, torch.clamp(a + 0.02, 0, 1)))
            < float(tm.flip_mean(a, torch.clamp(a + 0.3, 0, 1))))
    m = tm.flip(a, b).numpy()
    assert m.shape == (32, 48) and (m >= 0).all() and (m <= 1).all()
    assert np.isfinite(tm.flip(a, b, approx=True).numpy()).all()


@pytest.mark.parametrize("mode", list(tcmp.CompareMode), ids=lambda m: m.name)
def test_composite_matches_jax(mode):
    (aj, bj), (at, bt) = both(*image_pair(40, 56, seed=5))
    splits = ((0.37, 3.0), (0.5, 1.0), (0.0, 0.5), (1.0, 1.0))
    if mode == tcmp.CompareMode.FLIP_HEATMAP:  # each JAX FLIP map takes seconds here
        splits = splits[:2]
    for split, amp in splits:
        got = tcmp.composite(at, bt, mode, split, amp)
        want = np.asarray(jcmp.composite(aj, bj, jcmp.CompareMode(int(mode)), split, amp))
        assert got.shape == (40, 56, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=COMPOSITE_ATOL)
        cut = int(split * 56)  # left of the split: the capture, exactly
        np.testing.assert_array_equal(got.numpy()[:, :cut], at.numpy()[:, :cut])
    with pytest.raises(ValueError):
        tcmp.composite(at, bt, 9)


def test_compare_modes_and_history():
    """The JAX package's test_compare_modes_and_history, on the port, plus
    the history's cap and samples against JAX's tool."""
    a, b = image_pair(32, 48, seed=6, noise=0.05)
    (aj, bj), (at, bt) = both(a, b)
    cmp = tcmp.ImageCompare()
    cmp.capture(at)
    for mode in tcmp.CompareMode:
        img = cmp.render(bt, mode, split_x=0.5, amplify=4.0).numpy()
        assert img.shape == (32, 48, 3) and np.isfinite(img).all()
        np.testing.assert_allclose(img[:, :24], a[:, :24], atol=1e-6)
    s1 = cmp.compute_metrics(bt)
    s2 = cmp.compute_metrics(at)
    assert s2.psnr > s1.psnr and len(cmp.history) == 2
    jcmp_tool = jcmp.ImageCompare()
    jcmp_tool.capture(aj)
    js = jcmp_tool.compute_metrics(bj)
    for f in ("mse", "psnr", "flip_mean"):
        np.testing.assert_allclose(getattr(s1, f), getattr(js, f), rtol=ATOL)
    assert s1.frame == js.frame == 0

    small = tcmp.ImageCompare(history=4)
    small.capture(at)
    for _ in range(6):
        small.compute_metrics(bt)
    assert len(small.history) == 4 and [s.frame for s in small.history] == [2, 3, 4, 5]
    small.capture(bt)
    assert small.history == [] and small.compute_metrics(bt).frame == 0
    with pytest.raises(AssertionError):
        tcmp.ImageCompare().compute_metrics(bt)
