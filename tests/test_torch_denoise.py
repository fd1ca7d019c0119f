"""The a-trous denoiser (ops/denoise.py) against the JAX package's.

Tolerances: the edge-clamped shifts bit for bit; the denoised image within
1e-5 abs of the JAX one (the same operations in the same order; exp and
the division round apart by an ulp or so, measured 3e-7); the gradients of
image and transmittance within 1e-5 of each field's max abs of
``jax.grad``'s; in float64, autograd against central differences
(``torch.autograd.gradcheck``'s defaults, in its fast mode: a random
projection of the Jacobian).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vk_gaussian_splatting_tpu.ops import denoise as jd
from vk_gaussian_splatting_tpu_torch.ops import denoise as td

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_RTOL = 1e-5


def guides(h, w, seed, dtype=np.float32):
    """(image, depth, splat id, transmittance): a noisy stochastic-looking
    frame with empty pixels (depth 0, id -1) and a few id regions."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(h, w, 3)).astype(dtype)
    depth = rng.uniform(1.0, 6.0, size=(h, w)).astype(dtype)
    ids = rng.integers(0, 6, size=(h, w)).astype(np.int32)
    empty = rng.uniform(size=(h, w)) < 0.15
    depth[empty], ids[empty] = 0.0, -1
    trans = np.where(empty, 1.0, rng.uniform(size=(h, w)) * 0.3).astype(dtype)
    return img, depth, ids, trans


@pytest.mark.parametrize("dy, dx", [(1, 0), (0, -1), (-2, 3), (4, -4), (2, 2), (-4, 0)])
def test_shift_is_bit_equal_to_jax(dy, dx):
    x = np.random.default_rng(0).normal(size=(12, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(td._shift2(torch.from_numpy(x), dy, dx).numpy(),
                                  np.asarray(jd._shift2(jnp.asarray(x), dy, dx)))


@pytest.mark.parametrize("h, w, iterations", [(48, 64, 2), (37, 29, 1), (40, 48, 3)])
def test_atrous_matches_jax(h, w, iterations):
    g = guides(h, w, h)
    a = td.atrous_denoise(*(torch.from_numpy(v) for v in g), iterations=iterations)
    b = np.asarray(jd.atrous_denoise(*(jnp.asarray(v) for v in g), iterations=iterations))
    assert a.shape == (h, w, 3) and a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)


def test_atrous_gradients_match_jax():
    """d/d(image, transmittance) of a weighted sum of the denoised image:
    through the taps and through the luminance and transmittance weights."""
    img, depth, ids, trans = guides(32, 40, 3)
    wgt = np.random.default_rng(4).normal(size=img.shape).astype(np.float32)

    def loss_j(i, t):
        return jnp.sum(jd.atrous_denoise(i, jnp.asarray(depth), jnp.asarray(ids), t) * wgt)

    gj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(trans))
    i_t = torch.from_numpy(img).requires_grad_()
    t_t = torch.from_numpy(trans).requires_grad_()
    (td.atrous_denoise(i_t, torch.from_numpy(depth), torch.from_numpy(ids), t_t)
     * torch.from_numpy(wgt)).sum().backward()
    for a, b in ((i_t.grad, gj[0]), (t_t.grad, gj[1])):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert scale > 0
        assert np.abs(a.numpy() - b).max() <= GRAD_RTOL * scale


def test_atrous_autograd_against_central_differences():
    img, depth, ids, trans = guides(10, 11, 5, np.float64)
    i_t = torch.from_numpy(img).requires_grad_()
    t_t = torch.from_numpy(trans).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda i, t: td.atrous_denoise(i, torch.from_numpy(depth), torch.from_numpy(ids), t,
                                       iterations=2), (i_t, t_t), fast_mode=True)


def test_denoise_output_repeats_and_keeps_a_clean_frame():
    img, depth, ids, trans = guides(24, 32, 6)
    out = type("Out", (), {})()
    out.image, out.depth, out.splat_id, out.transmittance = (
        torch.from_numpy(v) for v in (img, depth, ids, trans))
    a, b = td.denoise_output(out), td.atrous_denoise(out.image, out.depth, out.splat_id,
                                                    out.transmittance)
    assert torch.equal(a, b) and torch.equal(a, td.denoise_output(out))
    flat = torch.full((24, 32, 3), 0.25)
    np.testing.assert_allclose(
        td.atrous_denoise(flat, out.depth, out.splat_id, out.transmittance).numpy(),
        flat.numpy(), rtol=0, atol=1e-6)
