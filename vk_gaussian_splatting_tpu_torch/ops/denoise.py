"""Guided edge-aware a-trous denoiser for stochastic and DoF frames.

Counterpart of ``vk_gaussian_splatting_tpu/ops/denoise.py``: the reference's
DLSS Ray Reconstruction slot (usable 1-SPP stochastic frames) filled by an
a-trous wavelet filter (Dammertz et al. 2010) whose edge-stopping weights
read the guide buffers the renderer already makes: the luminance of the
noisy image itself, the picked depth, the picked splat id and the
transmittance. The same B3 taps, sigmas, edge-clamped shifts and order of
operations as the JAX function. Plain torch (shifts and elementwise ops,
as it is plain XLA there): no custom kernel. Differentiable in ``image``
and ``transmittance``; the depth and id guides carry no gradient. The
shifts are built from slices and ``expand``, not a gather, so the backward
adds nothing atomically and repeats bit for bit on a card.
"""

from __future__ import annotations

import torch

# B3-spline 5-tap kernel of the a-trous construction
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _shift_axis(x: torch.Tensor, k: int, axis: int) -> torch.Tensor:
    """out[i] = x[clamp(i - k, 0, n - 1)] along ``axis`` (the JAX
    ``_shift2``: a roll whose wrapped part repeats the edge)."""
    if k == 0:
        return x
    n = x.shape[axis]
    if k > 0:
        edge = x.narrow(axis, 0, 1)
        rest = x.narrow(axis, 0, n - k)
    else:
        edge = x.narrow(axis, n - 1, 1)
        rest = x.narrow(axis, -k, n + k)
    shape = list(x.shape)
    shape[axis] = abs(k)
    pad = edge.expand(shape)
    return torch.cat([pad, rest] if k > 0 else [rest, pad], dim=axis)


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-clamped 2D shift of an (H, W, ...) array."""
    return _shift_axis(_shift_axis(x, dy, 0), dx, 1)


def _luminance(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def atrous_denoise(image: torch.Tensor, depth: torch.Tensor, splat_id: torch.Tensor,
                   transmittance: torch.Tensor, iterations: int = 2,
                   sigma_lum: float = 0.35, sigma_depth: float = 0.6,
                   sigma_t: float = 0.4) -> torch.Tensor:
    """(H, W, 3) denoised image from the render's own guide buffers.

    Each iteration applies the 5x5 separable B3 a-trous kernel at dilation
    2^i with per-tap edge-stopping weights
      w = k * exp(-|lum - lum'|^2 / s_l) * exp(-|z - z'|^2 / (s_z (|z| + 0.01)))
            * (1 if id' == id else 0.4) * exp(-|T - T'|^2 / s_t),
    and divides the weighted sum by max(sum w, 1e-8) (the JAX
    ``atrous_denoise``, defaults and all). A shift needs each image side
    longer than 2^(iterations + 1)."""
    img = image
    depth = torch.where(depth > 0, depth, 0.0).detach()
    for it in range(iterations):
        step = 1 << it
        lum = _luminance(img)
        acc = torch.zeros_like(img)
        wacc = torch.zeros_like(lum)
        for iy, ky in enumerate(_B3):
            for ix, kx in enumerate(_B3):
                dy, dx = (iy - 2) * step, (ix - 2) * step
                k = ky * kx
                img_s = _shift2(img, dy, dx)
                lum_s = _shift2(lum, dy, dx)
                d_s = _shift2(depth, dy, dx)
                id_s = _shift2(splat_id, dy, dx)
                t_s = _shift2(transmittance, dy, dx)
                w_l = torch.exp(-torch.square(lum - lum_s) / sigma_lum)
                zscale = sigma_depth * (torch.abs(depth) + 1e-2)
                w_z = torch.exp(-torch.square(depth - d_s) / zscale)
                w_id = torch.where(id_s == splat_id, 1.0, 0.4)
                w_t = torch.exp(-torch.square(transmittance - t_s) / sigma_t)
                w = k * w_l * w_z * w_id * w_t
                acc = acc + img_s * w[..., None]
                wacc = wacc + w
        img = acc / torch.clamp(wacc, min=1e-8)[..., None]
    return img


def denoise_output(out, iterations: int = 2) -> torch.Tensor:
    """``atrous_denoise`` of a RenderOutput-like object (fields image,
    depth, splat_id, transmittance): the denoised image; the aux buffers
    pass through untouched."""
    return atrous_denoise(out.image, out.depth, out.splat_id, out.transmittance,
                          iterations=iterations)
