"""Image comparison metrics: MSE / PSNR / FLIP (counterpart of
``vk_gaussian_splatting_tpu/ops/metrics.py``).

Re-implements the reference's GPU metric passes (image_compare_metric.comp.slang;
ImageCompare) as tensor code:

- MSE / PSNR over RGB.
- FLIP in both reference modes, behaviourally matched to the shader:
  - "reference" (image_compare_metric.comp.slang:186-305, 483-543): the
    5-frequency-channel Gaussian feature pyramid (0.5/1/2/4/8 cpd
    |center - blur| responses, sigma = ppd/(2*pi*f) clamped to 0.5 px, zero
    within the kernel radius of the border) with Barten-style CSF weighting,
    plus the CSF-weighted YCxCz colour difference, Minkowski-pooled at q=3;
  - "approx" (:369-479): the single-scale Sobel fast path with the shader's
    empirical 3.83 feature calibration.
  Colour pipeline (color.h.slang:44-142): sRGB -> linear -> Hunt-Pointer-
  Estevez LMS -> Hunt luminance adaptation -> YCxCz opponent space.

The separable blur is a loop of shifted slices of the edge-padded image,
tap by tap in the JAX module's order (out = out + k[i] * slice_i, rows
first, then columns), not a convolution: it sets the summation order, and
no library convolution (nor its TF32 path) is involved. The 3x3 colour
transforms and the luminance weights are float32 multiply-adds, not
matmuls. Everything is differentiable through autograd, so the metrics
serve as training losses too; the clips pass JAX's gradient at their
bounds (``_clip``), so the gradients are ``jax.grad``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FLIP_FREQUENCIES = (0.5, 1.0, 2.0, 4.0, 8.0)
FLIP_APPROX_FEATURE_WEIGHT = 3.83   # shader calibration constant (:391)
_LUM = (0.2126, 0.7152, 0.0722)

# Hunt-Pointer-Estevez RGB->LMS (color.h.slang:90-94)
_RGB_TO_LMS = (
    (0.31670331, 0.70299344, -0.01969366),
    (0.10938715, 0.87060437, 0.01990658),
    (0.01840087, 0.10476914, 0.87470614),
)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, so a value on a bound passes half
    its gradient (torch.maximum / minimum split ties as JAX's do), where
    ``torch.clamp`` would pass all of it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    m = mse(a, b)
    return 10.0 * torch.log10(peak * peak / torch.clamp(m, min=1e-12))


def _mix3(img: torch.Tensor, w) -> torch.Tensor:
    """(..., 3) -> (...,): the weights' float32 multiply-adds in order."""
    return img[..., 0] * _f32(w[0]) + img[..., 1] * _f32(w[1]) + img[..., 2] * _f32(w[2])


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _srgb_to_flip_space(srgb: torch.Tensor, adaptation_luminance: float = 1.0) -> torch.Tensor:
    """sRGB -> YCxCz through linear/LMS/Hunt (color.h.slang:135-142)."""
    lin = _srgb_to_linear(srgb)
    lms = torch.stack([_mix3(lin, row) for row in _RGB_TO_LMS], dim=-1)
    k = 5.0 * adaptation_luminance
    k_cbrt = k ** (1.0 / 3.0)
    f_l = 0.2 * k_cbrt * (1.0 - math.exp(-0.42 * k_cbrt))
    hunt = lms * _f32(f_l)
    y = hunt[..., 1]
    cx = hunt[..., 0] - hunt[..., 1]
    cz = hunt[..., 1] - hunt[..., 2]
    return torch.stack([y, cx, cz], -1)


def _csf_luminance(freq_cpd: float) -> float:
    """Barten-style CSF (image_compare_metric.comp.slang:196-208)."""
    s = 1.0 / math.sqrt(1.0 + (freq_cpd / 4.0) ** 2)
    return s * math.exp(-0.5 * freq_cpd)


def _csf_chrominance(freq_cpd: float) -> float:
    return _csf_luminance(freq_cpd) * 0.4


def _edge_pad(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Edge padding of ``r`` along ``dim`` (0 or 1) of an (H, W) image, by
    expand and cat (its backward is a plain sum, deterministic)."""
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    shape = list(x.shape)
    shape[dim] = r
    return torch.cat([first.expand(shape), x, last.expand(shape)], dim=dim)


def gauss_radius(sigma: float) -> int:
    """The blur's radius: ceil(3 sigma), at least 1."""
    return max(int(math.ceil(_f32(3.0 * sigma))), 1) if sigma > 0 else 1


def _gauss_blur_lum(lum: torch.Tensor, sigma: float) -> tuple[torch.Tensor, int]:
    """Separable Gaussian blur of an (H,W) luminance image with the shader's
    kernel (exp(-x^2/2s^2), normalized over the sampled window in numpy
    float32), edge-padded; the border region inside the radius is masked by
    the caller. Returns (blurred, radius)."""
    radius = gauss_radius(sigma)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    h, w = lum.shape
    pad = _edge_pad(lum, radius, 0)
    out = torch.zeros_like(lum)
    for i in range(2 * radius + 1):
        out = out + float(k[i]) * pad[i:i + h]
    pad = _edge_pad(out, radius, 1)
    out2 = torch.zeros_like(lum)
    for i in range(2 * radius + 1):
        out2 = out2 + float(k[i]) * pad[:, i:i + w]
    return out2, radius


def _border_mask(h: int, w: int, radius: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= radius) & (yy < h - radius) & (xx >= radius) & (xx < w - radius)


def _spatial_features(img: torch.Tensor, ppd: float) -> torch.Tensor:
    """(H,W,5) CSF-weighted multi-scale features (computeSpatialFeatures,
    :266-305): |center_lum - gaussian_blur| per frequency channel, zero
    inside the kernel radius of the border (the shader's border early-out)."""
    lum = _mix3(img, _LUM)
    h, w = lum.shape
    feats = []
    for f in FLIP_FREQUENCIES:
        sigma = max(ppd / (f * 6.28), 0.5)
        blurred, radius = _gauss_blur_lum(lum, sigma)
        feat = torch.abs(lum - blurred) * _f32(_csf_luminance(f))
        feat = torch.where(_border_mask(h, w, radius, img.device), feat, 0.0)
        feats.append(feat)
    return torch.stack(feats, -1)


def _sobel_lum(img: torch.Tensor) -> torch.Tensor:
    """(H,W) Sobel gradient magnitude of luminance, zero on the 1px border
    (computeFLIPApprox, :404-457)."""
    lum = _mix3(img, _LUM)
    p = _edge_pad(_edge_pad(lum, 1, 0), 1, 1)
    h, w = lum.shape

    def s(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (-s(-1, -1) + s(-1, 1) - 2 * s(0, -1) + 2 * s(0, 1)
          - s(1, -1) + s(1, 1))
    gy = (-s(-1, -1) - 2 * s(-1, 0) - s(-1, 1)
          + s(1, -1) + 2 * s(1, 0) + s(1, 1))
    mag = torch.sqrt(gx * gx + gy * gy)
    return torch.where(_border_mask(h, w, 1, img.device), mag, 0.0)


def _color_error(reference: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """CSF-weighted YCxCz difference at the 1 cpd colour band (:497-515)."""
    a = _srgb_to_flip_space(reference)
    b = _srgb_to_flip_space(test)
    d = torch.abs(a - b)
    return (d[..., 0] * _f32(_csf_luminance(1.0))
            + d[..., 1] * _f32(_csf_chrominance(1.0))
            + d[..., 2] * _f32(_csf_chrominance(1.0)))


def flip(reference: torch.Tensor, test: torch.Tensor,
         pixels_per_degree: float = 67.0, approx: bool = False) -> torch.Tensor:
    """Per-pixel FLIP error map in [0,1] (pre-pooling saturate(total)).

    reference/test: (H,W,3) display-referred RGB in [0,1] (the shader loads
    framebuffer sRGB values). approx=True selects the Sobel fast path.
    """
    reference = _clip(reference, 0.0, 1.0)
    test = _clip(test, 0.0, 1.0)
    color_err = _color_error(reference, test)
    if approx:
        fa = _sobel_lum(reference)
        fb = _sobel_lum(test)
        feature_err = (torch.abs(fa - fb) * _f32(_csf_luminance(4.0))
                       * FLIP_APPROX_FEATURE_WEIGHT)
    else:
        fa = _spatial_features(reference, pixels_per_degree)
        fb = _spatial_features(test, pixels_per_degree)
        feature_err = torch.sum(torch.abs(fa - fb), dim=-1)
    return _clip(color_err + feature_err, 0.0, 1.0)


def flip_mean(reference: torch.Tensor, test: torch.Tensor, q: float = 3.0,
              **kw) -> torch.Tensor:
    """Minkowski-pooled FLIP: (mean(saturate(total)^q))^(1/q), the shader's
    q=3 powered accumulation with the CPU-side q-root (:543, :184-187)."""
    e = flip(reference, test, **kw)
    return torch.mean(e ** q) ** (1.0 / q)
