"""Spherical-harmonics radiance evaluation and band rotation (counterpart
of ``vk_gaussian_splatting_tpu/ops/sh.py``).

Matches the reference polynomial and sign conventions exactly
(shaders/threedgs_particle_storage.h.slang:48-159, fetchViewDependentRadiance):
degree-0 is folded into the base color at prepare time (splat_set.py), so
this module only evaluates degrees 1..3 as an additive radiance term.
``band_rotation`` and ``rotate_sh_rest`` rotate the stored bands into world
space for rotated instances (scene/instances.py).

``sh_radiance`` is the whole radiance pass of a splat set seen from a point
(the colour of ops/projection.splat_rgb and ops/raytrace.splat_view_colors):
on CUDA tensors the kernels of csrc/sh_radiance.cu, forward and backward;
on CPU tensors the plain composition ``sh_radiance_ref``, through autograd.
``sh_radiance_bwd_ref`` is the backward kernel's arithmetic in closed form.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.scene.splat_set import dequantize_sh

SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Basis values for degrees 1..degree. dirs (...,3) unit vectors -> (...,M)
    where M = {1:3, 2:8, 3:15}[degree], deg-major coefficient order."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = []
    if degree >= 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        cols += [
            SH_C3[0] * (3.0 * xx - yy) * y,
            SH_C3[1] * x * y * z,
            SH_C3[2] * (4.0 * zz - xx - yy) * y,
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * (xx - yy) * z,
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if not cols:
        return dirs.new_zeros(dirs.shape[:-1] + (0,))
    return torch.stack(cols, dim=-1)


def _band_slices(stored_m: int):
    """[(start, count, degree)] band blocks present in an (N, M, 3) layout."""
    out = []
    if stored_m >= 3:
        out.append((0, 3, 1))
    if stored_m >= 8:
        out.append((3, 5, 2))
    if stored_m >= 15:
        out.append((8, 7, 3))
    return out


def band_rotation(rotmat, degree: int) -> np.ndarray:
    """(2l+1, 2l+1) float64 rotation of band-l coefficients for a world
    rotation R (numpy (3, 3)).

    Sampling construction: 4(2l+1) unit directions d_i from the JAX
    package's seeded generator; with A[i,j] = Y_j(d_i) and At[i,j] =
    Y_j(R^-1 d_i), the rotated function f'(d) = f(R^-1 d) satisfies
    A c' = At c, solved by least squares. The basis is evaluated on float32
    directions, as the JAX package (x64 off) evaluates it, then widened to
    float64 for the solve."""
    n = 2 * degree + 1
    rng = np.random.default_rng(degree * 7919 + 11)
    d = rng.normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.asarray(rotmat, np.float64)
    lo, cnt, _ = {1: (0, 3, 1), 2: (3, 5, 2), 3: (8, 7, 3)}[degree]

    def basis(dirs):
        b = sh_basis(torch.as_tensor(np.asarray(dirs, np.float32)), degree)
        return b.numpy().astype(np.float64)[:, lo:lo + cnt]

    m, *_ = np.linalg.lstsq(basis(d), basis(d @ r), rcond=None)
    return m


def rotate_sh_rest(sh_rest: torch.Tensor, rotmat) -> torch.Tensor:
    """(N, M, 3) model-space SH coefficients -> world space under the
    instance rotation R (model->world): block-diagonal per-band rotation,
    each band a float32 multiply-and-sum (no matmul, so no TF32 path)."""
    parts = []
    for lo, cnt, deg in _band_slices(sh_rest.shape[1]):
        m = torch.as_tensor(band_rotation(rotmat, deg), dtype=torch.float32,
                            device=sh_rest.device)
        block = sh_rest[:, lo:lo + cnt, :].to(torch.float32)
        parts.append((m[None, :, :, None] * block[:, None, :, :]).sum(dim=2))
    if not parts:
        return sh_rest
    return torch.cat(parts, dim=1)


def eval_sh_radiance(sh_rest: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Additive view-dependent radiance.

    sh_rest: (N, M, 3) float coefficients (already dequantized).
    dirs:    (N, 3) unit view directions.
    degree:  requested degree, clamped to what sh_rest stores.
    Returns (N, 3) rgb to add to the base color. The contraction is an f32
    multiply-and-sum, never a matmul, so no TF32 path can reach it.
    """
    m = coeff_count(sh_rest.shape[1], degree)
    if m == 0:
        return sh_rest.new_zeros(sh_rest.shape[:1] + (3,), dtype=torch.float32)
    basis = sh_basis(dirs, DEGREE_OF[m])  # (N, m)
    return (basis[:, :, None] * sh_rest[:, :m, :].to(torch.float32)).sum(dim=1)


DEGREE_OF = {3: 1, 8: 2, 15: 3}  # coefficients -> degree
NORM_EPS = 1e-12  # the view direction's norm is clamped at this


def coeff_count(stored_m: int, degree: int) -> int:
    """The coefficients evaluated a splat: those of ``degree``, clamped to
    the degree that ``stored_m`` coefficients hold (0, 3, 8 or 15)."""
    stored_degree = 3 if stored_m >= 15 else 2 if stored_m >= 8 else 1 if stored_m >= 3 else 0
    return {0: 0, 1: 3, 2: 8, 3: 15}[max(min(degree, stored_degree), 0)]


def sh_radiance_ref(sh: torch.Tensor, means: torch.Tensor, color: torch.Tensor,
                    position: torch.Tensor, degree: int, show_sh_only: bool = False):
    """The plain version of ``sh_radiance``: (N, 3) max(color[:, :3] + rad,
    0), or max(0.5 + rad, 0) under ``show_sh_only``, with rad the degree
    1..degree radiance along the unit direction position -> mean (the
    norm clamped at 1e-12) from the dequantized (N, M, 3) ``sh``. The
    coefficients are float32 (``eval_sh_radiance``); the rest computes in
    the means' precision."""
    dirs = means - position
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(NORM_EPS)
    rad = eval_sh_radiance(dequantize_sh(sh), dirs, degree)
    rgb = color[:, :3]
    rgb = torch.full_like(rgb, 0.5) + rad if show_sh_only else rgb + rad
    return torch.clamp(rgb, min=0.0)


def sh_basis_vjp(dirs: torch.Tensor, d_basis: torch.Tensor) -> torch.Tensor:
    """(N, 3) cotangent of the unit directions from d_basis (N, m), the
    cotangent of ``sh_basis(dirs, DEGREE_OF[m])``: each basis column's
    partials in x, y and z, accumulated over the columns in ascending order
    (zero partials skipped), as csrc/sh_radiance.cu's ``basis_vjp``."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    db = d_basis.unbind(-1)
    m = len(db)
    dx, dy, dz = torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(x)
    dy = dy + db[0] * -SH_C1
    dz = dz + db[1] * SH_C1
    dx = dx + db[2] * -SH_C1
    if m >= 8:
        dx = dx + db[3] * (SH_C2[0] * y)
        dy = dy + db[3] * (SH_C2[0] * x)
        dy = dy + db[4] * (SH_C2[1] * z)
        dz = dz + db[4] * (SH_C2[1] * y)
        dx = dx + db[5] * (SH_C2[2] * (-2.0 * x))
        dy = dy + db[5] * (SH_C2[2] * (-2.0 * y))
        dz = dz + db[5] * (SH_C2[2] * (4.0 * z))
        dx = dx + db[6] * (SH_C2[3] * z)
        dz = dz + db[6] * (SH_C2[3] * x)
        dx = dx + db[7] * (SH_C2[4] * (2.0 * x))
        dy = dy + db[7] * (SH_C2[4] * (-2.0 * y))
    if m >= 15:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        dx = dx + db[8] * (SH_C3[0] * (6.0 * xy))
        dy = dy + db[8] * (SH_C3[0] * (3.0 * xx - 3.0 * yy))
        dx = dx + db[9] * (SH_C3[1] * yz)
        dy = dy + db[9] * (SH_C3[1] * xz)
        dz = dz + db[9] * (SH_C3[1] * xy)
        dx = dx + db[10] * (SH_C3[2] * (-2.0 * xy))
        dy = dy + db[10] * (SH_C3[2] * (4.0 * zz - xx - 3.0 * yy))
        dz = dz + db[10] * (SH_C3[2] * (8.0 * yz))
        dx = dx + db[11] * (SH_C3[3] * (-6.0 * xz))
        dy = dy + db[11] * (SH_C3[3] * (-6.0 * yz))
        dz = dz + db[11] * (SH_C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy))
        dx = dx + db[12] * (SH_C3[4] * (4.0 * zz - 3.0 * xx - yy))
        dy = dy + db[12] * (SH_C3[4] * (-2.0 * xy))
        dz = dz + db[12] * (SH_C3[4] * (8.0 * xz))
        dx = dx + db[13] * (SH_C3[5] * (2.0 * xz))
        dy = dy + db[13] * (SH_C3[5] * (-2.0 * yz))
        dz = dz + db[13] * (SH_C3[5] * (xx - yy))
        dx = dx + db[14] * (SH_C3[6] * (3.0 * xx - 3.0 * yy))
        dy = dy + db[14] * (SH_C3[6] * (-6.0 * xy))
    return torch.stack([dx, dy, dz], dim=-1)


def sh_radiance_bwd_ref(sh: torch.Tensor, means: torch.Tensor, color: torch.Tensor,
                        position: torch.Tensor, degree: int, show_sh_only: bool,
                        d_rgb: torch.Tensor):
    """The VJP of ``sh_radiance_ref`` in closed form, with the arithmetic of
    csrc/sh_radiance.cu's backward: (d_sh in sh's dtype and shape, zero
    beyond the coefficients read; d_means (N, 3); d_color (N, 4), its
    last column 0, or None under ``show_sh_only``). The cotangent passes
    where the pre-clamp colour is >= 0, as torch.clamp's backward passes
    it. d_sh is rounded to float32, the coefficients' precision in the
    forward, before ``sh``'s dtype; that of a uint8 ``sh`` is None: it
    carries no gradient. At least one band is evaluated (``coeff_count`` >
    0), as in the kernel."""
    v = means - position
    n = torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2])
    nc = torch.where(n < NORM_EPS, torch.full_like(n, NORM_EPS), n)
    u = v / nc[:, None]
    m = coeff_count(sh.shape[1], degree)
    coeffs = dequantize_sh(sh)[:, :m, :]
    b = sh_basis(u, DEGREE_OF[m])
    rad = torch.zeros_like(u)
    for k in range(m):
        rad = rad + b[:, k:k + 1] * coeffs[:, k, :]
    pre = (0.5 if show_sh_only else color[:, :3]) + rad
    g = torch.where(pre >= 0.0, d_rgb.to(v.dtype), torch.zeros_like(rad))
    d_color = None if show_sh_only else torch.cat([g, torch.zeros_like(g[:, :1])], dim=1)
    d_sh = None
    if sh.dtype != torch.uint8:
        d_sh = torch.zeros(sh.shape, dtype=torch.float32, device=sh.device)
        d_sh[:, :m, :] = b[:, :, None] * g[:, None, :]
        d_sh = d_sh.to(sh.dtype)
    d_b = coeffs[:, :, 0] * g[:, None, 0] + coeffs[:, :, 1] * g[:, None, 1] \
        + coeffs[:, :, 2] * g[:, None, 2]
    d_u = sh_basis_vjp(u, d_b)
    s = u[:, 0] * d_u[:, 0] + u[:, 1] * d_u[:, 1] + u[:, 2] * d_u[:, 2]
    d_u = torch.where((n >= NORM_EPS)[:, None], d_u - u * s[:, None], d_u)
    return d_sh, d_u / nc[:, None], d_color


_FORMAT = {torch.float32: 0, torch.float16: 1, torch.uint8: 2}  # csrc/sh_radiance.cu's fmt
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _kernel_inputs(sh, means, color, position):
    """The kernels' inputs checked, contiguous and 16-byte aligned."""
    dev = means.device
    n = means.shape[0]
    if sh.dtype not in _FORMAT:
        raise TypeError(f"sh_radiance: sh of dtype {sh.dtype}; the kernel takes "
                        "float32, float16 or uint8")
    for name, t, shape in (("sh", sh, (n, sh.shape[1], 3)), ("means", means, (n, 3)),
                           ("color", color, (n, 4)), ("position", position, (3,))):
        if t.device != dev:
            raise ValueError(f"sh_radiance: {name} on {t.device}, means on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sh_radiance: {name} of shape {tuple(t.shape)}, wants {shape}")
        if name != "sh" and t.dtype != torch.float32:
            raise TypeError(f"sh_radiance: {name} of dtype {t.dtype}, wants float32")
    return tuple(_build.aligned(t) for t in (sh, means, color, position))


def sh_radiance_fwd(sh, means, color, position, m: int, show_sh_only: bool) -> torch.Tensor:
    """csrc/sh_radiance.cu's forward on CUDA tensors, the first ``m``
    coefficients of each row read: (N, 3) f32 rgb, one launch counted in
    ``sh_radiance.launches`` (none for N = 0)."""
    sh, means, color, position = _kernel_inputs(sh, means, color, position)
    n = means.shape[0]
    rgb = torch.empty((n, 3), dtype=torch.float32, device=means.device)
    if n == 0:
        return rgb
    fn = _build.entry("sh_radiance", "sh_radiance_fwd",
                      [_P, _I, _I, _I, _P, _P, _P, _L, _I, _P, _P])
    with torch.cuda.device(means.device):
        stream = torch.cuda.current_stream(means.device).cuda_stream
        err = fn(sh.data_ptr(), _FORMAT[sh.dtype], sh.shape[1], m, means.data_ptr(),
                 color.data_ptr(), position.data_ptr(), n, int(show_sh_only), rgb.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"sh_radiance_fwd launch failed: cudaError {err}")
    sh_radiance.launches += 1
    return rgb


def sh_radiance_bwd(sh, means, color, position, m: int, show_sh_only: bool, d_rgb,
                    needs=(True, True, True)):
    """csrc/sh_radiance.cu's backward on CUDA tensors: (d_sh, d_means,
    d_color) as ``sh_radiance_bwd_ref`` gives them, each None where
    ``needs`` (sh, means, color) does not ask for it; one launch counted in
    ``sh_radiance_bwd.launches`` (none for N = 0)."""
    sh, means, color, position = _kernel_inputs(sh, means, color, position)
    n = means.shape[0]
    dev = means.device
    if d_rgb.dtype != torch.float32 or tuple(d_rgb.shape) != (n, 3) or d_rgb.device != dev:
        raise ValueError(f"sh_radiance_bwd: d_rgb {d_rgb.dtype} {tuple(d_rgb.shape)} on "
                         f"{d_rgb.device}, wants float32 ({n}, 3) on {dev}")
    d_rgb = _build.aligned(d_rgb)
    d_sh = torch.empty_like(sh) if needs[0] and sh.dtype != torch.uint8 else None
    d_means = torch.empty_like(means) if needs[1] else None
    d_color = torch.empty_like(color) if needs[2] and not show_sh_only else None
    if n == 0:
        return d_sh, d_means, d_color
    fn = _build.entry("sh_radiance", "sh_radiance_bwd",
                      [_P, _I, _I, _I, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(sh.data_ptr(), _FORMAT[sh.dtype], sh.shape[1], m, means.data_ptr(),
                 color.data_ptr(), position.data_ptr(), d_rgb.data_ptr(), n,
                 int(show_sh_only), ptr(d_sh), ptr(d_means), ptr(d_color), stream)
    if err != 0:
        raise RuntimeError(f"sh_radiance_bwd launch failed: cudaError {err}")
    sh_radiance_bwd.launches += 1
    return d_sh, d_means, d_color


sh_radiance_bwd.launches = 0


class _ShRadiance(torch.autograd.Function):
    """The kernel pair: the forward kernel, and the backward kernel for the
    gradients of sh (float32 or float16), means and color that autograd
    asks for."""

    @staticmethod
    def forward(ctx, sh, means, color, position, m, show_sh_only):
        ctx.save_for_backward(sh, means, color, position)
        ctx.m, ctx.show_sh_only = m, show_sh_only
        return sh_radiance_fwd(sh, means, color, position, m, show_sh_only)

    @staticmethod
    def backward(ctx, d_rgb):
        sh, means, color, position = ctx.saved_tensors
        d_sh, d_means, d_color = sh_radiance_bwd(sh, means, color, position, ctx.m,
                                                 ctx.show_sh_only, d_rgb,
                                                 ctx.needs_input_grad[:3])
        return d_sh, d_means, d_color, None, None, None


def sh_radiance(sh: torch.Tensor, means: torch.Tensor, color: torch.Tensor,
                position: torch.Tensor, degree: int, show_sh_only: bool = False) -> torch.Tensor:
    """The splats' colour seen from ``position``: (N, 3) max(color[:, :3] +
    rad, 0), or max(0.5 + rad, 0) under ``show_sh_only``, rad the degree
    1..degree SH radiance (degree clamped to what ``sh`` stores) along the
    unit direction position -> mean.

    sh: (N, M, 3) float32, float16 or uint8 (``quantize_sh``); means (N, 3),
    color (N, 4) RGBA and position (3,) float32. On CUDA tensors the forward
    kernel of csrc/sh_radiance.cu runs, counted in ``sh_radiance.launches``,
    and gradients to sh, means and color come from its backward kernel
    (``sh_radiance_bwd``); on CPU tensors the plain ``sh_radiance_ref``
    runs under autograd. Where ``sh`` stores no whole band, or ``degree``
    is below 1, no SH term is evaluated and CUDA tensors launch nothing:
    the base colour clamped at 0 (0.5 under ``show_sh_only``), as the plain
    version gives it. A position that requires a gradient raises
    NotImplementedError: nothing trains the camera."""
    if position.requires_grad:
        raise NotImplementedError("sh_radiance: no gradient reaches the camera position")
    if means.device.type == "cpu":
        return sh_radiance_ref(sh, means, color, position, degree, show_sh_only)
    m = coeff_count(sh.shape[1], degree)
    if m == 0:  # no band to evaluate: the base colour, or 0.5, clamped
        rgb = color[:, :3]
        return torch.full_like(rgb, 0.5) if show_sh_only else rgb.clamp(min=0.0)
    return _ShRadiance.apply(sh, means, color, position, m, bool(show_sh_only))


sh_radiance.launches = 0
