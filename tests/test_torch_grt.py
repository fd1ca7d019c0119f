"""3DGRT's strict tier, ``render_3dgrt_exact``, of the PyTorch port on the
CPU: against the JAX package's and against the port's raster
``render_3dgrt``, on tests/test_grt.py:88's scene (150 splats at SH 0,
64x48, ``rt.max_passes`` 48).

Gates, each with its reason:
- against JAX: the tracer's gates (tests/test_torch_raytrace.py): image and
  transmittance within 1e-4 on >= 99.9 % of pixels and none beyond 1.2e-2,
  the iso depth the same pick (1e-5 relative) on >= 99.9 % of pixels; ids
  -1, num_pairs N, overflow False, as there;
- against the raster frame: above 35 dB on images clipped to [0, 1]
  (tests/test_grt.py's bound: the radial order is exact for shared-origin
  centres; the rest comes from the finite t-slabs and cutoff flips).

JAX programs built here: one trace (a few seconds).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgrt_exact as j_exact
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.render import render_3dgrt, render_3dgrt_exact

torch.set_num_threads(2)

ATOL, AGREE, MAX_FLIP = 1e-4, 0.999, 1.2e-2
DEPTH_RTOL = 1e-5
PSNR_MIN = 35.0


def test_render_3dgrt_exact_matches_jax_and_the_raster_tier():
    d = interop.random_splat_arrays(13, 150, sh_degree=0, scale_range=(-2.2, -1.2))
    pj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    pt = interop.splat_set_from_numpy(d, "cpu").prepare()
    kw = dict(width=64, height=48, sh_degree=0)
    cj, ct = jc.RenderConfig(**kw), tc.RenderConfig(**kw)
    cj = cj.replace(rt=dataclasses.replace(cj.rt, max_passes=48))
    ct = ct.replace(rt=dataclasses.replace(ct.rt, max_passes=48))
    cam_t = gt.look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], 64, 48, fov_y_rad=0.9, device="cpu")
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))

    oj = j_exact(pj, cam_j, cj)
    ot = render_3dgrt_exact(pt, cam_t, ct)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(a.numpy() - np.asarray(b)).reshape(48 * 64, -1).max(axis=1)
        print(f"exact tier against JAX: max {diff.max():.3e}, "
              f"{int((diff > ATOL).sum())} pixels beyond {ATOL}")
        assert (diff <= ATOL).mean() >= AGREE and diff.max() <= MAX_FLIP, diff.max()
    dj, dt = np.asarray(oj.depth), ot.depth.numpy()
    assert (np.abs(dt - dj) <= DEPTH_RTOL * np.maximum(np.abs(dj), 1.0)).mean() >= AGREE
    assert (dt > 0).any() and np.isfinite(dt).all()
    assert (ot.splat_id == -1).all() and int(ot.num_pairs) == 150 and not bool(ot.overflow)
    assert float(ot.transmittance.min()) < 0.5

    raster = render_3dgrt(pt, cam_t, ct, max_pairs=1 << 16).image.clamp(0, 1)
    mse = float(((raster - ot.image.clamp(0, 1)) ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    print(f"exact tier against the raster 3DGRT frame: {psnr:.2f} dB")
    assert psnr > PSNR_MIN, psnr
