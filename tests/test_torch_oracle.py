"""The port's render_3dgs against the float64 ShaderEmulator of
tests/test_oracle.py: a literal NumPy transcription of the reference's
shader paths that shares no code with either package. The port renders on
the CPU (its plain twins) on that file's scene, camera, eigen-gap trim and
caps, carried across as numpy (``interop``), and is held to that file's own
bounds: max abs < 2e-3 on the image and the transmittance, mean abs < 1e-4
on the image, PSNR > 60 dB. Those bounds cover f32 roundoff over ~100
blended splats and the per-pixel T < 1e-4 freeze, whose truncated
contributions are below 1e-4; anything structural (SH signs, the eigen
basis against the conic, the blend order) misses them by orders of
magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_oracle import _oracle_scene, emulate_render, projected_eigen_gaps
import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.render import render_3dgs

torch.set_num_threads(2)


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_port_matches_reference_shader_emulation(method):
    w = h = 64
    cfg = gt.RenderConfig(width=w, height=h, sh_degree=3)
    if method == "bucket":
        cfg = cfg.replace(raster=dataclasses.replace(
            cfg.raster, method="bucket", bucket_caps=(256, 256, 256, 256)))
    splats = _oracle_scene()
    cam = gt.look_at([0.1, -0.2, -4.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                     device="cpu")
    keep = projected_eigen_gaps(splats, cam.viewmat.numpy(), float(cam.fx),
                                float(cam.fy)) > 1.0
    assert keep.sum() > 100  # the filter must stay a rare-case trim
    arrays = {k: np.asarray(getattr(splats, k))[keep] for k in interop.SPLAT_FIELDS}
    out = render_3dgs(interop.splat_set_from_numpy(arrays, "cpu").prepare(), cam, cfg,
                      max_pairs=1 << 15)
    assert not bool(out.overflow)
    img = out.image.double().numpy()
    trans = out.transmittance.double().numpy()

    kept = dataclasses.replace(splats, **{k: v for k, v in arrays.items()})
    ref_img, ref_trans = emulate_render(
        kept, cam.viewmat.numpy(), float(cam.fx), float(cam.fy), float(cam.cx),
        float(cam.cy), w, h, sh_degree=3)

    assert np.max(np.abs(img - ref_img)) < 2e-3, np.max(np.abs(img - ref_img))
    assert np.mean(np.abs(img - ref_img)) < 1e-4
    assert np.max(np.abs(trans - ref_trans)) < 2e-3
    mse = np.mean((img - ref_img) ** 2)
    psnr = 10 * np.log10(max(ref_img.max(), 1.0) ** 2 / max(mse, 1e-20))
    assert psnr > 60.0, psnr
