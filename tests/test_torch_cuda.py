"""The CUDA tile blender on a card, against its plain PyTorch twin.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

Tolerance, kernel against twin on one device: 1e-4 max abs on rgb and
transmittance. Both evaluate every alpha with the same f32 operations in the
same order (the kernel is built with -fmad=false and exact expf), so alphas
agree bit for bit; the running transmittance multiplies in another order
(sequential in the kernel, a cumprod times the step's start value in the
twin), and a pixel whose T lands within an ulp of min_transmittance (1e-4)
at a step start may freeze one step apart, which moves it by at most about
1e-4. Picked ids agree on at least 99.9% of pixels.
"""

import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.render import render
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    bin_for_cfg,
    gs_attr_rows,
    raster_statics,
)

ATOL = 1e-4
ID_AGREE = 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the blender kernel runs only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bins_on(device, cfg, seed=0, n=4000, scale_range=(-3.5, -1.5)):
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=scale_range)
    cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], cfg.width,
                     cfg.height, fov_y_rad=0.9, device=device)
    proj = project_splats(interop.splat_set_from_numpy(d, device).prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    return bin_for_cfg(proj, rows, ids, cfg, 0)


def assert_kernel_matches_twin(bins, st):
    out_k, id_k = tr.rasterize_bins(bins, st)
    out_r, id_r = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                         bins.tile_count, st)
    torch.cuda.synchronize()
    err = (out_k[:, :4] - out_r[:, :4]).abs().max().item()
    assert err <= ATOL, err
    same = id_k == id_r
    assert same.float().mean().item() >= ID_AGREE
    assert torch.equal(out_k[:, 4][same], out_r[:, 4][same])  # same splat, same depth
    return out_k, id_k


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [128, 64, 256])
def test_kernel_matches_twin(cuda, chunk):
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=1,
                          raster=gt.RasterConfig(chunk=chunk))
    bins = bins_on(cuda, cfg)
    st = raster_statics(cfg)
    out_k, _ = assert_kernel_matches_twin(bins, st)
    assert out_k[:, 3].min().item() < st.min_transmittance  # pixels froze


@pytest.mark.cuda
def test_kernel_counts_launches_and_repeats_bit_equal(cuda):
    cfg = gt.RenderConfig(width=120, height=90, sh_degree=1)
    bins = bins_on(cuda, cfg, seed=1, n=1500)
    st = raster_statics(cfg)
    before = tr.rasterize_tiles.launches
    a = tr.rasterize_bins(bins, st)
    b = tr.rasterize_bins(bins, st)
    torch.cuda.synchronize()
    assert tr.rasterize_tiles.launches == before + 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_kernel_empty_tiles(cuda):
    cfg = gt.RenderConfig(width=64, height=48)
    st = raster_statics(cfg)
    n_t = st.tiles_x * st.tiles_y
    z = torch.zeros((n_t,), dtype=torch.int32, device=cuda)
    out, out_id = tr.rasterize_tiles(torch.zeros((10, 0), device=cuda),
                                     torch.zeros((0,), dtype=torch.int32, device=cuda),
                                     z, z, st)
    assert (out[:, :3] == 0).all() and (out[:, 3] == 1).all()
    assert (out[:, 4] == 0).all() and (out_id == -1).all()


@pytest.mark.cuda
def test_kernel_rejects_oversized_chunk(cuda):
    cfg = gt.RenderConfig(width=64, height=48, raster=gt.RasterConfig(chunk=512))
    bins = bins_on(cuda, cfg, n=100)
    with pytest.raises(ValueError, match="chunk"):
        tr.rasterize_bins(bins, raster_statics(cfg))


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda):
    """The whole frame on the card against the same frame on the CPU, where
    the twin blends. The two devices' exp, sigmoid and matmul libraries
    differ in the last ulp, which can flip a splat-pixel across the
    d <= qmax or alpha >= alpha_min cutoff and move that one contribution by
    up to opacity * exp(-qmax / 2) * color. So the gate is flip-aware: at
    most 0.1% of pixel channels (36 of 36,864) beyond 5e-5, and none beyond
    2e-3 (measured on an H100: max 3.2e-4, ids all equal)."""
    d = interop.random_splat_arrays(2, 3000, sh_degree=3, scale_range=(-3.5, -1.5))
    cfg = gt.RenderConfig(width=128, height=96, sh_degree=3)
    outs = []
    for dev in ("cpu", cuda):
        cam = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], 128, 96,
                         fov_y_rad=0.9, device=dev)
        outs.append(render(interop.splat_set_from_numpy(d, dev).prepare(), cam, cfg))
    c, g = outs
    assert bool(c.overflow) == bool(g.overflow)
    diff = (g.image.cpu() - c.image).abs().flatten()
    n_far = int((diff > 5e-5).sum())
    assert n_far <= diff.numel() // 1000, n_far
    assert diff.max().item() <= 2e-3, diff.max().item()
    agree = (g.splat_id.cpu() == c.splat_id).float().mean().item()
    assert agree >= ID_AGREE, agree
