"""The tile blender: the plain PyTorch twin against the JAX kernel K1
(``rasterize_bins`` in interpret mode, as the JAX package's own tests run
it), both fed the same sorted pairs from the JAX binning. The CUDA kernel is
held against the twin in tests/test_torch_cuda.py, which needs no JAX.

Tolerances: image and transmittance 5e-5 max abs (the twin's cumprod and the
TPU kernel's log-shift scan multiply in different orders, and XLA's exp
differs from torch's in the last ulp); picked depth 1e-5 where both picked
the same splat; picked id equal on at least 99.9% of pixels (a transmittance
within an ulp of depth_iso may pick one pair later or earlier).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import rasterize_pallas as jr
from vk_gaussian_splatting_tpu.ops import response as jresp
from vk_gaussian_splatting_tpu.ops.binning import bin_splats as j_bin
from vk_gaussian_splatting_tpu.ops.projection import project_splats as j_project
from vk_gaussian_splatting_tpu.render.pipelines import gs_attr_rows as j_rows
from vk_gaussian_splatting_tpu.render.pipelines import raster_statics as j_statics
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops import response as tresp
from vk_gaussian_splatting_tpu_torch.render.pipelines import raster_statics as t_statics
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam

torch.set_num_threads(2)

W, H = 128, 96
IMG_ATOL = 5e-5
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999

# name: (seed, n, scale_range, sh degree) — "dense" freezes many pixels
# (T <= 1e-4) and gives tiles several 128-pair steps
SCENES = {
    "dense": (0, 4000, (-3.5, -1.5), 1),
    "sparse": (1, 600, (-4.0, -2.0), 0),
}


def jax_bins_and_blend(name):
    """(JAX bins, JAX (T, 8, 256) kernel output) for a scene."""
    seed, n, scale_range, sh = SCENES[name]
    d = interop.random_splat_arrays(seed, n, sh_degree=sh, scale_range=scale_range)
    cam = jcam.make_camera(**interop.camera_to_numpy(
        tcam.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9)))
    cfg = jc.RenderConfig(width=W, height=H, sh_degree=sh)
    st = j_statics(cfg, interpret=True)

    def fn(s, c):
        proj = j_project(s.prepare(), c, cfg)
        bins = j_bin(proj, j_rows(proj), tile_size=16, tiles_x=st.tiles_x,
                     tiles_y=st.tiles_y, wide_id=True)
        return bins, jr.rasterize_bins(bins, None, None, st)

    return jax.jit(fn)(jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}), cam)


def twin_inputs(bins):
    """The JAX bins in the port's layout: 10 f32 rows + int32 ids."""
    attrs = np.asarray(bins.attrs)
    ids = (attrs[jresp.GS_ID].astype(np.int64)
           + 4096 * attrs[jresp.GS_ID_HI].astype(np.int64)).astype(np.int32)
    return (torch.tensor(attrs[:tresp.GS_ROWS]), torch.tensor(ids),
            torch.tensor(np.asarray(bins.seg_starts, np.int32)),
            torch.tensor(np.asarray(bins.seg_counts, np.int32)))


def statics():
    return t_statics(tc.RenderConfig(width=W, height=H))


@pytest.fixture(scope="module", params=list(SCENES))
def blended(request):
    bins, out_j = jax_bins_and_blend(request.param)
    args = twin_inputs(bins)
    return request.param, bins, out_j, args, tr.rasterize_tiles(*args, statics())


def test_twin_matches_jax_kernel(blended):
    name, bins, out_j, args, (out_t, id_t) = blended
    st = statics()
    img_j, t_j, d_j, id_j = (np.asarray(a) for a in jr.assemble_image(
        out_j, bins.seg_counts, st.tiles_x, st.tiles_y, W, H, with_aux=True))
    img_t, t_t, d_t, id_tt = (a.numpy() for a in tr.assemble_image(
        out_t, id_t, st.tiles_x, st.tiles_y, W, H))
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=IMG_ATOL)
    same = id_tt == id_j
    assert same.mean() >= ID_AGREE, same.mean()
    both = same & (id_j >= 0)
    np.testing.assert_allclose(d_t[both], d_j[both], rtol=0, atol=DEPTH_ATOL)
    assert ((id_tt < 0) == (d_t == 0)).all()
    if name == "dense":  # the scene must exercise the freeze and multi-step tiles
        assert t_t.min() < st.min_transmittance
        assert int(args[3].max()) > 2 * st.chunk


def test_tile_subset_matches_full(blended):
    _, _, _, args, (out_t, id_t) = blended
    tiles = torch.tensor([5, 0, 47, 20, 21])
    sub, sub_id = tr.rasterize_tiles_ref(*args, statics(), tiles=tiles)
    np.testing.assert_array_equal(sub.numpy(), out_t[tiles].numpy())
    np.testing.assert_array_equal(sub_id.numpy(), id_t[tiles].numpy())


def test_empty_tiles_are_background():
    st = statics()
    n_t = st.tiles_x * st.tiles_y
    out, out_id = tr.rasterize_tiles(torch.zeros((tresp.GS_ROWS, 0)),
                                     torch.zeros((0,), dtype=torch.int32),
                                     torch.zeros((n_t,), dtype=torch.int32),
                                     torch.zeros((n_t,), dtype=torch.int32), st)
    img, trans, depth, sid = tr.assemble_image(out, out_id, st.tiles_x, st.tiles_y,
                                               W - 5, H - 3, background=(0.2, 0.4, 0.6))
    assert img.shape == (H - 3, W - 5, 3)
    np.testing.assert_allclose(img.numpy(), np.broadcast_to([0.2, 0.4, 0.6], img.shape))
    assert (trans == 1).all() and (depth == 0).all() and (sid == -1).all()


def test_assemble_image_matches_jax():
    rng = np.random.default_rng(3)
    n_t = 8 * 6
    out = rng.uniform(0, 1, (n_t, tr.OUT_ROWS, tr.PIX)).astype(np.float32)
    ids = rng.integers(-1, 1 << 30, (n_t, tr.PIX)).astype(np.int32)
    out_j = np.zeros((n_t, jr.OUT_COLS, jr.PIX), np.float32)
    out_j[:, :5] = out
    out_j[:, 5] = ids % 4096
    out_j[:, 6] = ids // 4096
    bg = (0.1, 0.2, 0.3)
    res_j = jr.assemble_image(jnp.asarray(out_j), jnp.ones((n_t,), jnp.int32), 8, 6,
                              121, 90, bg, with_aux=True)
    res_t = tr.assemble_image(torch.from_numpy(out), torch.from_numpy(ids), 8, 6,
                              121, 90, bg)
    for a, b in zip(res_j, res_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_gs2d_alpha_matches_jax():
    rng = np.random.default_rng(4)
    block = np.zeros((16, 128), np.float32)
    block[0:2] = rng.uniform(0, 16, (2, 128))
    block[2] = rng.uniform(0.01, 2, 128)
    block[3] = rng.uniform(-0.2, 0.2, 128)
    block[4] = rng.uniform(0.01, 2, 128)
    block[5] = rng.uniform(0, 1, 128)
    px = (np.arange(256) % 16 + 0.5).astype(np.float32)[:, None]
    py = (np.arange(256) // 16 + 0.5).astype(np.float32)[:, None]
    live = (np.arange(128) < 100)[None, :]
    aj = np.asarray(jresp.gs2d_alpha(jnp.asarray(block), None, jnp.asarray(px),
                                     jnp.asarray(py), jnp.asarray(live), jr.RasterStatics(1, 1)))
    at = tresp.gs2d_alpha(torch.from_numpy(block[:10]), torch.from_numpy(px),
                          torch.from_numpy(py), torch.from_numpy(live), tr.RasterStatics(1, 1)).numpy()
    assert 0 < (aj > 0).mean() < 1
    np.testing.assert_allclose(at, aj, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mutate, match", [
    (lambda a: (a[0].double(),) + a[1:], "attrs"),
    (lambda a: (a[0][:9],) + a[1:], "attrs"),
    (lambda a: (a[0], a[1].long()) + a[2:], "ids"),
    (lambda a: a[:2] + (a[2][:-1],) + a[3:], "tile_start"),
    (lambda a: a[:3] + (a[3].float(),), "tile_count"),
    (lambda a: (a[0].t().contiguous().t(),) + a[1:], "contiguous"),
])
def test_wrapper_validates_inputs(mutate, match):
    st = statics()
    n_t = st.tiles_x * st.tiles_y
    args = (torch.zeros((tresp.GS_ROWS, 4)), torch.zeros((4,), dtype=torch.int32),
            torch.zeros((n_t,), dtype=torch.int32), torch.zeros((n_t,), dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        tr.rasterize_tiles(*mutate(args), st)


def test_cpu_twin_counts_no_launch():
    st = statics()
    n_t = st.tiles_x * st.tiles_y
    before = tr.rasterize_tiles.launches
    tr.rasterize_tiles(torch.zeros((tresp.GS_ROWS, 0)), torch.zeros((0,), dtype=torch.int32),
                       torch.zeros((n_t,), dtype=torch.int32),
                       torch.zeros((n_t,), dtype=torch.int32), st)
    assert tr.rasterize_tiles.launches == before


def test_library_path_is_keyed_by_source():
    path = _build.library_path("rasterize_fwd")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("librasterize_fwd-")
    assert path == _build.library_path("rasterize_fwd")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
