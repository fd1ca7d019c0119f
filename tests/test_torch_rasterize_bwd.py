"""The blend's backward and the binning backward on the CPU.

1. The plain twin of the backward kernel (hand-derived) against torch
   autograd of the twin forward, on the same sorted pairs and a
   numpy-seeded cotangent on rgb and T. Tolerance 1e-5 of each row's max
   abs: the two take the suffix S_total - s_incl in different orders, and
   that difference is divided by 1 - alpha (down to 1e-3); measured
   <= 1.4e-6.
2. The twin against the JAX kernel K2 (``jax.vjp`` of
   ``rasterize_pallas.rasterize_tiles`` in interpret mode, as the JAX
   package's own tests run it) on the JAX bins. Rows 0-8 to 1e-5 of each
   row's max abs (XLA on the CPU contracts multiply-adds into FMAs and
   rounds exp differently, and the forward outputs behind S_total differ by
   ~1e-6); the depth row's gradient is zero in both.
3. The binning's sort-based backward against autograd of ``index_select``
   (``index_add_``), for slots with the rank ladder, slots with
   ``slots_k=4`` (no ladder) and exact, with a cotangent that is zero where
   the blend gives none (the depth row, pairs past num_pairs). Tolerance
   1e-6 of each row's max abs: the sums run in another order (a
   reshape-sum per region, or a float64 prefix sum for exact).

Two JAX programs per scene of test 2 (forward and backward kernel in one
jitted function), four in all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import rasterize_pallas as jr
from vk_gaussian_splatting_tpu.ops.binning import bin_splats as j_bin
from vk_gaussian_splatting_tpu.ops.projection import project_splats as j_project
from vk_gaussian_splatting_tpu.render.pipelines import gs_attr_rows as j_rows
from vk_gaussian_splatting_tpu.render.pipelines import raster_statics as j_statics
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import binning as tbin
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops import response as tresp
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats as t_project
from vk_gaussian_splatting_tpu_torch.render.pipelines import bin_for_cfg, gs_attr_rows
from vk_gaussian_splatting_tpu_torch.render.pipelines import raster_statics as t_statics
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam

from test_torch_rasterize import SCENES, H, W, twin_inputs

torch.set_num_threads(2)

TWIN_RTOL = 1e-5
JAX_RTOL = 1e-5
BIN_RTOL = 1e-6


def assert_rows_close(a, b, rtol, rows):
    """Each row of a within rtol * max|b[row]| of b, with b's row not all zero."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    for r in rows:
        scale = np.abs(b[r]).max()
        assert scale > 0, f"row {r}: the reference gradient is zero"
        err = np.abs(a[r] - b[r]).max() / scale
        assert err <= rtol, (r, err)


def cotangent(shape, seed):
    """Numpy-seeded cotangent on rgb and T; zero on the depth row."""
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    g[:, 4] = 0.0
    return torch.from_numpy(g)


def port_bins(name):
    seed, n, scale_range, sh = SCENES[name]
    d = interop.random_splat_arrays(seed, n, sh_degree=sh, scale_range=scale_range)
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=sh)
    cam = tcam.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9,
                       device="cpu")
    with torch.no_grad():
        proj = t_project(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg)
        rows, ids = gs_attr_rows(proj)
        return bin_for_cfg(proj, rows, ids, cfg, 0), t_statics(cfg)


@pytest.mark.parametrize("name", list(SCENES))
def test_twin_bwd_matches_autograd_of_twin(name):
    bins, st = port_bins(name)
    attrs = bins.attrs.clone().requires_grad_()
    out, _ = tr.rasterize_tiles_ref(attrs, bins.pair_id, bins.tile_start, bins.tile_count, st)
    g = cotangent(out.shape, 5)
    (out * g).sum().backward()
    ctx = tr.bwd_context(out.detach(), g)
    d = tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start, bins.tile_count, ctx, st)
    assert_rows_close(d, attrs.grad, TWIN_RTOL, range(tr.GRAD_ROWS))
    assert (d[tresp.GS_DEPTH] == 0).all() and (attrs.grad[tresp.GS_DEPTH] == 0).all()
    if name == "dense":  # frozen pixels and multi-step tiles are exercised
        assert out[:, 3].min() < st.min_transmittance
        assert int(bins.tile_count.max()) > 2 * st.chunk


def test_twin_bwd_tile_subset_matches_full():
    bins, st = port_bins("sparse")
    out, _ = tr.rasterize_bins(bins, st)
    ctx = tr.bwd_context(out, cotangent(out.shape, 6))
    full = tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start, bins.tile_count, ctx, st)
    tiles = torch.tensor([5, 0, 47, 20, 21])
    sub = tr.rasterize_tiles_bwd_ref(bins.attrs, bins.tile_start, bins.tile_count, ctx, st,
                                     tiles=tiles)
    pairs = torch.cat([torch.arange(int(s), int(s) + int(c)) for s, c in
                       zip(bins.tile_start[tiles], bins.tile_count[tiles])])
    assert pairs.numel() > 0
    np.testing.assert_array_equal(sub[:, pairs].numpy(), full[:, pairs].numpy())
    rest = torch.ones(sub.shape[1], dtype=torch.bool)
    rest[pairs] = False
    assert (sub[:, rest] == 0).all()


def jax_blend_vjp(name):
    """(JAX bins, JAX d_attrs (16, P), numpy cotangent rows 0-3) for a scene:
    ``jax.vjp`` of the interpret-mode kernel pair."""
    seed, n, scale_range, sh = SCENES[name]
    d = interop.random_splat_arrays(seed, n, sh_degree=sh, scale_range=scale_range)
    cam = jcam.make_camera(**interop.camera_to_numpy(
        tcam.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9,
                     device="cpu")))
    cfg = jc.RenderConfig(width=W, height=H, sh_degree=sh)
    st = j_statics(cfg, interpret=True)
    n_t = st.tiles_x * st.tiles_y
    g4 = cotangent((n_t, 5, jr.PIX), 7).numpy()[:, :4]
    g = np.zeros((n_t, jr.OUT_COLS, jr.PIX), np.float32)
    g[:, :4] = g4

    def fn(s, c, gj):
        proj = j_project(s.prepare(), c, cfg)
        bins = j_bin(proj, j_rows(proj), tile_size=16, tiles_x=st.tiles_x,
                     tiles_y=st.tiles_y, wide_id=True)
        _, vjp = jax.vjp(lambda a: jr.rasterize_tiles(a, bins.sched_word, bins.sched_block,
                                                      None, None, st), bins.attrs)
        return bins, vjp(gj)[0]

    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
    bins, d_attrs = jax.jit(fn)(sj, cam, jnp.asarray(g))
    return bins, np.asarray(d_attrs), g4


@pytest.mark.parametrize("name", list(SCENES))
def test_twin_bwd_matches_jax_kernel(name):
    bins, d_j, g4 = jax_blend_vjp(name)
    attrs, ids, start, count = twin_inputs(bins)
    st = t_statics(tc.RenderConfig(width=W, height=H))
    out, _ = tr.rasterize_tiles(attrs, ids, start, count, st)
    g = torch.zeros(out.shape)
    g[:, :4] = torch.from_numpy(g4)
    d_t = tr.rasterize_tiles_bwd_ref(attrs, start, count, tr.bwd_context(out, g), st)
    assert_rows_close(d_t, d_j, JAX_RTOL, range(tr.GRAD_ROWS))
    assert (d_t[tresp.GS_DEPTH] == 0).all() and (d_j[tresp.GS_DEPTH] == 0).all()


# name: (seed, n, scale_range, raster kw, max_pairs), as tests/test_torch_binning.py
BIN_CASES = {
    "slots_ladder": (0, 3000, (-4.5, -2.5), {}, 0),
    "slots_k4": (2, 800, (-3.0, -1.0), dict(slots_k=4), 0),
    "exact": (3, 3000, (-4.0, -1.5), dict(expansion="exact"), 1 << 16),
}


@pytest.mark.parametrize("name", list(BIN_CASES))
def test_bin_backward_matches_index_select(name):
    seed, n, scale_range, raster_kw, max_pairs = BIN_CASES[name]
    d = interop.random_splat_arrays(seed, n, sh_degree=0, scale_range=scale_range)
    cfg = tc.RenderConfig(width=W, height=H, raster=tc.RasterConfig(**raster_kw))
    cam = tcam.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9,
                       device="cpu")
    proj = t_project(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg)
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.normal(size=(tresp.GS_ROWS, n)).astype(np.float32))
    rows.requires_grad_()
    ids = torch.arange(n, dtype=torch.int32)
    bins = bin_for_cfg(proj, rows, ids, cfg, max_pairs)
    if name == "slots_ladder":  # all three rank regions hold splats
        assert tbin._class_caps(n)[1] < n
    g = rng.normal(size=tuple(bins.attrs.shape)).astype(np.float32)
    # the blend gives the depth row, and pairs past num_pairs (no tile's
    # range holds them), no cotangent
    g[tresp.GS_DEPTH] = 0.0
    g = torch.from_numpy(g) * bins.pair_valid
    (d_rows,) = torch.autograd.grad(bins.attrs, rows, g)
    ref_rows = rows.detach().clone().requires_grad_()
    (d_ref,) = torch.autograd.grad(ref_rows.index_select(1, bins.pair_id.long()), ref_rows, g)
    assert_rows_close(d_rows, d_ref, BIN_RTOL, range(tresp.GS_DEPTH))
    assert (d_rows[tresp.GS_DEPTH] == 0).all()
    assert bins.tile_start.grad_fn is None and bins.pair_id.grad_fn is None


def test_rasterize_tiles_is_differentiable_on_cpu_without_launches():
    bins, st = port_bins("sparse")
    attrs = bins.attrs.clone().requires_grad_()
    f0, b0 = tr.rasterize_tiles.launches, tr.rasterize_tiles_bwd.launches
    out, out_id = tr.rasterize_tiles(attrs, bins.pair_id, bins.tile_start, bins.tile_count, st)
    assert type(out.grad_fn).__name__ == "_RasterizeTilesBackward"
    assert not out_id.requires_grad
    g = cotangent(out.shape, 8)
    g[:, 4] = 1.0  # the depth row's cotangent is dropped
    (out * g).sum().backward()
    ctx = tr.bwd_context(out.detach(), g)
    d = tr.rasterize_tiles_bwd(bins.attrs, bins.tile_start, bins.tile_count, ctx, st)
    np.testing.assert_array_equal(attrs.grad.numpy(), d.numpy())
    assert (tr.rasterize_tiles.launches, tr.rasterize_tiles_bwd.launches) == (f0, b0)
