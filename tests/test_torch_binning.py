"""Tile binning: the PyTorch port against the JAX package.

Exact comparisons: ``num_pairs``, ``overflow`` and each tile's splat ids in
blend (depth) order, for both expansions, with and without overflow. The
scenes draw continuous depths, so no two splats of one tile tie (the two
packages may order ties differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import binning as jbin
from vk_gaussian_splatting_tpu.ops.projection import project_splats as j_project
from vk_gaussian_splatting_tpu.ops.sort import encode_minmax_f32 as j_encode
from vk_gaussian_splatting_tpu.render.pipelines import gs_attr_rows as j_rows
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import binning as tbin
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats as t_project
from vk_gaussian_splatting_tpu_torch.ops.sort import encode_minmax_f32 as t_encode
from vk_gaussian_splatting_tpu_torch.render.pipelines import gs_attr_rows as t_rows
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam

torch.set_num_threads(2)

W, H = 128, 96
TX, TY = 8, 6

# name: (seed, n, scale_range, raster kw, max_pairs, expected overflow)
CASES = {
    "slots": (0, 3000, (-4.5, -2.5), {}, 0, False),
    "slots_ladder_overflow": (1, 1500, (-1.0, 0.5), {}, 0, True),
    "slots_k4_overflow": (2, 800, (-3.0, -1.0), dict(slots_k=4), 0, True),
    "exact": (3, 3000, (-4.0, -1.5), dict(expansion="exact"), 1 << 16, False),
    "exact_overflow": (4, 1000, (-3.0, -1.0), dict(expansion="exact"), 300, True),
}


def bin_both(name):
    seed, n, scale_range, raster_kw, max_pairs, _ = CASES[name]
    d = interop.random_splat_arrays(seed, n, sh_degree=0, scale_range=scale_range)
    cam_t = tcam.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9)
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))
    cj = jc.RenderConfig(width=W, height=H, raster=jc.RasterConfig(**raster_kw))
    ct = tc.RenderConfig(width=W, height=H, raster=tc.RasterConfig(**raster_kw))
    kw = dict(tile_size=16, tiles_x=TX, tiles_y=TY, slots_k=cj.raster.slots_k,
              max_pairs=max_pairs, expansion=cj.raster.expansion)

    def j_fn(s, c):
        proj = j_project(s.prepare(), c, cj)
        return jbin.bin_splats(proj, j_rows(proj), wide_id=True, **kw)

    bj = jax.jit(j_fn)(jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}), cam_j)
    proj = t_project(interop.splat_set_from_numpy(d).prepare(), cam_t, ct)
    rows, ids = t_rows(proj)
    bt = tbin.bin_splats(proj, rows, ids, **kw)
    return bj, bt, rows


def tile_lists(starts, counts, ids):
    starts, counts, ids = (np.asarray(a) for a in (starts, counts, ids))
    return [ids[s:s + c].tolist() for s, c in zip(starts, counts)]


@pytest.mark.parametrize("name", list(CASES))
def test_bins_match(name):
    bj, bt, rows = bin_both(name)
    assert bool(bj.overflow) == bool(bt.overflow) == CASES[name][-1]
    assert int(bj.num_pairs) == int(bt.num_pairs) > 0
    lj = tile_lists(bj.seg_starts, bj.seg_counts, bj.pair_splat)
    lt = tile_lists(bt.tile_start, bt.tile_count, bt.pair_id)
    assert [set(t) for t in lt] == [set(t) for t in lj]   # which splats
    assert lt == lj                                        # and their order
    # the live pairs are the first num_pairs, in tile order, with the rows
    # of their splats
    p = int(bt.num_pairs)
    assert bool(bt.pair_valid[:p].all()) and not bool(bt.pair_valid[p:].any())
    assert int(bt.tile_count.sum()) == p
    np.testing.assert_array_equal(bt.attrs[:, :p].numpy(),
                                  rows[:, bt.pair_id[:p].long()].numpy())


def test_pairs_sorted_by_tile_then_depth():
    _, bt, _ = bin_both("slots")
    p = int(bt.num_pairs)
    tiles = np.repeat(np.arange(TX * TY), bt.tile_count.numpy())
    depth = bt.attrs[9, :p].numpy()
    # (tile, depth) ascending over the live pairs
    order = np.lexsort((depth, tiles))
    np.testing.assert_array_equal(order, np.arange(p))


def test_encode_minmax_matches():
    vals = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 0.5, 7.0, 1e30,
                     np.inf], np.float32)
    kj = np.asarray(j_encode(jnp.asarray(vals))).astype(np.int64)
    kt = t_encode(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(kj, kt)
    assert (np.diff(kt) > 0).all()


def test_class_caps_and_tile_rect_match():
    for n in (1, 100, 3000, 1_000_000):
        assert tbin._class_caps(n) == jbin._class_caps(n)
    rng = np.random.default_rng(9)
    xy = rng.uniform(-40, 170, (300, 2)).astype(np.float32)
    rad = np.repeat(rng.uniform(0, 60, (300, 1)), 2, 1).astype(np.float32)
    rj = jbin.tile_rect(jnp.asarray(xy), jnp.asarray(rad), 16, TX, TY)
    rt = tbin.tile_rect(torch.from_numpy(xy), torch.from_numpy(rad), 16, TX, TY)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
