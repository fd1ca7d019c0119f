"""The host-sorted frame, ``render_3dgs(host_order=...)`` (``SortMethod.HOST``),
of the PyTorch port on the CPU, where its twins blend, against the JAX
package's, each fed the order the JAX package's ``AsyncHostSorter`` gives.

The scene and caps are tests/test_project_async.py:159-193's: 64x48, 200
splats, bucket caps (256, 256, 128, 128).

Tolerances, each with its reason (those of tests/test_torch_bucket.py):
- frame against JAX: image and transmittance 5e-5 max abs, picked depth
  1e-5 where both picked the same splat, ids on >= 99.9 % of pixels,
  overflow exactly;
- gradients of the six SplatSet fields against ``jax.grad``: 1e-5 of each
  field's max;
- the packed frame against JAX: the gates above, from the JAX package's
  packed words. The two packages' f32 projections differ by FMA rounding,
  so a word near a bf16 rounding tie rounds apart: on this scene one of
  1,400 words (a conic word) does, with or without a host order, and
  moves 11 of 9,216 channels by up to 1.0e-4. The packing itself is held
  to JAX's bit for bit by tests/test_torch_packed.py;
- the port's own frames (a host order fed to both methods, packed bucket
  against packed pairs, the fresh order against the device-sorted frame):
  bit for bit, as each pair of them sorts and blends the same lanes.

JAX programs built here: four frames and one gradient.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.io.async_loader import AsyncHostSorter as JSorter
from vk_gaussian_splatting_tpu.ops.projection import project_splats as j_project
from vk_gaussian_splatting_tpu.render.pipelines import gs_attr_rows_packed as j_rows_packed
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import bucket_splats
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.ops.response import GS_KEY, GSP_ROWS
from vk_gaussian_splatting_tpu_torch.render import pipelines, render
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    bucket_statics,
    gs_attr_rows,
    host_rank,
    render_3dgs,
)

torch.set_num_threads(2)

IMG_ATOL = 5e-5
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999
GRAD_RTOL = 1e-5
W, H = 64, 48
CAPS = (256, 256, 128, 128)


@pytest.fixture(scope="module")
def setup():
    """The scene as numpy, both cameras, and the JAX sorter's order."""
    d = interop.random_splat_arrays(2, 200, sh_degree=0, scale_range=(-2.5, -1.2))
    cam_t = gt.look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], W, H, device="cpu")
    cam_j = jcam.make_camera(**interop.camera_to_numpy(cam_t))
    sorter = JSorter(d["means"])
    sorter.sort_async(cam_t.viewmat.numpy()[2, :3].astype(np.float64))
    for _ in range(500):
        res = sorter.consume()
        if res is not None:
            break
        time.sleep(0.01)
    return d, cam_t, cam_j, res[0]


def configs(method="bucket", pair_format="f32", **kw):
    raster = dict(method=method, bucket_caps=CAPS, pair_format=pair_format)
    return (jc.RenderConfig(width=W, height=H, sh_degree=0, raster=jc.RasterConfig(**raster),
                            **{k: getattr(jc.StochasticMode, v) if k == "stochastic" else v
                               for k, v in kw.items()}),
            tc.RenderConfig(width=W, height=H, sh_degree=0, raster=tc.RasterConfig(**raster),
                            **{k: getattr(tc.StochasticMode, v) if k == "stochastic" else v
                               for k, v in kw.items()}))


def to_jax(d):
    return jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})


def both(setup, order, method="bucket", pair_format="f32", **kw):
    d, cam_t, cam_j, _ = setup
    cj, ct = configs(method, pair_format, **kw)
    oj = j_render(to_jax(d).prepare(), cam_j, cj, 16384, host_order=jnp.asarray(order))
    ot = render_3dgs(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t, ct, 16384,
                     host_order=order)
    return oj, ot


def assert_frames_match(oj, ot):
    assert bool(oj.overflow) == bool(ot.overflow) is False
    img_j, img_t = np.asarray(oj.image), ot.image.numpy()
    assert img_t.shape == img_j.shape == (H, W, 3)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(ot.transmittance.numpy(), np.asarray(oj.transmittance), rtol=0,
                               atol=IMG_ATOL)
    id_j, id_t = np.asarray(oj.splat_id), ot.splat_id.numpy()
    same = id_j == id_t
    assert same.mean() >= ID_AGREE, same.mean()
    both_ = same & (id_j >= 0)
    np.testing.assert_allclose(ot.depth.numpy()[both_], np.asarray(oj.depth)[both_], rtol=0,
                               atol=DEPTH_ATOL)
    assert float(ot.transmittance.min()) < 0.5  # the scene covers pixels


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_host_order_frame_matches_jax(setup, method):
    """The fresh host order on each method against the JAX frame; the picked
    depth is the model's, not the rank; the port's frame equals its
    device-sorted frame (a fresh order sorts as the device does here)."""
    oj, ot = both(setup, setup[3], method)
    assert_frames_match(oj, ot)
    d, cam_t, _, _ = setup
    dev = render_3dgs(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t,
                      configs(method)[1], 16384)
    assert torch.equal(ot.image, dev.image) and torch.equal(ot.depth, dev.depth)


def test_packed_bucket_host_order_takes_the_pair_path(setup, monkeypatch):
    """Packed rows have no room for the key row: with a host order,
    method="bucket" renders the packed pair frame (the JAX ``use_bucket``),
    and that, from the JAX package's packed words, against its frame."""
    d, cam_t, cam_j, order = setup
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    ot = render_3dgs(prep, cam_t, configs("bucket", "packed")[1], 16384, host_order=order)
    pairs = render_3dgs(prep, cam_t, configs("pairs", "packed")[1], 16384, host_order=order)
    for f in ("image", "transmittance", "depth", "splat_id"):
        assert torch.equal(getattr(ot, f), getattr(pairs, f)), f
    cj = configs("bucket", "packed")[0]
    words = np.asarray(j_rows_packed(j_project(to_jax(d).prepare(), cam_j, cj)))[:GSP_ROWS]
    monkeypatch.setattr(pipelines, "gs_attr_rows_packed", lambda proj: (
        torch.from_numpy(words.copy()), torch.arange(words.shape[1], dtype=torch.int32)))
    oj, ot = both(setup, order, "bucket", "packed")
    assert_frames_match(oj, ot)


def test_stochastic_bucket_host_order_matches_jax(setup):
    oj, ot = both(setup, setup[3], "bucket", stochastic="SPLAT", temporal_samples=2)
    assert_frames_match(oj, ot)
    trans = ot.transmittance
    assert torch.equal(trans * 2, torch.round(trans * 2))  # T a multiple of 1 / samples


def test_host_order_gradients_match_jax(setup):
    """Weighted image plus weighted transmittance through the bucket path's
    key-row form, against ``jax.grad`` of the JAX ``render_3dgs``; the twin
    backward gives the key row exact zeros."""
    d, cam_t, cam_j, order = setup
    cj, ct = configs("bucket")
    rng = np.random.default_rng(7)
    wimg = rng.normal(size=(H, W, 3)).astype(np.float32)
    wt = rng.normal(size=(H, W)).astype(np.float32)

    def loss_j(s):
        o = j_render(s.prepare(), cam_j, cj, host_order=jnp.asarray(order))
        return jnp.sum(o.image * wimg) + jnp.sum(o.transmittance * wt)

    g_j = jax.jit(jax.grad(loss_j))(to_jax(d))
    s = interop.splat_set_from_numpy(d, "cpu")
    for f in interop.SPLAT_FIELDS:
        getattr(s, f).requires_grad_()
    o = render_3dgs(s.prepare(), cam_t, ct, host_order=torch.from_numpy(order))
    (torch.sum(o.image * torch.from_numpy(wimg))
     + torch.sum(o.transmittance * torch.from_numpy(wt))).backward()
    for f in interop.SPLAT_FIELDS:
        if f == "sh_rest":  # SH degree 0: no rest coefficients
            continue
        a = getattr(s, f).grad.numpy().astype(np.float64)
        b = np.asarray(getattr(g_j, f), np.float64)
        assert np.abs(b).max() > 0, f
        assert np.abs(a - b).max() <= GRAD_RTOL * np.abs(b).max(), f

    bins, st = keyrow_bins(d, cam_t, ct, order)
    n_tiles = st.tiles_x * st.tiles_y
    ctx = torch.from_numpy(rng.normal(size=(n_tiles, 5, 256)).astype(np.float32))
    d_attrs = rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, CAPS)
    assert d_attrs.shape[0] == GS_KEY + 1 and bool((d_attrs[GS_KEY] == 0).all())
    assert float(d_attrs[:9].abs().max()) > 0


def keyrow_bins(d, cam, cfg, order, key=None):
    """The bucket bins of the host-sorted frame, as render_3dgs makes them:
    the rank appended as the key row and the slots sorted by the rank; with
    ``key``, that row holds ``key`` instead (the slots still sorted by the
    rank)."""
    proj = project_splats(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    rank = host_rank(order, rows.shape[1], rows.device)
    rows = torch.cat([rows, (rank if key is None else key)[None]])
    bins = bucket_splats(proj, rows, ids, tiles_x=cfg.width // 16, tiles_y=cfg.height // 16,
                         caps=CAPS, sort_depth=rank)
    return bins, dataclasses.replace(bucket_statics(cfg), key_is_row=True)


def test_reversed_order_changes_the_frame(setup):
    """The rank drives the merge: a reversed order blends back to front."""
    d, cam_t, _, order = setup
    prep = interop.splat_set_from_numpy(d, "cpu").prepare()
    ct = configs("bucket")[1]
    fwd = render_3dgs(prep, cam_t, ct, host_order=order)
    rev = render_3dgs(prep, cam_t, ct, host_order=order[::-1].copy())
    assert float((rev.image - fwd.image).abs().max()) > 1e-3
    assert render(prep, cam_t, ct, host_order=torch.from_numpy(order)).image.equal(fwd.image)


def test_key_row_unlike_the_sort_depth_is_caught(setup):
    """The merge ranks by counting keys, right only where each span ascends
    in the key row: a key row that is not the sort depth of the slots (here
    the reversed rank) makes the twins raise, not blend a wrong order."""
    d, cam_t, _, order = setup
    ct = configs("bucket")[1]
    bins, st = keyrow_bins(d, cam_t, ct, order)
    out, _ = rb.rasterize_buckets_ref(bins.attrs, bins.ids, bins.bucket_starts, st, CAPS)
    assert out.shape == (st.tiles_x * st.tiles_y, 5, 256)
    bad, _ = keyrow_bins(d, cam_t, ct, order, key=-host_rank(order, 200, "cpu"))
    for twin in (lambda: rb.rasterize_buckets_ref(bad.attrs, bad.ids, bad.bucket_starts, st,
                                                  CAPS),
                 lambda: rb.tile_may_hit(bad.attrs, bad.bucket_starts, st, CAPS)):
        with pytest.raises(ValueError, match="key row"):
            twin()


def test_host_rank_is_the_jax_rank():
    """rank[order[i]] = i; a splat the order leaves out keeps 0 (the JAX
    ``.at[].set``); a wrong shape or a float order raises."""
    order = np.array([3, 0, 2, 1], np.int32)
    np.testing.assert_array_equal(host_rank(order, 4, "cpu").numpy(), [1, 3, 2, 0])
    part = host_rank(torch.tensor([2, 2, 1, 1]), 4, "cpu").numpy()
    assert part[0] == 0 and part[3] == 0
    for bad in (np.arange(3), np.arange(4.0), np.zeros((4, 1), np.int32)):
        with pytest.raises(ValueError, match="host_order"):
            host_rank(bad, 4, "cpu")
