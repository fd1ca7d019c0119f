"""The tile blender: the plain PyTorch twin against the JAX kernel K1
(``rasterize_bins`` in interpret mode, as the JAX package's own tests run
it), both fed the same sorted pairs from the JAX binning. The CUDA kernel is
held against the twin in tests/test_torch_cuda.py, which needs no JAX.

Tolerances: image and transmittance 5e-5 max abs (the twin's cumprod and the
TPU kernel's log-shift scan multiply in different orders, and XLA's exp
differs from torch's in the last ulp); picked depth 1e-5 where both picked
the same splat; picked id equal on at least 99.9% of pixels (a transmittance
within an ulp of depth_iso may pick one pair later or earlier).

K2's per-tile cull of the pair lists (``pair_may_hit``) must keep every
pair that hits (``pair_hits``), and the backward twin with the culled
pairs taken out (zero rows) must equal the full sweep bit for bit. The batched reduction of
csrc/rasterize_bwd.cu is modelled in numpy against the per-row warp sums it
replaced, bit for bit.

K1's per-warp cull (``pair_warp_may_hit``: each pair against each of the
tile's eight 8x4 warp blocks, ``WARP_PIXELS``) must keep every (warp, pair)
that hits some pixel of the warp, and the forward twin with the culled
(warp, pair)s taken out must equal the full sweep bit for bit (and so the
JAX kernel, at the tolerances above). The predicate's tile answers
(``may_hit``, shared by K2, K3 and K4) must be those of its unfactored
form, ``unfactored_may_hit`` below.
"""


import dataclasses
import os
import types

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
from vk_gaussian_splatting_tpu_torch.io import load_ply
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.render.pipelines import bin_for_cfg, gs_attr_rows
from vk_gaussian_splatting_tpu_torch.render.pipelines import raster_statics as t_statics
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam
from test_torch_bucket import adversarial_gs2d_rows

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
        tcam.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9,
                      device="cpu")))
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


def test_blend_work_counts(blended):
    """blend_work's (evaluations, hits), which the kernels' bounds count:
    with no pixel frozen every pixel of a tile evaluates every pair of its
    range, and the hits are the pair-pixels whose alpha passes the cutoffs;
    the freeze only takes work away."""
    name, _, _, (attrs, _, start, count), (out_t, _) = blended
    st = statics()
    evals, hits = tr.blend_work(attrs, start, count, st)
    px, py = tr._tile_pixel_coords(torch.arange(start.shape[0]), st.tiles_x)
    all_hits = 0
    for t, (a, n) in enumerate(zip(start.tolist(), count.tolist())):
        block = attrs[None, :, a:a + n]
        alpha = tresp.gs2d_alpha(block, px[t:t + 1], py[t:t + 1], torch.tensor(True), st)
        all_hits += int((alpha > 0).sum())
    full = tr.PIX * int(count.sum())
    assert 0 < hits <= evals
    if name == "dense":
        assert out_t[:, 3].min() <= st.min_transmittance
        assert evals < full and hits < all_hits
    else:
        assert out_t[:, 3].min() > st.min_transmittance
        assert (evals, hits) == (full, all_hits)


def test_blend_work_counts_a_cull(blended):
    """blend_work with a cull's ``keep`` mask: (tested, kept, kept
    evaluations, draws) over the steps a tile enters. Keeping every pair
    keeps what is tested, every evaluation and every hit (a deterministic
    sweep draws where it hits); keeping none keeps nothing; and keeping
    every other pair splits the tested pairs, evaluations and draws."""
    name, _, _, (attrs, _, start, count), _ = blended
    st = statics()
    evals, hits = tr.blend_work(attrs, start, count, st)
    everyone = torch.ones(attrs.shape[1], dtype=torch.bool)
    e, h, tested, kept, kept_evals, draws = tr.blend_work(attrs, start, count, st,
                                                           keep=everyone)
    assert (e, h) == (evals, hits) and kept == tested and (kept_evals, draws) == (evals, hits)
    assert 0 < tested <= int(count.sum())
    if name != "dense":  # no tile freezes: every pair is tested
        assert tested == int(count.sum())
    assert tr.blend_work(attrs, start, count, st, keep=~everyone)[2:] == (tested, 0, 0, 0)
    odd = torch.arange(attrs.shape[1]) % 2 == 1
    _, _, _, kept_odd, evals_odd, draws_odd = tr.blend_work(attrs, start, count, st, keep=odd)
    _, _, _, kept_even, evals_even, draws_even = tr.blend_work(attrs, start, count, st,
                                                               keep=~odd)
    assert (kept_odd + kept_even, evals_odd + evals_even) == (tested, evals)
    assert draws_odd + draws_even == hits


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


# ---- K2's per-tile cull of the pair lists ------------------------------------

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "assets", "golden")


def port_pair_bins(scene):
    """(TileBins, statics) of the port's own projection and slot binning at
    W x H: the golden scene (27,627 trained splats, SH 0) or 3,000 random
    splats ("dense")."""
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=0 if scene == "golden" else 1)
    if scene == "golden":
        splats = load_ply(os.path.join(GOLDEN, "golden_scene.ply"), device="cpu")
        eye, target = [0, -1.5, -7.0], [0, 0.5, 0]
    else:
        d = interop.random_splat_arrays(0, 3000, sh_degree=1, scale_range=(-3.5, -1.5))
        splats = interop.splat_set_from_numpy(d, "cpu")
        eye, target = [0.2, -0.3, -9.0], [0, 0, 0]
    cam = tcam.look_at(eye, target, [0, 1, 0], W, H, fov_y_rad=0.9, device="cpu")
    proj = project_splats(splats.prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    return bin_for_cfg(proj, rows.detach(), ids, cfg, 0), t_statics(cfg)


def adversarial_pair_bins():
    """(bins, st, picked pairs, rows): the dense scene with the first pair of
    each of the first busy tiles rewritten to ``adversarial_gs2d_rows``,
    centred on a pixel of that pair's own tile (x offset aside)."""
    bins, st = port_pair_bins("dense")
    rows = adversarial_gs2d_rows(st)
    busy = torch.nonzero(bins.tile_count > 0).flatten()[:len(rows)]
    attrs = bins.attrs.clone()
    for t, (op, a, b, c, dx) in zip(busy.tolist(), rows):
        col = int(bins.tile_start[t])
        attrs[0, col] = (t % st.tiles_x) * 16 + 3.5 + dx
        attrs[1, col] = (t // st.tiles_x) * 16 + 5.5
        attrs[2:6, col] = torch.tensor([a, b, c, op])
    return dataclasses.replace(bins, attrs=attrs), st, bins.tile_start[busy].long(), rows


def pair_cull_bins(scene):
    if scene == "adversarial":
        return adversarial_pair_bins()[:2]
    return port_pair_bins(scene)


def assert_pair_cull_is_exact(bins, st, pix_ctx=None):
    """``pair_may_hit`` keeps every pair whose alpha passes the cutoffs at
    some pixel of its tile (``pair_hits``, frozen pixels too), and marks no
    pair outside the tiles' lists; the hit test sees every hit of the
    twin's sweep. Returns (kept, hit, live) masks."""
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    may = tr.pair_may_hit(*args, pix_ctx=pix_ctx)
    hit = tr.pair_hits(*args, pix_ctx=pix_ctx)
    live = torch.arange(bins.attrs.shape[1]) < int(bins.num_pairs)
    assert may.shape == hit.shape == live.shape
    assert not (may & ~live).any() and not (hit & ~live).any()
    assert hit.any()
    assert int((hit & ~may).sum()) == 0, "the cull dropped a pair that hits"
    swept = torch.zeros_like(live)
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    for s in tr._blend_steps(*args, tiles, pix_ctx)[1]:
        swept[s.pc[(s.alpha > 0).any(dim=1)]] = True
    assert not (swept & ~hit).any()
    return may, hit, live


@pytest.mark.parametrize("scene", ["golden", "dense", "adversarial"])
def test_pair_cull_is_exact(scene):
    bins, st = pair_cull_bins(scene)
    may, hit, live = assert_pair_cull_is_exact(bins, st)
    assert 1.0 - may.sum().item() / live.sum().item() > 0.05  # the square rects lose pairs


def test_pair_cull_on_adversarial_gs2d_rows():
    """Nothing that hits is culled, the opacity one ulp below alpha_min is,
    and every non-finite or non-positive-definite row is kept."""
    bins, st, picked, rows = adversarial_pair_bins()
    may, hit, _ = assert_pair_cull_is_exact(bins, st)
    kept, hits = may[picked].tolist(), hit[picked].tolist()
    assert hits[0] and hits[1] and not hits[2]                       # alpha_min is inclusive
    assert kept[0] and kept[1] and not kept[2]
    assert all(kept[3:13]), kept                                     # degenerate or not finite


def culled_backward(bins, st, ctx, pix_ctx=None, drop=None):
    """The backward twin over every pair, with the pairs of ``drop`` made
    "no pair" in place: zero rows, whose alpha fails the cutoffs in every
    model. The sweep K2 runs where it culls, which stages only the kept
    pairs and stores nothing for the others."""
    attrs = bins.attrs.clone()
    if drop is not None:
        attrs[:, drop] = 0.0
    return tr.rasterize_tiles_bwd_ref(attrs, bins.tile_start, bins.tile_count, ctx, st,
                                      pix_ctx=pix_ctx)


def assert_culled_backward_changes_nothing(bins, st, pix_ctx=None):
    """The backward twin, and the twin with every pair ``pair_may_hit``
    culls taken out, on the cotangent of a seeded normal: equal bit for bit
    (NaN where a non-finite row makes both NaN), the culled pairs' columns
    exactly zero in both. Returns the share of the pairs culled."""
    args = (bins.attrs, bins.tile_start, bins.tile_count)
    out, _ = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                    bins.tile_count, st, pix_ctx=pix_ctx)
    g = torch.from_numpy(np.random.default_rng(5).normal(size=out.shape).astype(np.float32))
    ctx = tr.bwd_context(out, g)
    full = tr.rasterize_tiles_bwd_ref(*args, ctx, st, pix_ctx=pix_ctx)
    torch.testing.assert_close(culled_backward(bins, st, ctx, pix_ctx), full, rtol=0, atol=0,
                               equal_nan=True)                       # the helper is the twin
    live = torch.arange(bins.attrs.shape[1]) < int(bins.num_pairs)
    drop = live & ~tr.pair_may_hit(*args, st, pix_ctx=pix_ctx)
    got = culled_backward(bins, st, ctx, pix_ctx, drop)
    torch.testing.assert_close(got, full, rtol=0, atol=0, equal_nan=True)
    assert (got[:, drop] == 0).all() and (full[:, drop] == 0).all()
    assert (torch.nan_to_num(full) != 0).any()
    return drop.sum().item() / live.sum().item()


@pytest.mark.parametrize("scene", ["golden", "dense", "adversarial"])
def test_culled_backward_changes_nothing_gs2d(scene):
    """K2 stages only the pairs the cull keeps: on the golden frame, the
    dense scene and the adversarial rows, the backward twin without the
    culled pairs equals the full twin bit for bit."""
    bins, st = pair_cull_bins(scene)
    assert assert_culled_backward_changes_nothing(bins, st) > 0.05


def butterfly(v: np.ndarray) -> np.ndarray:
    """(N,) per-value warp sums of (32 lanes, N) f32 values, as lane 0 of a
    warp_sum per value gets them: v += shfl_xor(v, h) for h = 16, 8, 4, 2, 1."""
    lanes = np.arange(32)
    for h in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ h]
    return v[0]


def reduce_scatter(v: np.ndarray) -> np.ndarray:
    """(32,) numpy model of csrc/rasterize_bwd.cu's reduce_scatter over (32
    lanes, N) f32 values, N = 32 or 16: what lane l holds at the end."""
    lanes, n = np.arange(32), v.shape[1]
    for h in (16, 8, 4, 2, 1):
        if h >= n:
            v = v + v[lanes ^ h]
        else:
            upper = ((lanes & h) != 0)[:, None]
            send = np.where(upper, v[:, :h], v[:, h:2 * h])
            keep = np.where(upper, v[:, h:2 * h], v[:, :h])
            v = keep + send[lanes ^ h]
    return v[:, 0]


@pytest.mark.parametrize("n", [32, 16])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reduce_scatter_sums_as_the_warp_sums_bit_for_bit(seed, n):
    """Lane l ends with the warp sum of value l % n, the same bits as a
    butterfly warp_sum of that value: each is summed by the same tree (the
    pairs at xor 16 first, then 8, 4, 2, 1), and an f32 add commutes. The
    values span magnitudes and half are zero (pixels that do not hit), so
    another summation order differs somewhere."""
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(32, n)) * 10.0 ** rng.uniform(-3, 3, (32, n))).astype(np.float32)
    v[rng.random((32, n)) < 0.5] = 0.0
    got = reduce_scatter(v)
    want = butterfly(v)[np.arange(32) % n]
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    serial = np.zeros(n, np.float32)
    for lane in range(32):
        serial = serial + v[lane]
    assert (serial != butterfly(v)).any()


# ---- K1's per-warp cull of the pair lists -------------------------------------

def unfactored_may_hit(blk, bound, st):
    """The per-tile predicate as one function per model, as written before
    it was split into the lane's part (``pair_reach``) and the test against
    a bound (``reach_may_hit``); the factored twin must answer as it does."""
    amin = tresp._f32(st.alpha_min)
    if st.model == "gs2d":
        v = blk[:6].double()
        x, y, ca, cb, cc, op = v
        x0, y0, x1, y1 = bound
        det = ca * cc - cb * cb
        total = ca + cb.abs() + cc
        err = 1e-6 * (total * total / det)
        sure = torch.isfinite(v).all(dim=0) & (amin > 0) & (ca > 0) & (det > 0) & (err <= 0.25)
        tau = torch.fmin(torch.tensor(tresp._f32(st.qmax), dtype=torch.float64),
                         2.0 * torch.log(op / amin)) + 1e-3
        grow = 1.0 + tresp.CULL_REL + err
        rx = torch.sqrt(tau * cc / det) * grow + 1e-2
        ry = torch.sqrt(tau * ca / det) * grow + 1e-2
        miss = (x + rx < x0) | (x - rx > x1) | (y + ry < y0) | (y - ry > y1)
        return ~(sure & ((op < amin) | miss))
    p = blk[0:3]
    inv = 1.0 / torch.clamp(blk[3:6], min=1e-12)
    qw, qx, qy, qz = blk[9:13]
    rot = torch.stack([
        1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy - qw * qz), 2.0 * (qx * qz + qw * qy),
        2.0 * (qx * qy + qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz), 2.0 * (qy * qz - qw * qx),
        2.0 * (qx * qz - qw * qy), 2.0 * (qy * qz + qw * qx), 1.0 - 2.0 * (qx * qx + qy * qy)])
    q = blk[9:13].double()
    v = torch.cat([p.double(), inv.double(), rot.double(), blk[13:14].double(),
                   (q * q).sum(dim=0)[None]])
    op, mr = v[15], tresp._f32(st.kernel_min_response)
    valid, c, a, rho, cos_t, sin_t = bound
    sure = valid & torch.isfinite(v).all(dim=0) & (amin >= 0)
    thr = amin / op
    thr = torch.where(mr > thr, torch.full_like(thr, mr), thr)
    inv_min, inv_max = v[3:6].amin(dim=0), v[3:6].amax(dim=0)
    sig = 1.0 - 2.0 * (v[16] - 1.0).abs() - 1e-5
    shrink = inv_min * sig
    w = v[0:3] - c.permute(1, 0, 2)
    ax = a.permute(1, 0, 2)
    along = (w * ax).sum(dim=0).abs()
    across = torch.linalg.cross(w, ax.expand_as(w), dim=0).norm(dim=0)
    reach = w.norm(dim=0) + rho
    err = 4e-6 * (inv_max / inv_min + 1.0) * reach * inv_max
    r = ((tresp._cut_distance(thr, st.kernel_degree) * (1.0 + 1e-5) + err) / shrink
         * (1.0 + tresp.CULL_REL) + 1e-7 * reach)
    nearest = torch.clamp(across * cos_t - along * sin_t, min=0.0) - rho
    far = (sig >= 0.5) & (shrink >= 1e-10) & (nearest > r)
    return ~(sure & ((op <= amin) | (thr >= 1.0) | far))


def assert_may_hit_unchanged(bins, st, pix_ctx=None):
    """``pair_may_hit``'s tile answers equal ``unfactored_may_hit``'s on
    every pair of ``bins``."""
    tiles = torch.arange(st.tiles_x * st.tiles_y)
    bound = tresp.tile_bound(st, tiles, pix_ctx)
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    want = torch.zeros(bins.attrs.shape[1], dtype=torch.bool)
    for p, _, in_range, rows in tr._chunks(*args, tiles):
        want[p[in_range]] = unfactored_may_hit(rows, bound, st)[in_range]
    got = tr.pair_may_hit(*args, pix_ctx=pix_ctx)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(bins.num_pairs)


def assert_pair_warp_cull_is_exact(bins, st, pix_ctx=None):
    """``pair_warp_may_hit`` keeps every (warp, pair) whose alpha passes the
    cutoffs at some pixel of the warp (``pair_hits(per_warp=True)``, frozen
    pixels too), marks nothing outside the tiles' lists, and the per-warp
    hits are the tile's hits split by ``WARP_PIXELS``. Returns (kept, hit)
    (P, 8) masks."""
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    may = tr.pair_warp_may_hit(*args, pix_ctx=pix_ctx)
    hit = tr.pair_hits(*args, pix_ctx=pix_ctx, per_warp=True)
    live = torch.arange(bins.attrs.shape[1]) < int(bins.num_pairs)
    assert may.shape == hit.shape == (bins.attrs.shape[1], tresp.WARPS)
    assert not may[~live].any() and hit.any()
    assert torch.equal(hit.any(dim=1), tr.pair_hits(*args, pix_ctx=pix_ctx))
    assert int((hit & ~may).sum()) == 0, "the cull dropped a (warp, pair) that hits"
    return may, hit


def culled_forward(bins, st, pix_ctx=None, keep=None):
    """The forward twin over every pair, each warp's pixels taken from a
    sweep in which the pairs ``keep`` (P, 8) drops for that warp are made
    "no pair" (zero rows, whose alpha fails the cutoffs in every model): the
    sweep K1 runs, whose warps skip the (warp, pair)s their cull drops."""
    out, out_id = tr.rasterize_tiles_ref(bins.attrs, bins.pair_id, bins.tile_start,
                                         bins.tile_count, st, pix_ctx=pix_ctx)
    if keep is None:
        return out, out_id
    out, out_id = out.clone(), out_id.clone()
    for w in range(tresp.WARPS):
        attrs = bins.attrs.clone()
        attrs[:, ~keep[:, w]] = 0.0
        o, i = tr.rasterize_tiles_ref(attrs, bins.pair_id, bins.tile_start, bins.tile_count, st,
                                      pix_ctx=pix_ctx)
        px = tresp.WARP_PIXELS[w]
        out[:, :, px], out_id[:, px] = o[:, :, px], i[:, px]
    return out, out_id


def assert_warp_culled_sweep_changes_nothing(bins, st, pix_ctx=None):
    """The forward twin, and the twin with every (warp, pair) that
    ``pair_warp_may_hit`` culls taken out, give the same rgb, T, depth and
    id bit for bit. Returns (the culled sweep, the share of the live
    (warp, pair)s culled)."""
    args = (bins.attrs, bins.tile_start, bins.tile_count, st)
    full, full_id = culled_forward(bins, st, pix_ctx)
    keep = tr.pair_warp_may_hit(*args, pix_ctx=pix_ctx)
    live = torch.arange(bins.attrs.shape[1]) < int(bins.num_pairs)
    keep[~live] = True                   # pairs past num_pairs lie in no tile's range
    got, got_id = culled_forward(bins, st, pix_ctx, keep)
    torch.testing.assert_close(got, full, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(got_id, full_id) and (full_id >= 0).any()
    return (got, got_id), 1.0 - keep[live].float().mean().item()


@pytest.mark.parametrize("scene", ["golden", "dense", "adversarial"])
def test_pair_warp_cull_is_exact(scene):
    """No (warp, pair) that hits is culled; each warp keeps no pair the
    tile cull drops (a warp's pixel centres lie in the tile's box); and the
    warps keep far fewer evaluations than the tile cull."""
    bins, st = pair_cull_bins(scene)
    may, _ = assert_pair_warp_cull_is_exact(bins, st)
    tile = tr.pair_may_hit(bins.attrs, bins.tile_start, bins.tile_count, st)
    assert not (may & ~tile[:, None]).any()
    assert may.sum().item() < 0.5 * tresp.WARPS * tile.sum().item()


@pytest.mark.parametrize("scene", ["golden", "dense", "adversarial"])
def test_warp_culled_sweep_changes_nothing_gs2d(scene):
    """K1's warps skip the (warp, pair)s the cull drops: on the golden
    frame, the dense scene and the adversarial rows the forward twin
    without them equals the full twin bit for bit."""
    bins, st = pair_cull_bins(scene)
    _, culled = assert_warp_culled_sweep_changes_nothing(bins, st)
    assert culled > 0.5


def test_warp_culled_sweep_matches_jax_kernel(blended):
    """On the JAX package's scenes (one of them freezing pixels over
    several steps), the warp-culled forward twin equals the twin bit for
    bit and so meets the JAX kernel at the twin's tolerances."""
    _, bins_j, out_j, (attrs, ids, start, count), (out_t, id_t) = blended
    st = statics()
    bins = types.SimpleNamespace(attrs=attrs, pair_id=ids, tile_start=start, tile_count=count,
                                 num_pairs=attrs.shape[1])
    (got, got_id), culled = assert_warp_culled_sweep_changes_nothing(bins, st)
    assert torch.equal(got, out_t) and torch.equal(got_id, id_t) and culled > 0.5
    img_j, t_j = (np.asarray(a) for a in jr.assemble_image(
        out_j, bins_j.seg_counts, st.tiles_x, st.tiles_y, W, H, with_aux=True)[:2])
    img_t, t_t = (a.numpy() for a in tr.assemble_image(got, got_id, st.tiles_x, st.tiles_y,
                                                        W, H)[:2])
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=IMG_ATOL)
    np.testing.assert_allclose(t_t, t_j, rtol=0, atol=IMG_ATOL)


def test_warp_pixels_cover_each_pixel_once():
    """K1's thread order (csrc/response.cuh warp_pixel): each pixel of the
    tile belongs to exactly one warp, each warp to an 8x4 block, and
    WARP_OF_PIXEL inverts the map."""
    px = tresp.WARP_PIXELS
    assert px.shape == (tresp.WARPS, 32)
    assert torch.equal(px.flatten().sort().values, torch.arange(tr.PIX))
    for w in range(tresp.WARPS):
        x, y = px[w] % 16, px[w] // 16
        assert (x.max() - x.min(), y.max() - y.min()) == (7, 3)
        assert (x.min(), y.min()) == (8 * (w % 2), 4 * (w // 2))
        assert torch.equal(px[w, :8], px[w, 0] + torch.arange(8))     # lanes run along x
    assert torch.equal(tresp.WARP_OF_PIXEL[px], torch.arange(tresp.WARPS)[:, None].expand(-1, 32))


def test_blend_work_counts_a_warp_cull(blended):
    """blend_work with a (P, 8) ``keep``: kept counts (warp, pair) bits over
    the steps a tile enters and kept evaluations the live (pixel, pair)s
    whose warp keeps the pair. Every bit keeps 8 per tested pair and every
    evaluation and draw; none keeps nothing; the eight one-warp masks split
    the evaluations and the draws."""
    _, _, _, (attrs, _, start, count), _ = blended
    st = statics()
    evals, hits, tested, _, _, _ = tr.blend_work(
        attrs, start, count, st, keep=torch.ones(attrs.shape[1], dtype=torch.bool))
    every = torch.ones((attrs.shape[1], tresp.WARPS), dtype=torch.bool)
    assert tr.blend_work(attrs, start, count, st, keep=every) == (
        evals, hits, tested, tresp.WARPS * tested, evals, hits)
    assert tr.blend_work(attrs, start, count, st, keep=~every)[2:] == (tested, 0, 0, 0)
    parts = []
    for w in range(tresp.WARPS):
        one_warp = torch.zeros_like(every)
        one_warp[:, w] = True
        parts.append(tr.blend_work(attrs, start, count, st, keep=one_warp)[3:])
        assert parts[-1][0] == tested and 0 < parts[-1][1] < evals
    assert sum(k for _, k, _ in parts) == evals and sum(d for _, _, d in parts) == hits


@pytest.mark.parametrize("scene", ["golden", "dense", "adversarial"])
def test_may_hit_tile_answers_unchanged_gs2d(scene):
    assert_may_hit_unchanged(*pair_cull_bins(scene))


def test_warp_sum_twin_adds_as_the_butterfly():
    """ops/response._warp_sum, which gut3d's warp bound sums with, gives
    lane 0's bits of csrc/response.cuh warp_sum_d, modelled by
    ``butterfly`` above (in double here), and differs from a serial sum."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(32, 64)) * 10.0 ** rng.uniform(-3, 3, (32, 64))
    got = tresp._warp_sum(torch.from_numpy(v.T.copy())).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), butterfly(v).view(np.uint64))
    assert (got != np.cumsum(v, axis=0)[-1]).any()
