"""The packed tier (``RasterConfig.pair_format="packed"``: the response
models gs2dp and gut3dp, forward only) on the CPU: the port against the JAX
package from the same numpy inputs, and against its own f32 frames.

Tolerances, each stated where it is used:
- packing and unpacking, and the packed attribute rows made from the same
  f32 quantities: bit-equal (int32 views of the words);
- gs2dp frames against the JAX package's packed frames: the f32 path's
  (verify SKILL, tests/test_torch_render.py), image and transmittance 5e-5
  max abs, picked depth 1e-5 where both picked the same splat, ids equal on
  >= 99.9 % of pixels;
- gut3dp frames: tests/test_torch_gut.py's flip-aware gates, >= 99.9 % of
  channels within 5e-5 and none beyond 1.2e-2, ids >= 99.9 %;
- packed against the port's own f32 frame: PSNR > 55 dB with ids equal on
  > 99 % of pixels (the JAX package's gate, tests/test_rasterize.py:178,
  tests/test_gut.py:205).
The JAX frames are computed once per module (interpret-mode programs are
heavy to compile).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import response as jresp
from vk_gaussian_splatting_tpu.render import pipelines as jp
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch import train as tt
from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops import response as tresp
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats, ut_project_splats
from vk_gaussian_splatting_tpu_torch.render import pipelines as tp
from vk_gaussian_splatting_tpu_torch.render import render
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays
from test_torch_bucket import assert_cull_is_exact, assert_culled_sweep_changes_nothing
from test_torch_rasterize import (
    assert_pair_cull_is_exact,
    assert_pair_warp_cull_is_exact,
    assert_warp_culled_sweep_changes_nothing,
)

torch.set_num_threads(2)

IMG_ATOL, DEPTH_ATOL, ID_AGREE = 5e-5, 1e-5, 0.999   # gs2dp against JAX
GUT_SHARE, GUT_MAX = 0.999, 1.2e-2                    # gut3dp against JAX
PSNR_DB, F32_ID_AGREE = 55.0, 0.99                    # packed against f32
W, H = 128, 96


def bits(x) -> np.ndarray:
    """The int32 view of f32 words (a torch tensor or a JAX array)."""
    a = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# ---- (a) packing and unpacking, bit for bit ----------------------------------

TIE_DOWN, TIE_UP = 1.00390625, 1.01171875  # halfway between bf16 neighbours
EDGE = np.array([0.0, -0.0, 1.0, -1.0, TIE_DOWN, TIE_UP, -TIE_UP, np.nextafter(TIE_DOWN, 2),
                 1e-39, -1e-45, 1.2e-38, 65504.0, 1e4, -2.5e5, 3.0e38, 3.4028235e38,
                 1.0 / 3.0, np.inf, -np.inf], np.float32)


def edge_pairs(seed=0, n=400):
    """(hi, lo): every pair of the edge values, then seeded normals at
    scales 1e-3 .. 1e4 (conics, colours, scales)."""
    hi, lo = np.meshgrid(EDGE, EDGE)
    rng = np.random.default_rng(seed)
    r = (rng.normal(size=(2, n)) * 10.0 ** rng.uniform(-3, 4, (2, n))).astype(np.float32)
    return (np.concatenate([hi.ravel(), r[0]]).astype(np.float32),
            np.concatenate([lo.ravel(), r[1]]).astype(np.float32))


UNIT = np.array([0.0, 1.0, -0.0, 0.5, 0.25, -0.1, 1.5, 7.0, 1e-9, 0.99999, 1.0 - 2 ** -24]
                + [(k + 0.5) / 65535.0 for k in (0, 1, 2, 100, 65534)], np.float32)


def test_pack2bf16_matches_jax_bit_for_bit():
    hi, lo = edge_pairs()
    got = tresp.pack2bf16(torch.from_numpy(hi), torch.from_numpy(lo))
    want = jresp.pack2bf16(jnp.asarray(hi), jnp.asarray(lo))
    np.testing.assert_array_equal(bits(got), bits(want))
    # the high half is +-0 where hi is: those words are f32 subnormals (or zero)
    sub = (hi == 0) & (lo != 0) & np.isfinite(lo)
    assert sub.any() and (np.abs(got.numpy()[sub]) < np.finfo(np.float32).tiny).all()


def test_pack_bf16_u16_matches_jax_bit_for_bit():
    hi, _ = edge_pairs()
    u = np.resize(UNIT, hi.shape)
    got = tresp.pack_bf16_u16(torch.from_numpy(hi), torch.from_numpy(u))
    want = jresp.pack_bf16_u16(jnp.asarray(hi), jnp.asarray(u))
    np.testing.assert_array_equal(bits(got), bits(want))
    low = bits(got) & 0xFFFF
    assert low.min() == 0 and low.max() == 65535          # out of range clamps


@pytest.mark.parametrize("which", ["bf16_pair", "bf16_u16"])
def test_unpack_matches_jax_bit_for_bit(which):
    """Unpacking by mask, shift and bitcast, the subnormal words included."""
    hi, lo = edge_pairs(1)
    if which == "bf16_pair":
        word = jresp.pack2bf16(jnp.asarray(hi), jnp.asarray(lo))
        got, want = tresp.unpack2bf16(torch.from_numpy(np.array(word))), jresp.unpack2bf16(word)
    else:
        word = jresp.pack_bf16_u16(jnp.asarray(hi), jnp.asarray(np.resize(UNIT, hi.shape)))
        got = tresp.unpack_bf16_u16(torch.from_numpy(np.array(word)))
        want = jresp.unpack_bf16_u16(word)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))


def scene(n=2000, seed=0, zero_channels=True):
    """A 3DGS scene for both packages: scales exp(-3.5 .. -1.5), and (with
    ``zero_channels``) a third of the splats with red, a third with blue
    clamped to 0 and quaternions with an x or z of 0, whose packed words
    are f32 subnormals."""
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-3.5, -1.5))
    if zero_channels:
        d["sh_dc"][0::3, 0] = -6.0
        d["sh_dc"][1::3, 2] = -6.0
        d["sh_rest"][0::3, :, 0] = 0.0
        d["sh_rest"][1::3, :, 2] = 0.0
        d["quats"][0::4, 1] = 0.0
        d["quats"][1::4, 3] = 0.0
    return d


def camera(w=W, h=H):
    cam_t = gt.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9,
                       device="cpu")
    return cam_t, jcam.make_camera(**interop.camera_to_numpy(cam_t))


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_packed_words_survive_binning_bit_for_bit(method):
    """Binning only moves the packed words: each sorted pair's (or slot's)
    words equal its splat's, subnormal words included, and unpack to the
    same f32 rows."""
    cam, _ = camera()
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=1,
                          raster=tc.RasterConfig(method=method, pair_format="packed"))
    proj = project_splats(interop.splat_set_from_numpy(scene(), "cpu").prepare(), cam, cfg)
    rows, ids = tp.gs_attr_rows_packed(proj)
    bins = tp.bin_for_cfg(proj, rows, ids, cfg, 0, tp.raster_statics(cfg))
    if method == "bucket":
        live, src = torch.arange(bins.attrs.shape[1]) < int(bins.num_valid), bins.ids
    else:
        live, src = bins.pair_valid, bins.pair_id
    got, want = bins.attrs[:, live], rows[:, src[live].long()]
    np.testing.assert_array_equal(bits(got), bits(want))
    high = bits(got)[tresp.GSP_RG:tresp.GSP_BO + 1] & -65536
    assert ((high == 0) | (high == -2 ** 31)).any()    # subnormal words were binned
    torch.testing.assert_close(tresp.unpack_rows("gs2dp", got), tresp.unpack_rows("gs2dp", want),
                               rtol=0, atol=0)


# ---- (b) the packed attribute rows from the same f32 quantities ------------

def proj_arrays(n=600, seed=3):
    """ProjectedSplats fields as numpy, with zero colours, opacities 0 and
    1 and out of range, and large conics among them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    color = rng.uniform(0, 1.2, (n, 3)).astype(f32)
    color[0::5, 0] = 0.0
    color[1::5, 2] = 0.0
    alpha = rng.uniform(-0.1, 1.1, n).astype(f32)
    alpha[:4] = [0.0, 1.0, 0.5 / 65535.0, 1.5 / 65535.0]
    conic = (rng.uniform(0.01, 2.0, (n, 3)) * 10.0 ** rng.uniform(-2, 4, (n, 1))).astype(f32)
    conic[2::7, 1] = 0.0
    return dict(xy=rng.uniform(-10, 140, (n, 2)).astype(f32), conic=conic,
                depth=rng.uniform(0.2, 30, n).astype(f32), color=color, alpha=alpha)


def test_gs_attr_rows_packed_match_jax_bit_for_bit():
    a = proj_arrays()
    rows, ids = tp.gs_attr_rows_packed(
        types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in a.items()}))
    want = jp.gs_attr_rows_packed(types.SimpleNamespace(**{k: jnp.asarray(v)
                                                           for k, v in a.items()}))
    assert rows.shape == (tresp.GSP_ROWS, a["alpha"].shape[0])
    np.testing.assert_array_equal(bits(rows), bits(want)[:tresp.GSP_ROWS])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[jresp.GSP_ID]).astype(np.int32))


def gut_inputs(n=2000, seed=4):
    """gut_attr_rows_packed's inputs for both packages, kept to the splats
    whose f32 gut3d rows both packages make alike: XLA and torch round exp
    and the quaternion's norm apart on 10-35 % of them, and the packed rows
    are to compare the packing of the same f32 quantities."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    scales_log = rng.uniform(-6.0, 0.5, (n, 3)).astype(f32)
    quats = rng.normal(size=(n, 4)).astype(f32)
    quats[0::4, 1] = 0.0
    quats[1::4, 3] = 0.0
    cfg_t, cfg_j = tc.RenderConfig(), jc.RenderConfig()
    prep = dict(means=rng.uniform(-3, 3, (n, 3)).astype(f32), scales_log=scales_log,
                quats=quats)
    a = proj_arrays(n, seed)
    f32_t = tp.gut_attr_rows(types.SimpleNamespace(**{k: torch.from_numpy(v)
                                                       for k, v in prep.items()}),
                             types.SimpleNamespace(**{k: torch.from_numpy(v)
                                                      for k, v in a.items()}), cfg_t)[0]
    f32_j = jp.gut_attr_rows(types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in prep.items()}),
                             types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in a.items()}),
                             cfg_j)
    same = (bits(f32_t) == bits(f32_j)[:tresp.GUT_ROWS]).all(axis=0)
    keep = np.nonzero(same)[0]
    assert keep.size > n // 3
    prep = {k: v[keep] for k, v in prep.items()}
    proj = {k: v[keep] for k, v in a.items()}
    return prep, proj, cfg_t, cfg_j


@pytest.mark.parametrize("depth", ["view_z", "radial"])
def test_gut_attr_rows_packed_match_jax_bit_for_bit(depth):
    prep, proj, cfg_t, cfg_j = gut_inputs()
    radial = np.linalg.norm(prep["means"], axis=-1).astype(np.float32)

    def ns(d, to):
        return types.SimpleNamespace(**{k: to(v) for k, v in d.items()})

    kw_t = {} if depth == "view_z" else dict(depth=torch.from_numpy(radial))
    kw_j = {} if depth == "view_z" else dict(depth=jnp.asarray(radial))
    rows, ids = tp.gut_attr_rows_packed(ns(prep, torch.from_numpy), ns(proj, torch.from_numpy),
                                        cfg_t, **kw_t)
    want = jp.gut_attr_rows_packed(ns(prep, jnp.asarray), ns(proj, jnp.asarray), cfg_j, **kw_j)
    assert rows.shape == (tresp.GUTP_ROWS, radial.shape[0])
    np.testing.assert_array_equal(bits(rows), bits(want)[:tresp.GUTP_ROWS])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[jresp.GUTP_ID]).astype(np.int32))
    high = bits(rows)[tresp.GUTP_QXY:tresp.GUTP_QZD + 1] & -65536
    assert ((high == 0) | (high == -2 ** 31)).any()     # quaternion words that are subnormal


# ---- (c), (d) frames: against the JAX package, and against f32 --------------

JAX_RENDER = {"3dgs": jp.render_3dgs, "3dgut": jp.render_3dgut, "3dgrt": jp.render_3dgrt}
PIPELINE = {"3dgs": "MESH", "3dgut": "MESH_3DGUT", "3dgrt": "RTX"}
FRAME_NAMES = [f"{p}_{m}" for p in JAX_RENDER for m in ("pairs", "bucket")]
CAPS = (512, 256, 512, 256)


def cfgs(name, pair_format="packed"):
    pipe, method = name.split("_")
    kw = dict(width=W, height=H, sh_degree=1)
    raster = dict(method=method, pair_format=pair_format, bucket_caps=CAPS)
    return (jc.RenderConfig(**kw, pipeline=jc.Pipeline[PIPELINE[pipe]],
                            raster=jc.RasterConfig(**raster)),
            tc.RenderConfig(**kw, pipeline=tc.Pipeline[PIPELINE[pipe]],
                            raster=tc.RasterConfig(**raster)))


def frame_scene(name):
    """2,000 splats for 3DGS, 1,000 for the gut3d frames (the subnormal
    words of ``scene`` in both)."""
    return scene(2000 if name.startswith("3dgs") else 1000, seed=1)


@pytest.fixture(scope="module")
def frames():
    """{name: (JAX packed frame, port packed frame, port f32 frame)}."""
    cam_t, cam_j = camera()
    out = {}
    for name in FRAME_NAMES:
        d = frame_scene(name)
        cj, ct = cfgs(name)
        sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
        oj = JAX_RENDER[name.split("_")[0]](sj.prepare(), cam_j, cj, max_pairs=1 << 16)
        prep = interop.splat_set_from_numpy(d, "cpu").prepare()
        out[name] = (oj, render(prep, cam_t, ct), render(prep, cam_t, cfgs(name, "f32")[1]))
    return out


@pytest.mark.parametrize("name", FRAME_NAMES)
def test_packed_frame_matches_jax(frames, name):
    oj, ot, _ = frames[name]
    assert bool(oj.overflow) == bool(ot.overflow)
    assert int(oj.num_pairs) == int(ot.num_pairs)
    id_j, id_t = np.asarray(oj.splat_id), ot.splat_id.numpy()
    same = id_j == id_t
    assert same.mean() >= ID_AGREE, same.mean()
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(a.numpy() - np.asarray(b))
        if name.startswith("3dgs"):
            assert diff.max() <= IMG_ATOL, diff.max()
        else:
            assert (diff <= IMG_ATOL).mean() >= GUT_SHARE, (diff > IMG_ATOL).mean()
            assert diff.max() <= GUT_MAX, diff.max()
    both = same & (id_j >= 0)
    depth_ok = np.abs(ot.depth.numpy() - np.asarray(oj.depth)) <= DEPTH_ATOL
    assert depth_ok[both].mean() >= ID_AGREE
    assert float(ot.transmittance.min()) < 0.5  # the scene covers pixels


@pytest.mark.parametrize("name", FRAME_NAMES)
def test_packed_frame_against_f32(frames, name):
    _, packed, f32 = frames[name]
    i1, i2 = f32.image.numpy(), packed.image.numpy()
    mse = float(np.mean((i1 - i2) ** 2))
    psnr = 10 * np.log10(max(float(i1.max()), 1.0) ** 2 / max(mse, 1e-12))
    assert psnr > PSNR_DB, psnr
    assert (f32.splat_id == packed.splat_id).float().mean().item() > F32_ID_AGREE
    assert not torch.equal(f32.image, packed.image)  # the packed tier did round


def test_3dgrt_bucket_packs_the_radial_depth(frames):
    """On the bucket path 3DGRT's radial distance is the packed depth row
    (the merge key) and so the picked depth; on the pair path view z."""
    cam, _ = camera()
    d = frame_scene("3dgrt_bucket")
    radial = torch.linalg.norm(torch.from_numpy(d["means"]) - cam.position, dim=-1)
    for name, want_radial in (("3dgrt_bucket", True), ("3dgrt_pairs", False)):
        out = frames[name][1]
        ids = out.splat_id[out.splat_id >= 0].long()
        picked = out.depth[out.splat_id >= 0]
        assert torch.equal(picked, radial[ids]) == want_radial


# ---- (e) the cull twins keep every lane and pair that hits ------------------

def packed_bins(model, method, n=1500, seed=5):
    cam, _ = camera()
    pipe = gt.Pipeline.MESH_3DGUT if model == "gut3dp" else gt.Pipeline.MESH
    cfg = tc.RenderConfig(width=W, height=H, sh_degree=1, pipeline=pipe, raster=tc.RasterConfig(
        method=method, pair_format="packed", bucket_caps=CAPS, chunk=64))
    prep = interop.splat_set_from_numpy(
        interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-5.0, 0.0)),
        "cpu").prepare()
    if model == "gut3dp":
        bins, st = tp.gut_bin(prep, ut_project_splats(prep, cam, cfg), cam, cfg)
        pix = build_tile_rays(cam, cfg)
    else:
        proj = project_splats(prep, cam, cfg)
        st = tp.raster_statics(cfg)
        bins = tp.bin_for_cfg(proj, *tp.gs_attr_rows_packed(proj), cfg, 0, st)
        pix = None
    if method == "bucket":
        st = dataclasses.replace(st, chunk=cfg.raster.bucket_chunk)
    assert st.model == model
    return bins, st, pix


@pytest.mark.parametrize("model", ["gs2dp", "gut3dp"])
def test_pair_culls_on_packed_rows_keep_every_hit(model):
    bins, st, pix = packed_bins(model, "pairs")
    may, hit, _ = assert_pair_cull_is_exact(bins, st, pix)
    warp_may, _ = assert_pair_warp_cull_is_exact(bins, st, pix)
    assert int(warp_may.any(dim=1).sum()) < int(bins.num_pairs)   # it culls
    _, culled = assert_warp_culled_sweep_changes_nothing(bins, st, pix)
    assert culled > 0.05


@pytest.mark.parametrize("model", ["gs2dp", "gut3dp"])
def test_bucket_cull_on_packed_rows_keeps_every_hit(model):
    bins, st, pix = packed_bins(model, "bucket")
    assert_cull_is_exact(bins.attrs, bins.bucket_starts, st, CAPS, pix, min_culled=0.05)
    culled = assert_culled_sweep_changes_nothing(bins.attrs, bins.ids, bins.bucket_starts, st,
                                                 CAPS, pix)
    assert culled > 0.05


# ---- (f) forward only; (g) the id limit ---------------------------------------

@pytest.mark.parametrize("name", ["3dgs_pairs", "3dgs_bucket", "3dgut_pairs", "3dgrt_bucket"])
def test_backward_through_a_packed_frame_raises(name):
    cam, _ = camera(64, 48)
    ct = cfgs(name)[1].replace(width=64, height=48)
    splats = interop.splat_set_from_numpy(scene(300, 6), "cpu")
    for f in interop.SPLAT_FIELDS:
        getattr(splats, f).requires_grad_()
    out = render(splats.prepare(), cam, ct)
    assert out.image.requires_grad       # the exact rows carry a graph to the blend
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.image.sum().backward()


@pytest.mark.parametrize("pipeline", ["MESH", "MESH_3DGUT"])
def test_packed_train_step_raises_and_moves_nothing(pipeline):
    cam, _ = camera(64, 48)
    cfg = tc.RenderConfig(width=64, height=48, sh_degree=1, pipeline=tc.Pipeline[pipeline],
                          raster=tc.RasterConfig(pair_format="packed"))
    splats = interop.splat_set_from_numpy(scene(300, 7), "cpu")
    tcfg = tt.TrainConfig(scene_extent=3.0)
    opt = tt.make_optimizer(splats, tcfg)
    before = [getattr(splats, f).detach().clone() for f in interop.SPLAT_FIELDS]
    with pytest.raises(NotImplementedError, match="forward-only"):
        tt.train_step(splats, opt, cam, torch.zeros((48, 64, 3)), cfg, 0, tcfg)
    assert all(torch.equal(b, getattr(splats, f))
               for b, f in zip(before, interop.SPLAT_FIELDS))


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_packed_backward_twins_raise(method):
    bins, st, pix = packed_bins("gs2dp", method, n=200)
    ctx = torch.zeros((st.tiles_x * st.tiles_y, tr.CTX_ROWS, tr.PIX))
    with pytest.raises(NotImplementedError, match="forward-only"):
        if method == "bucket":
            rb.rasterize_buckets_bwd(bins.attrs, bins.bucket_starts, ctx, st, CAPS)
        else:
            tr.rasterize_tiles_bwd(bins.attrs, bins.tile_start, bins.tile_count, ctx, st)


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_packed_host_order_takes_the_pair_path(method):
    """The packed frame with a host order (refused before the host-sorted
    path was ported): packed rows have no room for the key row, so both
    methods render the packed pair frame in the host order, as the JAX
    ``render_3dgs`` does (its ``use_bucket``); a fresh order gives the
    device-sorted packed pair frame (tests/test_torch_host_order.py holds
    it against the JAX package)."""
    cam, _ = camera(32, 32)
    prep = interop.splat_set_from_numpy(scene(50, 8), "cpu").prepare()
    cfg = tc.RenderConfig(width=32, height=32,
                          raster=tc.RasterConfig(pair_format="packed", method=method))
    order = torch.argsort(prep.means[:, 2], stable=True)
    out = tp.render_3dgs(prep, cam, cfg, host_order=order)
    ref = tp.render_3dgs(prep, cam, cfg.replace(raster=tc.RasterConfig(pair_format="packed")))
    assert float(out.transmittance.min()) < 0.5
    assert (out.image - ref.image).abs().max().item() <= 1e-5


# the options packed frames refused before stochastic transparency was ported
@pytest.mark.parametrize("what, cfg", [
    ("stochastic", dict(stochastic="SPLAT")),
    ("atrous", dict(denoise="atrous"))])
def test_packed_with_stochastic_options_matches_jax(what, cfg):
    """A packed 3DGS frame with a stochastic mode or the a-trous pass
    against the JAX package's packed frame: the f32 gates of this file."""
    cam_t, cam_j = camera(32, 32)
    kw = dict(cfg)
    mode = kw.pop("stochastic", "NONE")
    d = scene(50, 8)
    oj = jp.render_3dgs(jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare(),
                        cam_j, jc.RenderConfig(width=32, height=32,
                                               stochastic=jc.StochasticMode[mode], **kw,
                                               raster=jc.RasterConfig(pair_format="packed")))
    ot = tp.render_3dgs(interop.splat_set_from_numpy(d, "cpu").prepare(), cam_t,
                        tc.RenderConfig(width=32, height=32, stochastic=tc.StochasticMode[mode],
                                        **kw, raster=tc.RasterConfig(pair_format="packed")))
    assert float(ot.transmittance.min()) < 0.5  # the scene covers pixels
    np.testing.assert_allclose(ot.image.numpy(), np.asarray(oj.image), rtol=0, atol=IMG_ATOL)
    assert (ot.splat_id.numpy() == np.asarray(oj.splat_id)).mean() >= ID_AGREE


@pytest.mark.parametrize("model", ["gs2dp", "gut3dp"])
def test_packed_rows_refuse_ids_past_2_24(model):
    n = 1 << 24
    proj = types.SimpleNamespace(xy=torch.zeros(1, 2).expand(n, 2))
    with pytest.raises(ValueError, match="2\\^24"):
        if model == "gs2dp":
            tp.gs_attr_rows_packed(proj)
        else:
            tp.gut_attr_rows_packed(None, proj, tc.RenderConfig())
    tp.check_single_row_ids(n - 1)
