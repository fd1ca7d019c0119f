"""Multi-instance scenes on the CPU: the port's scene/instances.py and the SH
band rotation of ops/sh.py against the JAX package's, on one numpy input
(``interop.random_splat_arrays``, ``interop.splat_scene_from_numpy``), and
the flattened scene's frames against JAX's (the JAX kernels in interpret
mode, as tests/test_instances_metrics.py runs them).

Tolerances:
- host math: ``decompose_rigid_uniform``, ``rotmat_to_quat``,
  ``_rotmat_to_quat_batched`` and ``bake_general_transform`` are the same
  numpy in both packages: bit-equal. ``quat_multiply``: 1e-7.
- ``band_rotation`` for degrees 1-3: 1e-6 (both evaluate the basis on
  float32 directions); ``rotate_sh_rest``: 1e-6 of each row's largest
  value; rotated coefficients evaluated at R d equal the originals at d
  within 1e-5.
- ``flatten``: the table's ``instance_id``, ``local_id`` and
  ``instance_base`` exactly; means, scales, quats, colour and SH within
  1e-6 of each row's largest value; ``cov3d`` within 1e-6 of its trace
  (tests/test_torch_scene.py). The general bake's factorization is not
  unique for equal eigenvalues, so the general path is held by its means
  and covariance only.
- frames of the flattened scene (pairs and bucket) at the gs2d gate of
  tests/test_torch_render.py with 3e-5 in place of 5e-5: image and T within
  3e-5 on >= 99.9 % of channels and none beyond 1.2e-2 (a cutoff the two
  packages round apart drops one contribution), ids equal on >= 99.9 % of
  pixels, depth within 1e-5 where the ids agree.
- ``render_3dgs_lit`` with one DeferredMaterial per instance, routed by
  ``table.instance_base``: the lighting gates of
  tests/test_torch_lighting.py (the frame at the gs2d gates, the shaded
  image within 1e-4 on >= 99.9 % of channels, none beyond 1.2e-2).

JAX programs built here: two raster frames, one lit frame and one render of
the JAX invariant (about 40 s alone).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.ops import sh as jsh
from vk_gaussian_splatting_tpu.render import deferred as jd
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs_lit as j_lit
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import instances as ji
from vk_gaussian_splatting_tpu.scene import lights as jl
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.ops import sh as tsh
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import (
    BucketGridSpec,
    fit_caps,
    measure_required_caps,
)
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.render import deferred as td
from vk_gaussian_splatting_tpu_torch.render import render_3dgs, render_3dgs_lit
from vk_gaussian_splatting_tpu_torch.scene import instances as ti
from vk_gaussian_splatting_tpu_torch.scene import lights as tl
from vk_gaussian_splatting_tpu_torch.scene.splat_set import quat_to_rotmat

torch.set_num_threads(2)

RTOL = 1e-6
QUAT_ATOL = 1e-7
BAND_ATOL = 1e-6
SH_EVAL_ATOL = 1e-5
IMG_ATOL, IMG_SHARE, IMG_MAX = 3e-5, 0.999, 1.2e-2
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999
LIT_ATOL = 1e-4
W, H = 128, 96
FIELDS = ("means", "scales_log", "quats", "color", "sh")


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_rows_close(a, b, rtol=RTOL, scale=None):
    """|a - b| <= rtol * scale, row by row; scale defaults to the row's
    largest |a|."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    if scale is None:
        scale = np.abs(a).max(axis=1, keepdims=True)
    err = (np.abs(a - b) / np.maximum(scale, 1e-30)).max() if len(a) else 0.0
    assert err <= rtol, err


def assert_cov_close(a, b):
    a = np.asarray(a, np.float64)
    assert_rows_close(a, b, scale=a[:, [0, 3, 5]].sum(axis=1, keepdims=True))


def rotation(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def transform(linear=np.eye(3), t=(0.0, 0.0, 0.0)):
    m = np.eye(4)
    m[:3, :3] = linear
    m[:3, 3] = t
    return m


RIGID = transform(0.8 * rotation([1.0, 2.0, 0.5], np.radians(35.0)), (1.2, -0.4, 0.8))
SHEAR = transform(np.array([[1.4, 0.25, 0.0], [0.0, 0.7, 0.0], [0.0, 0.0, 1.0]]),
                  (-1.0, 0.5, 0.3))
NONUNIFORM = transform(np.diag([1.6, 0.6, 1.1]) @ rotation([0.0, 1.0, 1.0], 0.4),
                       (0.4, 1.0, -0.5))
REFLECT = transform(np.diag([-1.0, 1.0, 1.0]) @ rotation([1.0, 0.0, 1.0], 0.3),
                    (0.0, -1.0, 0.5))


def asset(seed, n, degree):
    return interop.random_splat_arrays(seed, n, sh_degree=degree, extent=2.0,
                                       scale_range=(-3.5, -1.5))


# name: ([(asset seed, n, SH degree)], [instance dicts])
CASES = {
    "identity": ([(1, 300, 3)], [dict(asset=0)]),
    "rigid_sh3": ([(2, 300, 3)], [dict(asset=0, transform=RIGID)]),
    "general_nonuniform": ([(3, 300, 3)], [dict(asset=0, transform=NONUNIFORM)]),
    "general_shear": ([(4, 300, 2)], [dict(asset=0, transform=SHEAR)]),
    "reflection": ([(5, 300, 3)], [dict(asset=0, transform=REFLECT)]),
    "opacity_gain": ([(6, 300, 1)], [dict(asset=0, transform=RIGID, opacity_gain=0.6)]),
    "splat_scale": ([(7, 300, 3)], [dict(asset=0, transform=RIGID, splat_scale=1.25),
                                    dict(asset=0, transform=SHEAR, splat_scale=0.7)]),
    "invisible": ([(8, 200, 3), (9, 150, 1)],
                  [dict(asset=0, visible=False), dict(asset=1, transform=RIGID),
                   dict(asset=0, transform=SHEAR), dict(asset=1, visible=False)]),
    "mixed_degrees": ([(10, 200, 1), (11, 250, 3), (12, 100, 0)],
                      [dict(asset=0, transform=RIGID), dict(asset=1),
                       dict(asset=2, transform=NONUNIFORM), dict(asset=0)]),
}


def jax_scene(assets, instances):
    scene = ji.SplatScene()
    for d in assets:
        scene.add_asset(jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}))
    for kw in instances:
        kw = dict(kw)
        scene.add_instance(kw.pop("asset"), **kw)
    return scene


def both_scenes(assets, instances):
    return (jax_scene(assets, instances),
            interop.splat_scene_from_numpy(assets, instances, device="cpu"))


def is_general(inst) -> bool:
    try:
        ti.decompose_rigid_uniform(inst.get("transform", np.eye(4)))
    except ValueError:
        return True
    return False


def assert_flatten_close(pj, tj, pt, tt, instances):
    np.testing.assert_array_equal(np_(tt.instance_id), np.asarray(tj.instance_id))
    np.testing.assert_array_equal(np_(tt.local_id), np.asarray(tj.local_id))
    assert tt.instance_base.dtype == np.int64
    np.testing.assert_array_equal(tt.instance_base, tj.instance_base)
    assert tt.instance_id.dtype == tt.local_id.dtype == torch.int32
    live = [i for i in instances if i.get("visible", True)]
    for k, inst in enumerate(live):
        rows = slice(int(tt.instance_base[k]), int(tt.instance_base[k + 1]))
        fields = ("means", "color", "sh") if is_general(inst) else FIELDS
        for f in fields:
            assert_rows_close(np.asarray(getattr(pj, f))[rows], np_(getattr(pt, f))[rows])
        assert_cov_close(np.asarray(pj.cov3d)[rows], np_(pt.cov3d)[rows])


# ---- host math ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [RIGID, transform(rotation([0, 0, 1], np.pi)),
                               transform(2.5 * rotation([1, 1, 0], 2.0), (1, 2, 3)),
                               NONUNIFORM, SHEAR, REFLECT])
def test_decompose_rigid_uniform_is_bit_equal(m):
    try:
        want = ji.decompose_rigid_uniform(m)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(";")[0][:20]):
            ti.decompose_rigid_uniform(m)
        return
    got = ti.decompose_rigid_uniform(m)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_rotmat_to_quat_is_bit_equal():
    rng = np.random.default_rng(3)
    for i in range(40):
        r = rotation(rng.normal(size=3), rng.uniform(0, 2 * np.pi))
        if i % 4 == 0:
            r = rotation([1, 0, 0], np.pi - 1e-3 * i)  # trace < 0: the diagonal branches
        np.testing.assert_array_equal(ti.rotmat_to_quat(r), ji.rotmat_to_quat(r))
    rs = np.stack([rotation(rng.normal(size=3), rng.uniform(0, 2 * np.pi)) for _ in range(64)])
    np.testing.assert_array_equal(ti._rotmat_to_quat_batched(rs), ji._rotmat_to_quat_batched(rs))


def test_bake_general_transform_is_bit_equal():
    d = asset(20, 500, 0)
    for m in (NONUNIFORM, SHEAR, REFLECT):
        got = ti.bake_general_transform(m, d["means"], d["scales"], d["quats"])
        want = ji.bake_general_transform(m, d["means"], d["scales"], d["quats"])
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="singular"):
        ti.bake_general_transform(np.diag([1.0, 0.0, 1.0, 1.0]), d["means"], d["scales"],
                                  d["quats"])


def test_quat_multiply_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(200, 4)).astype(np.float32)
    b = rng.normal(size=(200, 4)).astype(np.float32)
    got = ti.quat_multiply(torch.from_numpy(a), torch.from_numpy(b))
    want = ji.quat_multiply(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0, atol=QUAT_ATOL)
    e = torch.tensor([[1.0, 0, 0, 0]])
    np.testing.assert_array_equal(np_(ti.quat_multiply(e, torch.from_numpy(a))), a)


# ---- the SH band rotation --------------------------------------------------------------

def random_rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_band_rotation_matches_jax(degree):
    for seed in range(3):
        r = random_rotation(seed)
        got, want = tsh.band_rotation(r, degree), jsh.band_rotation(r, degree)
        assert got.dtype == np.float64 and got.shape == (2 * degree + 1,) * 2
        np.testing.assert_allclose(got, want, rtol=0, atol=BAND_ATOL)
        # a rotation of the band: orthogonal
        np.testing.assert_allclose(got @ got.T, np.eye(2 * degree + 1), atol=1e-5)


def test_band_rotation_evaluates_the_basis_in_float32(monkeypatch):
    """The JAX package samples the basis on float32 directions (x64 off),
    then solves in float64; the port must too, or its matrices drift."""
    seen = []
    real = tsh.sh_basis

    def spy(dirs, degree):
        seen.append(dirs.dtype)
        return real(dirs, degree)

    monkeypatch.setattr(tsh, "sh_basis", spy)
    r = random_rotation(7)
    got = tsh.band_rotation(r, 3)
    assert seen == [torch.float32, torch.float32]
    np.testing.assert_allclose(got, jsh.band_rotation(r, 3), rtol=0, atol=BAND_ATOL)


def test_rotate_sh_rest_matches_jax_and_rotates_the_function():
    rng = np.random.default_rng(5)
    sh = (rng.normal(size=(400, 15, 3)) * 0.3).astype(np.float32)
    r = random_rotation(11)
    got = tsh.rotate_sh_rest(torch.from_numpy(sh), r)
    want = jsh.rotate_sh_rest(jnp.asarray(sh), r)
    assert got.dtype == torch.float32 and got.shape == sh.shape
    assert_rows_close(np.asarray(want), np_(got))
    # f'(R d) = f(d): the rotated coefficients at rotated directions
    d = rng.normal(size=(400, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rd = torch.as_tensor((d @ r.T).astype(np.float32))
    before = tsh.eval_sh_radiance(torch.from_numpy(sh), torch.as_tensor(d.astype(np.float32)), 3)
    after = tsh.eval_sh_radiance(got, rd, 3)
    np.testing.assert_allclose(np_(after), np_(before), rtol=0, atol=SH_EVAL_ATOL)
    # empty bands pass through; degree 2 rotates its two bands only
    empty = torch.zeros((5, 0, 3))
    assert tsh.rotate_sh_rest(empty, r) is empty
    assert_rows_close(np.asarray(jsh.rotate_sh_rest(jnp.asarray(sh[:, :8]), r)),
                      np_(tsh.rotate_sh_rest(torch.from_numpy(sh[:, :8]), r)))


# ---- flatten -------------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_flatten_matches_jax(name):
    specs, instances = CASES[name]
    assets = [asset(*s) for s in specs]
    sj, st = both_scenes(assets, instances)
    assert st.total_splats == sj.total_splats
    pj, tj = sj.flatten()
    pt, tt = st.flatten()
    assert pt.num_splats == pj.num_splats == st.total_splats
    assert pt.sh.shape == tuple(pj.sh.shape)
    assert_flatten_close(pj, tj, pt, tt, instances)
    if name == "opacity_gain":
        a = 1 / (1 + np.exp(-assets[0]["opacities"].astype(np.float64)))
        want = np.clip(a * 0.6, 1e-6, 1 - 1e-6)
        np.testing.assert_allclose(np_(pt.color[:, 3]), want, rtol=0, atol=1e-6)
    if name == "mixed_degrees":
        # the SH degree 0 instance is zero-padded to 15 coefficients
        lo, hi = int(tt.instance_base[2]), int(tt.instance_base[3])
        assert pt.sh.shape[1] == 15 and bool((pt.sh[lo:hi] == 0).all())


def test_flatten_without_visible_instance_raises():
    d = asset(30, 50, 1)
    for instances in ([], [dict(asset=0, visible=False)]):
        sj, st = both_scenes([d], instances)
        with pytest.raises(ValueError, match="no visible instances"):
            sj.flatten()
        with pytest.raises(ValueError, match="no visible instances"):
            st.flatten()


def test_rigid_rotation_is_decided_on_the_float32_matrix(monkeypatch):
    """Whether the SH bands rotate is decided by np.allclose(R, I, atol=1e-7)
    on R formed in float32 from the instance's quaternion. At a 1e-7 rad
    turn the float64 matrix passes that test and the float32 one does not:
    both packages rotate."""
    import vk_gaussian_splatting_tpu.ops.sh as jsh_mod

    calls = {"jax": 0, "port": 0}

    def spy(pkg, real):
        def f(*a):
            calls[pkg] += 1
            return real(*a)
        return f

    monkeypatch.setattr(jsh_mod, "rotate_sh_rest", spy("jax", jsh_mod.rotate_sh_rest))
    monkeypatch.setattr(ti, "rotate_sh_rest", spy("port", ti.rotate_sh_rest))
    d = asset(31, 40, 3)
    for angle, rotates in ((1e-7, True), (5e-8, False), (1e-3, True)):
        m = transform(rotation([0, 0, 1], angle))
        assert np.allclose(m[:3, :3], np.eye(3), atol=1e-7) == (angle < 1e-3)
        _, q, _ = ti.decompose_rigid_uniform(m)
        r32 = quat_to_rotmat(torch.as_tensor(np.asarray(q, np.float32))[None])[0].numpy()
        assert np.allclose(r32.astype(np.float64), np.eye(3), atol=1e-7) == (not rotates)
        calls.update(jax=0, port=0)
        sj, st = both_scenes([d], [dict(asset=0, transform=m)])
        pj, tj = sj.flatten()
        pt, tt = st.flatten()
        assert calls == {"jax": int(rotates), "port": int(rotates)}, (angle, calls)
        assert_flatten_close(pj, tj, pt, tt, [dict(asset=0, transform=m)])


def test_general_bake_is_held_by_covariance():
    """Isotropic splats through a reflection: the transformed covariance has
    one triple eigenvalue, so any frame factorizes it and the baked quats
    are arbitrary; the covariance (and the frame) is what must agree."""
    d = asset(32, 64, 1)
    d["scales"][:] = d["scales"][:, :1]
    m = transform(np.diag([-1.3, 1.3, 1.3]), (0.5, 0.0, 0.0))
    sj, st = both_scenes([d], [dict(asset=0, transform=m)])
    (pj, tj), (pt, tt) = sj.flatten(), st.flatten()
    assert_flatten_close(pj, tj, pt, tt, [dict(asset=0, transform=m)])
    # the covariance is A Sigma A^T of float64
    r = quat_to_rotmat(torch.from_numpy(d["quats"]).double()).numpy()
    mm = (m[:3, :3][None] @ r) * np.exp(d["scales"].astype(np.float64))[:, None, :]
    cov = mm @ np.swapaxes(mm, 1, 2)
    want = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    assert_cov_close(want, np_(pt.cov3d))
    # the same rotation as -q bakes to the same covariance
    d2 = dict(d, quats=-d["quats"])
    p2, _ = interop.splat_scene_from_numpy([d2], [dict(asset=0, transform=m)], "cpu").flatten()
    assert_cov_close(np_(pt.cov3d), np_(p2.cov3d))


def test_identity_instance_matches_single():
    d = asset(33, 200, 1)
    scene = interop.splat_scene_from_numpy([d], [dict(asset=0)], device="cpu")
    prepared, table = scene.flatten()
    single = interop.splat_set_from_numpy(d, "cpu").prepare()
    np.testing.assert_allclose(np_(prepared.means), np_(single.means), atol=1e-6)
    np.testing.assert_allclose(np_(prepared.cov3d), np_(single.cov3d), atol=1e-5)
    assert int(table.instance_base[-1]) == 200


def test_transformed_instance_renders_like_transformed_asset():
    """Baking the instance transform equals transforming the raw splats."""
    cfg = tc.RenderConfig(width=96, height=64, sh_degree=0)
    d = interop.random_splat_arrays(34, 200, sh_degree=0, scale_range=(-2.5, -1.0))
    c, s = np.cos(0.6), np.sin(0.6)
    m = transform(1.5 * np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]), (0.3, -0.2, 0.5))
    scene = interop.splat_scene_from_numpy([d], [dict(asset=0, transform=m)], device="cpu")
    prepared, _ = scene.flatten()
    cam = gt.look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height, device="cpu")
    img_inst = render_3dgs(prepared, cam, cfg, max_pairs=65536).image

    r = m[:3, :3] / 1.5
    splats = interop.splat_set_from_numpy(d, "cpu")
    qt = torch.as_tensor(ti.rotmat_to_quat(r), dtype=torch.float32)
    qn = splats.quats / torch.linalg.norm(splats.quats, dim=-1, keepdim=True)
    manual = dataclasses.replace(
        splats, means=torch.as_tensor(((d["means"] @ r.T) * 1.5 + m[:3, 3]).astype(np.float32)),
        quats=ti.quat_multiply(qt[None], qn), scales=splats.scales + float(np.log(1.5)))
    img_manual = render_3dgs(manual.prepare(), cam, cfg, max_pairs=65536).image
    np.testing.assert_allclose(np_(img_inst), np_(img_manual), atol=1e-4)
    assert float(img_inst.sum()) > 0


def test_scene_edits_and_numpy_round_trip():
    assets = [asset(35, 30, 1), asset(36, 20, 3)]
    instances = [dict(asset=0), dict(asset=1, transform=RIGID, opacity_gain=0.5, name="b"),
                 dict(asset=0, visible=False)]
    scene = interop.splat_scene_from_numpy(assets, instances, device="cpu")
    assert scene.total_splats == 50 and scene.asset_names == ["asset 0", "asset 1"]
    a2, i2 = interop.splat_scene_to_numpy(scene)
    for x, y in zip(a2, assets):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])
    assert [i["name"] for i in i2] == ["", "b", ""] and i2[1]["opacity_gain"] == 0.5
    np.testing.assert_array_equal(i2[1]["transform"], RIGID)
    assert scene.add_instance(1, splat_scale=2.0) == 3
    assert scene.total_splats == 70
    scene.remove_instance(0)
    assert scene.total_splats == 40 and len(scene.instances) == 3


# ---- frames of the flattened scene ----------------------------------------------------

FRAME_INSTANCES = [dict(asset=0),
                   dict(asset=0, transform=transform(
                       0.8 * rotation([1.0, 2.0, 0.5], np.radians(35.0)), (2.5, -0.5, 1.0))),
                   dict(asset=1, transform=transform(
                       np.array([[1.4, 0.25, 0.0], [0.0, 0.7, 0.0], [0.0, 0.0, 1.0]]),
                       (-2.6, 0.8, 0.5))),
                   dict(asset=1, transform=transform(rotation([0, 1, 0], 0.9), (0.2, 2.2, 1.5)),
                        opacity_gain=0.6, splat_scale=1.25),
                   dict(asset=0, visible=False)]


@pytest.fixture(scope="module")
def frame_scene():
    assets = [interop.random_splat_arrays(40, 500, sh_degree=3, extent=1.5,
                                          scale_range=(-3.5, -1.8)),
              interop.random_splat_arrays(41, 400, sh_degree=1, extent=1.5,
                                          scale_range=(-3.5, -1.8))]
    sj, st = both_scenes(assets, FRAME_INSTANCES)
    cam_t = gt.look_at([0.3, -0.4, -11.0], [0, 0.3, 0.5], [0, 1, 0], W, H, fov_y_rad=0.9,
                       device="cpu")
    return sj.flatten(), st.flatten(), jcam.make_camera(**interop.camera_to_numpy(cam_t)), cam_t


def assert_frames_close(oj, ot, atol=IMG_ATOL):
    assert bool(oj.overflow) == bool(ot.overflow)
    assert int(oj.num_pairs) == int(ot.num_pairs)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(np_(a) - np.asarray(b))
        assert (diff <= atol).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    id_j, id_t = np.asarray(oj.splat_id), np_(ot.splat_id)
    same = id_j == id_t
    assert same.mean() >= ID_AGREE, same.mean()
    both = same & (id_j >= 0)
    np.testing.assert_allclose(np_(ot.depth)[both], np.asarray(oj.depth)[both], rtol=0,
                               atol=DEPTH_ATOL)
    return both


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_instanced_frame_matches_jax(frame_scene, method):
    ((pj, tj), (pt, tt), cam_j, cam_t) = frame_scene
    raster = {}
    if method == "bucket":  # caps fitted to this frame (bench.py:164-183)
        spec = BucketGridSpec.build(W // 16, H // 16)
        req = measure_required_caps(project_splats(pt, cam_t, tc.RenderConfig(
            width=W, height=H, sh_degree=3)), spec)
        raster = dict(method="bucket", bucket_caps=fit_caps([int(x) for x in req]))
    cj = jc.RenderConfig(width=W, height=H, sh_degree=3, raster=jc.RasterConfig(**raster))
    ct = tc.RenderConfig(width=W, height=H, sh_degree=3, raster=tc.RasterConfig(**raster))
    oj = j_render(pj, cam_j, cj, max_pairs=0)
    ot = render_3dgs(pt, cam_t, ct, max_pairs=0)
    assert not bool(ot.overflow)
    both = assert_frames_close(oj, ot)
    # every visible instance shows in the frame
    inst = np_(tt.instance_id)[np_(ot.splat_id)[both]]
    assert set(np.unique(inst).tolist()) == set(range(len(tt.instance_base) - 1))


MATERIALS = (dict(diffuse=(0.9, 0.8, 0.7), specular=(0.4, 0.4, 0.4), shininess=16.0),
             dict(diffuse=(0.3, 0.6, 0.9), ambient=(0.2, 0.15, 0.1), shininess=3.0),
             dict(diffuse=(0.8, 0.3, 0.3), emission=(0.05, 0.0, 0.02)),
             dict(diffuse=(0.4, 0.9, 0.4), specular=(0.8, 0.7, 0.6), shininess=40.0))


def test_lit_frame_with_instance_materials_matches_jax(frame_scene):
    ((pj, tj), (pt, tt), cam_j, cam_t) = frame_scene
    point = dict(position=(2.0, -3.0, -6.0), intensity=1.5)
    spot = dict(position=(-3.0, -2.0, -8.0), direction=(0.3, 0.2, 1.0), color=(1.0, 0.8, 0.6),
                inner_cone_deg=10.0, outer_cone_deg=25.0)
    lj = (jl.make_light(jl.LightType.POINT, **point), jl.make_light(jl.LightType.SPOT, **spot))
    lt = (tl.make_light(tl.LightType.POINT, **point, device="cpu"),
          tl.make_light(tl.LightType.SPOT, **spot, device="cpu"))
    mj = tuple(jd.DeferredMaterial(**m) for m in MATERIALS)
    mt = tuple(td.DeferredMaterial(**m) for m in MATERIALS)
    assert len(tt.instance_base) - 1 == len(MATERIALS)
    cj = jc.RenderConfig(width=W, height=H, sh_degree=3)
    ct = tc.RenderConfig(width=W, height=H, sh_degree=3)
    oj, sj, _ = j_lit(pj, cam_j, cj, 0, lights=lj, material=mj,
                      instance_base=tuple(int(b) for b in tj.instance_base))
    ot, st_, _ = render_3dgs_lit(pt, cam_t, ct, 0, lights=lt, material=mt,
                                 instance_base=tt.instance_base)
    both = assert_frames_close(oj, ot, atol=5e-5)
    diff = np.abs(np_(st_) - np.asarray(sj))
    assert (diff <= LIT_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    # the material index is the table's instance of each picked splat
    sets = np_(td.instance_index_image(ot.splat_id, tt.instance_base))
    np.testing.assert_array_equal(sets[both], np_(tt.instance_id)[np_(ot.splat_id)[both]])
    assert len(np.unique(sets[both])) == len(MATERIALS)
