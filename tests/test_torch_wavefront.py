"""Wavefront secondary bounces of the PyTorch port (render/wavefront.py,
``render_composed_wavefront``) on the CPU against the JAX package's, on the
setups of tests/test_raytrace.py, from one numpy input.

Gates, each with its reason:
- ``secondary_spawn`` fed the same face ids and transmittance: mask and
  shape equal; origins, directions and throughput within 1e-5 of 1 or of
  their size (the rays of ``build_tile_rays`` agree to 1e-6; the plane
  intersection divides by d.n, so a grazing hit 170 units away moves by
  1e-4, 6e-7 of itself);
- ``trace_secondary`` radiance: the tracer's gate (tests/test_torch_
  raytrace.py): within 1e-4 on >= 99.9 % of rays, every ray within 1.2e-2;
- ``add_secondary_radiance``: equal (a nearest-neighbour copy, then one add);
- ``render_composed_wavefront``: the composed frame at the gs2d gates of
  tests/test_torch_mesh.py (within 5e-5 on >= 99.9 % of values, none beyond
  1.2e-2), the final image within 1e-4 on >= 99.9 % of pixels and none
  beyond 1.2e-2;
- a coloured (per-channel) shadow function in the bounce shading raises in
  both packages.

JAX programs built here: two composed wavefront frames (interpret-mode
Pallas for the mesh and splat passes) and a few small traces (about 40 s
alone).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.io.obj import ObjMaterial as JObjMaterial
from vk_gaussian_splatting_tpu.io.obj import ObjMesh as JObjMesh
from vk_gaussian_splatting_tpu.render import mesh_raster as jmr
from vk_gaussian_splatting_tpu.render import wavefront as jw
from vk_gaussian_splatting_tpu.render.pipelines import (
    render_composed_wavefront as j_wavefront,
)
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.io.obj import ObjMaterial, ObjMesh
from vk_gaussian_splatting_tpu_torch.render import (
    mesh_buffers_from_obj,
    render_composed_wavefront,
    render_mesh,
)
from vk_gaussian_splatting_tpu_torch.render import wavefront as tw

torch.set_num_threads(2)

SPAWN_ATOL = 1e-5
ATOL, AGREE, MAX_FLIP = 1e-4, 0.999, 1.2e-2
IMG_ATOL = 5e-5

MIRROR = dict(name="mirror", diffuse=(0.05, 0.05, 0.05), specular=(0.9, 0.9, 0.9), illum=1)
GLASS = dict(name="glass", diffuse=(0.02, 0.02, 0.02), specular=(0.1, 0.1, 0.1),
             transmittance=(0.9, 0.9, 0.9), ior=1.5, illum=2)
FULL_MIRROR = dict(name="m", diffuse=(0.0, 0.0, 0.0), specular=(1.0, 1.0, 1.0), illum=1)


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def both_prepared(d):
    pj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    return pj, interop.splat_set_from_numpy(d, "cpu").prepare()


def both_meshes(pos, nrm, idx, material):
    mats = np.zeros(len(idx), np.int32)
    mj = jmr.mesh_buffers_from_obj(JObjMesh(pos, nrm, idx, mats, [JObjMaterial(**material)]))
    mt = mesh_buffers_from_obj(ObjMesh(pos, nrm, idx, mats, [ObjMaterial(**material)]),
                               device="cpu")
    return mj, mt


def mirror_floor(material=MIRROR):
    """tests/test_raytrace.py's mirror floor at y = -2."""
    pos = np.float32([[-6, -2, -6], [6, -2, -6], [6, -2, 6], [-6, -2, 6]])
    nrm = np.tile(np.float32([[0, 1, 0]]), (4, 1))
    return both_meshes(pos, nrm, np.int32([[0, 1, 2], [0, 2, 3]]), material)


def glass_pane():
    """tests/test_raytrace.py:186's glass pane between camera and splats."""
    pos = np.float32([[-3, -3, -3], [3, -3, -3], [3, 3, -3], [-3, 3, -3]])
    nrm = np.tile(np.float32([[0, 0, -1]]), (4, 1))
    return both_meshes(pos, nrm, np.int32([[0, 1, 2], [0, 2, 3]]), GLASS)


def facing_mirrors():
    """tests/test_raytrace.py:230's floor at y = -2 and ceiling at y = 2."""
    pos = np.float32([[-6, -2, -6], [6, -2, -6], [6, -2, 6], [-6, -2, 6],
                      [-6, 2, -6], [6, 2, -6], [6, 2, 6], [-6, 2, 6]])
    nrm = np.concatenate([np.tile([[0, 1, 0]], (4, 1)),
                          np.tile([[0, -1, 0]], (4, 1))]).astype(np.float32)
    idx = np.int32([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]])
    return both_meshes(pos, nrm, idx, FULL_MIRROR)


def cams(eye, target, w, h):
    cam_t = gt.look_at(eye, target, [0, 1, 0], w, h, device="cpu")
    return jcam.make_camera(**interop.camera_to_numpy(cam_t)), cam_t


def cfgs(w, h, sh_degree):
    return (jc.RenderConfig(width=w, height=h, sh_degree=sh_degree),
            tc.RenderConfig(width=w, height=h, sh_degree=sh_degree))


def ray_gate(got, want, label):
    diff = np.abs(np_(got) - np.asarray(want))
    per = diff.reshape(-1, 3).max(axis=1)
    print(f"{label}: max {per.max():.3e}, {int((per > ATOL).sum())} of {len(per)} beyond {ATOL}")
    assert (per <= ATOL).mean() >= AGREE and per.max() <= MAX_FLIP, per.max()


def spawn_both(cj, ct, cam_j, cam_t, mj, mt, fid, trans, stride=1):
    sj = jw.secondary_spawn(cam_j, cj, mj, jnp.asarray(fid), jnp.asarray(trans), stride)
    st = tw.secondary_spawn(cam_t, ct, mt, torch.from_numpy(fid), torch.from_numpy(trans),
                            stride)
    np.testing.assert_array_equal(np_(st[3]), np.asarray(sj[3]))
    assert tuple(st[4]) == tuple(sj[4])
    for a, b in zip(st[:3], sj[:3]):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=SPAWN_ATOL, atol=SPAWN_ATOL)
    return sj, st


@pytest.mark.parametrize("case", ["mirror", "glass"])
def test_spawn_and_bounces_match_jax(case):
    """secondary_spawn and trace_secondary (three bounces) of both packages
    on the same face ids (the port's mesh pass) and a seeded splat
    transmittance: the mirror floor (tests/test_raytrace.py:129) and the
    glass pane (:186)."""
    w, h = (48, 32) if case == "mirror" else (32, 24)
    pj, pt = both_prepared(interop.random_splat_arrays(4, 300, sh_degree=1,
                                                       scale_range=(-3.0, -1.5)))
    cj, ct = cfgs(w, h, 1)
    if case == "mirror":
        mj, mt = mirror_floor()
        cam_j, cam_t = cams([0, 0.5, -7], [0, -0.8, 0], w, h)
    else:
        mj, mt = glass_pane()
        cam_j, cam_t = cams([0, 0, -7], [0, 0, 0], w, h)
    fid = np_(render_mesh(mt, cam_t, ct, 1 << 18)[3])
    trans = np.random.default_rng(1).uniform(0.3, 1.0, (h, w)).astype(np.float32)
    (oj, dj, thj, mask_j, _), (ot, dt, tht, mask_t, _) = spawn_both(
        cj, ct, cam_j, cam_t, mj, mt, fid, trans)
    assert bool(mask_t.any())
    rj = jw.trace_secondary(pj, cam_j, cj, mj, oj, dj, thj, max_bounces=3)
    rt = tw.trace_secondary(pt, cam_t, ct, mt, ot, dt, tht, max_bounces=3)
    ray_gate(rt, rj, case)
    assert float(rt.abs().max()) > 0.0


def test_one_mirror_bounce_is_the_splat_trace():
    """tests/test_raytrace.py:129: one bounce off the mirror floor equals
    the throughput times the splat trace along the reflected rays (they
    leave the floor upward: no second mesh hit, and the hit shading adds
    nothing where no face is hit)."""
    w, h = 48, 32
    _, pt = both_prepared(interop.random_splat_arrays(4, 300, sh_degree=1))
    _, ct = cfgs(w, h, 1)
    _, mt = mirror_floor()
    _, cam_t = cams([0, 0.5, -7], [0, -0.8, 0], w, h)
    fid = render_mesh(mt, cam_t, ct, 1 << 18)[3]
    o, d, thr, mask, _ = tw.secondary_spawn(cam_t, ct, mt, fid, torch.ones((h, w)))
    assert bool(mask.any())
    rad = tw.trace_secondary(pt, cam_t, ct, mt, o, d, thr, max_bounces=1)
    res = gt.render.pipelines.trace_splats(pt, o, d, torch.full(o.shape[:1], 1e-3),
                                           torch.full(o.shape[:1], float("inf")), ct)
    np.testing.assert_allclose(rad.numpy(), (thr * res.radiance).numpy(), atol=1e-5)
    assert float(rad.abs().max()) > 0.0


def test_double_bounce_between_facing_mirrors_matches_jax():
    """tests/test_raytrace.py:230: rays fired down between two facing
    mirrors; one and three bounces against JAX, and the extra bounces add
    radiance."""
    pj, pt = both_prepared(interop.random_splat_arrays(8, 150, sh_degree=0))
    cj, ct = cfgs(8, 8, 0)
    mj, mt = facing_mirrors()
    cam_j, cam_t = cams([0, 0, -7], [0, 0, 0], 8, 8)
    r = 16
    o = np.tile(np.float32([[0.5, 1.0, 0.0]]), (r, 1))
    d = np.tile(np.float32([[0.05, -1.0, 0.02]]), (r, 1))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[::2, 0] *= -1.0  # two directions, so the batch is not one ray
    thr = np.ones((r, 3), np.float32)
    out = {}
    for bounces in (1, 3):
        rj = jw.trace_secondary(pj, cam_j, cj, mj, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(thr), max_bounces=bounces)
        rt = tw.trace_secondary(pt, cam_t, ct, mt, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(thr), max_bounces=bounces)
        ray_gate(rt, rj, f"{bounces} bounces")
        out[bounces] = rt
    assert torch.isfinite(out[3]).all()
    assert float(out[3].sum()) > float(out[1].sum()) + 1e-4


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_add_secondary_radiance_matches_jax(stride):
    """The nearest-neighbour upsample with half-pixel centres on 17x23, a
    size no stride above 1 divides (the JAX ``jax.image.resize``)."""
    h, w = 17, 23
    h_lr, w_lr = -(-h // stride), -(-w // stride)
    rng = np.random.default_rng(stride)
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    rad = rng.uniform(size=(h_lr * w_lr, 3)).astype(np.float32)
    cj, ct = cfgs(w, h, 0)
    got = tw.add_secondary_radiance(torch.from_numpy(img), torch.from_numpy(rad), (h_lr, w_lr), ct)
    want = jw.add_secondary_radiance(jnp.asarray(img), jnp.asarray(rad), (h_lr, w_lr), cj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_coloured_shadow_fn_raises_in_both_packages():
    """The bounce shading multiplies a scalar shadow transmittance per
    point; a per-channel (R, 3) one does not broadcast in the JAX package
    (ROADMAP.md queue 3), and the port raises ValueError naming it."""
    pj, pt = both_prepared(interop.random_splat_arrays(8, 20, sh_degree=0))
    cj, ct = cfgs(8, 8, 0)
    mj, mt = facing_mirrors()
    cam_j, cam_t = cams([0, 0, -7], [0, 0, 0], 8, 8)
    r = 5
    o = np.tile(np.float32([[0.5, 1.0, 0.0]]), (r, 1))
    d = np.tile(np.float32([[0.0, -1.0, 0.0]]), (r, 1))
    thr = np.ones((r, 3), np.float32)
    with pytest.raises((TypeError, ValueError), match="[Ii]ncompatible shapes"):
        jw.trace_secondary(pj, cam_j, cj, mj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(thr),
                           shadow_fn=lambda p, light: jnp.ones(p.shape), max_bounces=1)
    with pytest.raises(ValueError, match="per-channel"):
        tw.trace_secondary(pt, cam_t, ct, mt, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(thr), shadow_fn=lambda p, light: torch.ones(p.shape),
                           max_bounces=1)
    # a scalar one shades
    rad = tw.trace_secondary(pt, cam_t, ct, mt, torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(thr),
                             shadow_fn=lambda p, light: torch.full(p.shape[:1], 0.5),
                             max_bounces=1)
    assert torch.isfinite(rad).all()


@pytest.mark.parametrize("case", ["mirror", "glass"])
def test_render_composed_wavefront_matches_jax(case):
    """tests/test_raytrace.py:165 (a mirror floor, two bounces, stride 2)
    and :186 (a glass pane, three bounces): the composed frame and the
    image with the bounces against JAX; the bounces add light, on the mirror
    only part of the frame."""
    if case == "mirror":
        w, h, sh, bounces, stride = 48, 32, 1, 2, 2
        d = interop.random_splat_arrays(0, 300, sh_degree=1, extent=1.5)
        mj, mt = mirror_floor()
        cam_j, cam_t = cams([0, 0.5, -7], [0, -0.8, 0], w, h)
    else:
        w, h, sh, bounces, stride = 32, 24, 0, 3, 1
        d = interop.random_splat_arrays(1, 200, sh_degree=0)
        mj, mt = glass_pane()
        cam_j, cam_t = cams([0, 0, -7], [0, 0, 0], w, h)
    pj, pt = both_prepared(d)
    cj, ct = cfgs(w, h, sh)
    oj, fj = j_wavefront(pj, cam_j, cj, mesh=mj, max_bounces=bounces, stride=stride,
                         interpret=True)
    ot, ft = render_composed_wavefront(pt, cam_t, ct, mesh=mt, max_bounces=bounces,
                                       stride=stride)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(np_(a) - np.asarray(b))
        assert (diff <= IMG_ATOL).mean() >= AGREE and diff.max() <= MAX_FLIP, diff.max()
    ray_gate(ft, fj, case)
    added = (np_(ft) - np_(ot.image)).max(axis=-1)
    assert np.isfinite(np_(ft)).all() and added.max() > 1e-3
    if case == "mirror":
        assert (added > 1e-3).mean() < 0.6
