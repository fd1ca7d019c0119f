"""Meshes on the raster path, on the CPU: the port against the JAX package.

``render_mesh`` (the tri2d and tri2d_smooth response models), the
mesh-composited 3DGS frame ``render_3dgs_composed`` (the gs2d_clip splat
pass), the lights and the OBJ loader they need, and the binning's
``classes=False`` form, each through both packages on one numpy input. The
JAX kernels run in interpret mode, as tests/test_mesh.py runs them.

Tolerances:
- lights: 1e-6 of each value's size (float32 operations in the same order;
  the norms may sum in another order).
- OBJ: every field equal (both loaders are the same numpy code).
- binning without classes: per tile the same multiset of source faces, and
  the same pair count and overflow (the keys sort alike).
- ``render_mesh``: coverage (T < 0.5) on >= 99.9 % of pixels (XLA on the
  CPU contracts the edge functions' a*b - c*d into FMAs, so a pixel within
  rounding of an edge may flip); where both cover with the same face, the
  image within 2e-5 and the depth within 1e-5 of itself; face ids equal
  where both cover except at ties (two faces at one depth, whose order the
  sort alone decides; counted), and at most 0.1 % of those pixels
  otherwise; the port's T exactly 0 or 1. Measured: coverage and ids 100 %,
  image 4.0e-7, depth 3.8e-7 relative.
- ``render_3dgs_composed``: the gs2d gates of tests/test_torch_render.py
  (image and T within 5e-5 on >= 99.9 % of values, none beyond 1.2e-2;
  ids on >= 99.9 % of pixels, the depth within 1e-5 where the ids agree,
  plus 1e-5 of itself where that is the mesh's).
  With no mesh in view the frame equals the port's own 3DGS frame bit for
  bit (the limit is 0 everywhere, so gs2d_clip's alphas are gs2d's).
- gradients against ``jax.grad``: 2e-5 of each field's max (the gs2d
  gradient gate); tri2d's vertex rows exactly 0.
- culls: the triangle reach keeps every (warp, pair) and every (tile,
  pair) whose coverage passes at some pixel, slivers and degenerate
  triangles included.

JAX programs built here: two mesh frames, one composed frame (two scenes),
two gradients (about 50 s alone).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.io.obj import ObjMaterial as JObjMaterial
from vk_gaussian_splatting_tpu.io.obj import ObjMesh as JObjMesh
from vk_gaussian_splatting_tpu.io.obj import load_obj as j_load_obj
from vk_gaussian_splatting_tpu.ops import binning as jbin
from vk_gaussian_splatting_tpu.render import mesh_raster as jmr
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs_composed as j_composed
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import lights as jl
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.io import load_obj
from vk_gaussian_splatting_tpu_torch.io.obj import ObjMaterial, ObjMesh
from vk_gaussian_splatting_tpu_torch.io.obj import octa_sphere as obj_sphere
from vk_gaussian_splatting_tpu_torch.ops import rasterize as tr
from vk_gaussian_splatting_tpu_torch.ops import response as tresp
from vk_gaussian_splatting_tpu_torch.ops.binning import bin_splats
from vk_gaussian_splatting_tpu_torch.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu_torch.render import (
    mesh_buffers_from_obj,
    render_3dgs,
    render_3dgs_composed,
    render_mesh,
)
from vk_gaussian_splatting_tpu_torch.render import mesh_raster as tmr
from vk_gaussian_splatting_tpu_torch.scene import lights as tl

torch.set_num_threads(2)

LIGHT_RTOL = 1e-6
COVER_AGREE = 0.999
MESH_IMG_ATOL, MESH_DEPTH_RTOL = 2e-5, 1e-5
IMG_ATOL, IMG_SHARE, IMG_MAX = 5e-5, 0.999, 1.2e-2
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999
GRAD_RTOL = 2e-5
W, H = 96, 64


# ---- shared inputs -------------------------------------------------------------

def octa_sphere(subdiv=2, radius=2.0):
    """tests/test_mesh.py's octahedron-subdivision sphere (io.obj.octa_sphere)."""
    m = obj_sphere(subdiv, radius)
    return m.positions, m.normals, m.indices, (0.9, 0.9, 0.9)


def quad(z=0.0, half=2.0, color=(1.0, 0.2, 0.2)):
    """tests/test_mesh.py's quad facing the camera (two faces, one depth)."""
    pos = np.asarray([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                     np.float32)
    nrm = np.tile([0, 0, -1.0], (4, 1)).astype(np.float32)
    return pos, nrm, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), color


def meshes(spec):
    """The same mesh in both packages: (JAX MeshBuffers, port MeshBuffers)."""
    pos, nrm, idx, color = spec
    mats = np.zeros(idx.shape[0], np.int32)
    mj = jmr.mesh_buffers_from_obj(JObjMesh(pos, nrm, idx, mats, [JObjMaterial(diffuse=color)]))
    mt = mesh_buffers_from_obj(ObjMesh(pos, nrm, idx, mats, [ObjMaterial(diffuse=color)]),
                               device="cpu")
    return mj, mt


def cameras(eye, w=W, h=H, fov=0.8):
    cam_t = gt.look_at(eye, [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=fov, device="cpu")
    return jcam.make_camera(**interop.camera_to_numpy(cam_t)), cam_t


def cfgs(shading="smooth", w=W, h=H, sh_degree=1):
    return (jc.RenderConfig(width=w, height=h, sh_degree=sh_degree,
                            raster=jc.RasterConfig(mesh_shading=shading)),
            tc.RenderConfig(width=w, height=h, sh_degree=sh_degree,
                            raster=tc.RasterConfig(mesh_shading=shading)))


# ---- lights ------------------------------------------------------------------------

def light_pair(light_type, mode, rng):
    kw = dict(position=rng.normal(size=3) * 2.0, direction=rng.normal(size=3),
              color=rng.uniform(0.2, 1.0, 3), intensity=1.7, range=3.5,
              inner_cone_deg=25.0, outer_cone_deg=50.0)
    return (jl.make_light(jl.LightType(light_type), attenuation=jl.AttenuationMode(mode), **kw),
            tl.make_light(tl.LightType(light_type), attenuation=tl.AttenuationMode(mode),
                          device="cpu", **kw))


def close(a, b, rtol=LIGHT_RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert (np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1.0)).all(), np.abs(a - b).max()


@pytest.mark.parametrize("mode", list(tl.AttenuationMode))
@pytest.mark.parametrize("light_type", list(tl.LightType))
def test_compute_light_matches_jax(light_type, mode):
    rng = np.random.default_rng(10 * int(light_type) + int(mode))
    lj, lt = light_pair(light_type, mode, rng)
    pos = rng.normal(size=(400, 3)).astype(np.float32) * 3.0
    nrm = rng.normal(size=(400, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    got = tl.compute_light(lt, torch.from_numpy(pos), torch.from_numpy(nrm)).numpy()
    want = jl.compute_light(lj, jnp.asarray(pos), jnp.asarray(nrm))
    close(got, want)
    assert (got > 0).any() or light_type == tl.LightType.SPOT


def test_specular_and_direction_match_jax():
    rng = np.random.default_rng(5)
    v, ld, n = (rng.normal(size=(300, 3)).astype(np.float32) for _ in range(3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    spec = np.asarray([0.5, 0.7, 0.9], np.float32)
    for shininess in (2.0, 16.0):
        got = tl.compute_specular(torch.from_numpy(spec), shininess, *map(torch.from_numpy,
                                                                           (v, ld, n)))
        close(got.numpy(), jl.compute_specular(jnp.asarray(spec), shininess, jnp.asarray(v),
                                               jnp.asarray(ld), jnp.asarray(n)))
    for light_type in tl.LightType:
        lj, lt = light_pair(light_type, 0, rng)
        pos = rng.normal(size=(50, 3)).astype(np.float32)
        dt, st = tl.light_direction_to(lt, torch.from_numpy(pos))
        dj, sj = jl.light_direction_to(lj, jnp.asarray(pos))
        close(dt.numpy(), dj)
        close(st.numpy(), sj)
    head = tl.headlight(torch.tensor([0.5, -1.0, 2.0]))
    assert int(head.type) == tl.LightType.POINT and head.position.tolist() == [0.5, -1.0, 2.0]


# ---- OBJ ------------------------------------------------------------------------------

OBJ = """# a cube corner and a quad, two materials, some normals missing
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vn 0 0 -1
usemtl red
f 1//1 2//1 3//1 4//1
usemtl glass
f 1 5 2
f 2/7/1 5 3
usemtl unknown
f 3 5 4
"""
MTL = """newmtl red
Kd 0.8 0.1 0.1
Ka 0.2 0.2 0.2
Ks 0.5 0.5 0.5
Ns 32
newmtl glass
Kd 0.1 0.1 0.1
Ke 0.0 0.1 0.0
Tf 0.9 0.9 0.95
Ni 1.5
d 0.4
illum 4
"""


def test_load_obj_matches_jax(tmp_path):
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "scene.mtl").write_text(MTL)
    got, want = load_obj(str(tmp_path / "scene.obj")), j_load_obj(str(tmp_path / "scene.obj"))
    for f in ("positions", "normals", "indices", "mat_indices"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert [dataclasses.asdict(m) for m in got.materials] == [
        dataclasses.asdict(m) for m in want.materials]
    assert got.indices.shape == (5, 3) and len(got.materials) == 3
    mt = mesh_buffers_from_obj(got, transform=np.diag([2.0, 1.0, 1.0, 1.0]), device="cpu")
    mj = jmr.mesh_buffers_from_obj(want, transform=np.diag([2.0, 1.0, 1.0, 1.0]))
    for f in dataclasses.fields(mt):
        a, b = getattr(mt, f.name).numpy(), np.asarray(getattr(mj, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


# ---- binning without the rank ladder ---------------------------------------------

def test_bin_without_classes_matches_jax():
    mj, _ = meshes(octa_sphere(2))
    cam_j, _ = cameras([0.3, -0.5, -4.5])
    cj, _ = cfgs()
    proj_j = jmr._project_triangles(mj, cam_j, cj, ())[0]
    n = proj_j.xy.shape[0]
    kw = dict(tile_size=16, tiles_x=6, tiles_y=4, slots_k=64)
    bj = jbin.bin_splats(proj_j, jnp.arange(n, dtype=jnp.float32)[None], classes=False, **kw)
    proj_t = ProjectedSplats(**{f.name: torch.from_numpy(np.array(getattr(proj_j, f.name)))
                                for f in dataclasses.fields(ProjectedSplats)})
    bt = bin_splats(proj_t, torch.zeros((1, n)), torch.arange(n, dtype=torch.int32),
                    classes=False, **kw)
    assert int(bt.num_pairs) == int(bj.num_pairs) > n
    assert bool(bt.overflow) == bool(bj.overflow)
    src_j = np.asarray(bj.attrs[0]).astype(np.int32)  # the source face, carried as a row
    starts, counts = np.asarray(bj.seg_starts), np.asarray(bj.seg_counts)
    assert np.array_equal(bt.tile_count.numpy(), counts)
    for t in range(counts.size):
        a = np.sort(bt.pair_id[int(bt.tile_start[t]):][:counts[t]].numpy())
        assert np.array_equal(a, np.sort(src_j[starts[t]:starts[t] + counts[t]])), t


# ---- render_mesh --------------------------------------------------------------------

MESH_FRAMES = {"sphere_smooth": ("sphere", "smooth"), "sphere_flat": ("sphere", "flat"),
               "quad_flat": ("quad", "flat")}


@pytest.fixture(scope="module", params=list(MESH_FRAMES))
def mesh_frames(request):
    shape, shading = MESH_FRAMES[request.param]
    mj, mt = meshes(octa_sphere(2) if shape == "sphere" else quad())
    cam_j, cam_t = cameras([0.3, -0.5, -7.0] if shape == "sphere" else [0, 0, -10])
    cj, ct = cfgs(shading)
    oj = [np.asarray(a) for a in jmr.render_mesh(mj, cam_j, cj, 16384)]
    ot = [a.numpy() for a in render_mesh(mt, cam_t, ct, 16384)]
    return shape, shading, oj, ot


def assert_mesh_frames_match(oj, ot):
    img_j, t_j, d_j, id_j = oj
    img_t, t_t, d_t, id_t = ot
    assert id_t.dtype == np.int32 and np.isfinite(img_t).all()
    assert ((t_t == 0) | (t_t == 1)).all()                       # opaque, unclamped
    cov_j, cov_t = t_j < 0.5, t_t < 0.5
    assert (cov_j == cov_t).mean() >= COVER_AGREE, (cov_j != cov_t).sum()
    both = cov_j & cov_t
    same = both & (id_j == id_t)
    ties = both & (id_j != id_t) & (d_j == d_t)
    assert (both & ~same & ~ties).sum() <= (1 - ID_AGREE) * both.sum()
    assert np.abs(img_t - img_j)[same].max() <= MESH_IMG_ATOL
    assert (np.abs(d_t - d_j) <= MESH_DEPTH_RTOL * np.abs(d_j))[same].all()
    none = ~cov_t
    assert (id_t[none] == -1).all() and (d_t[none] == 0).all()
    return int(ties.sum())


def test_render_mesh_matches_jax(mesh_frames):
    shape, shading, oj, ot = mesh_frames
    ties = assert_mesh_frames_match(oj, ot)
    covered = ot[1] < 0.5
    assert 0.1 < covered.mean() < 0.6
    depth = ot[2][covered]
    if shape == "quad":  # two faces at one depth, which the sort orders alone
        assert (depth == 10.0).all() and set(np.unique(ot[3][covered])) == {0, 1}
        print(f"quad: {ties} pixels where the packages picked the other face of a tie")
    elif shading == "smooth":  # interpolated: many levels; flat: one per face
        assert np.unique(np.round(depth, 4)).size > 200
    if shape == "sphere":
        assert 5.0 < depth.min() and depth.max() < 7.7


NEAR_EYES = {"inside": ([0.0, 0.0, 0.3], [0.0, 0.0, 5.0]),   # in the sphere, looking out
             "surface": ([0.0, 0.0, -2.005], [0.0, 0.0, 0.0]),  # on it: faces at the near plane
             "ground": ([0.5, -2.49, -6.0], [0.0, -2.49, 0.0])}  # grazing the ground


def bins_in_range(bins, faces):
    """The index invariants the kernels and the gathers rely on."""
    p = bins.attrs.shape[1]
    start, count = bins.tile_start.long(), bins.tile_count.long()
    assert (count >= 0).all() and (start >= 0).all() and (start + count <= p).all()
    assert (start[1:] >= start[:-1]).all() and int(bins.num_pairs) == int(count.sum())
    live = bins.pair_id[:int(bins.num_pairs)]
    assert bool(((live >= 0) & (live < faces)).all())
    assert bool(torch.isfinite(bins.attrs[:6, :int(bins.num_pairs)]).all())


@pytest.mark.parametrize("eye", list(NEAR_EYES))
def test_near_plane_faces_bin_in_range(eye):
    """Faces that cross the camera plane or lie just past the near plane
    project to huge or non-finite box centres: their tile casts and every
    gather stay in range (on the CPU an index out of range raises), the
    frame is finite and opaque, and an index past the vertices raises."""
    sphere = obj_sphere(2, 2.0)
    e = NEAR_EYES["surface"][0][2]
    extra = np.array([[-20, -2.5, -20], [20, -2.5, -20], [20, -2.5, 40], [-20, -2.5, 40],
                      # just past the near plane, 2e5 px across
                      [-50, 0, e + 0.0101], [50, 0, e + 0.0101], [0, 50, e + 0.0101],
                      [-1, 0, e], [1, 0, e], [0, 1, e + 1],            # on the camera plane
                      [-1, 0, e - 1], [1, 0, e + 1], [0, 1, e + 1],    # through it
                      [0, 0, np.nan], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.concatenate([sphere.indices,
                            np.int32([[0, 1, 2], [0, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12],
                                      [13, 14, 15]]) + 66])
    n = faces.shape[0]
    obj = ObjMesh(np.concatenate([sphere.positions, extra]),
                  np.concatenate([sphere.normals, np.tile(np.float32([0, 1, 0]), (16, 1))]),
                  faces, np.zeros(n, np.int32), [ObjMaterial()])
    mt = mesh_buffers_from_obj(obj, device="cpu")
    pos, look = NEAR_EYES[eye]
    cam = gt.look_at(pos, look, [0, 1, 0], W, H, fov_y_rad=1.2, device="cpu")
    for shading in ("smooth", "flat"):
        _, ct = cfgs(shading)
        bins, _ = tmr.mesh_bins(mt, cam, ct)
        bins_in_range(bins, n)
        img, trans, depth, fid = render_mesh(mt, cam, ct)
        assert np.isfinite(img.numpy()).all() and np.isfinite(depth.numpy()).all()
        assert bool(((trans == 0) | (trans == 1)).all()) and (trans == 0).any()
        assert bool(((fid >= -1) & (fid < n)).all())
    obj.indices = obj.indices.copy()
    obj.indices[5, 1] = 66 + 16
    with pytest.raises(ValueError, match="vertices"):
        mesh_buffers_from_obj(obj, device="cpu")


# ---- the composed frame --------------------------------------------------------------

COMPOSED_SCENES = {"behind": quad(z=50.0, half=30.0, color=(0.0, 0.8, 0.0)),
                   "front": quad(z=-5.0, half=30.0, color=(0.0, 0.0, 0.9)),
                   "cut": quad(z=0.3, half=1.6, color=(0.2, 0.5, 0.9))}


@pytest.fixture(scope="module")
def splat_scene():
    d = interop.random_splat_arrays(0, 150, sh_degree=1, scale_range=(-2.0, -1.0))
    sj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
    return d, sj, interop.splat_set_from_numpy(d, "cpu")


@pytest.fixture(scope="module")
def composed(splat_scene):
    _, sj, st = splat_scene
    cam_j, cam_t = cameras([0, 0, -10], 64, 64)
    cj, ct = cfgs(w=64, h=64)
    out = {}
    for name, spec in COMPOSED_SCENES.items():
        mj, mt = meshes(spec)
        out[name] = (j_composed(sj.prepare(), cam_j, cj, 32768, mj),
                     render_3dgs_composed(st.prepare(), cam_t, ct, 32768, mt))
    return out


@pytest.mark.parametrize("name", list(COMPOSED_SCENES))
def test_composed_matches_jax(composed, name):
    oj, ot = composed[name]
    assert int(oj.num_pairs) == int(ot.num_pairs) and not bool(ot.overflow)
    for a, b in ((ot.image.numpy(), np.asarray(oj.image)),
                 (ot.transmittance.numpy(), np.asarray(oj.transmittance))):
        assert np.isfinite(a).all() and a.shape == b.shape
        diff = np.abs(a - b)
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    id_j, id_t = np.asarray(oj.splat_id), ot.splat_id.numpy()
    same = id_j == id_t
    assert same.mean() >= ID_AGREE
    # a splat's depth, or the mesh's where neither picked a splat
    np.testing.assert_allclose(ot.depth.numpy()[same], np.asarray(oj.depth)[same],
                               rtol=MESH_DEPTH_RTOL, atol=DEPTH_ATOL)
    covered = ot.transmittance.numpy() == 0
    depth = ot.depth.numpy()
    if name == "cut":  # the quad cuts through the splats: those in front stay
        assert covered.any() and not covered.all()
        front = covered & (id_t >= 0)
        assert front.any() and (depth[front] < 10.3 + 1e-4).all()
        assert np.allclose(depth[covered & (id_t < 0)], 10.3, atol=1e-3)
        return
    assert covered.all()  # either wide quad covers the whole view
    if name == "front":  # and this one hides every splat
        assert (id_t == -1).all() and ot.image[..., 0].max() < 1e-3
        assert np.allclose(depth, 5.0, atol=1e-4)
    else:  # the depth falls back to the mesh's where the splats picked none
        assert (id_t >= 0).any() and (id_t < 0).any()
        assert np.allclose(depth[id_t < 0], 60.0, atol=1e-3)


def test_clip_off_equals_the_pair_frame(splat_scene):
    """No mesh in view: the limit is 0 everywhere, and the composed frame is
    the port's 3DGS frame bit for bit; the clip kernels' twins equal the
    gs2d ones on the same bins, also in the stochastic form."""
    _, _, st = splat_scene
    _, cam_t = cameras([0, 0, -10], 64, 64)
    _, ct = cfgs(w=64, h=64)
    _, mt = meshes(quad(z=-20.0, half=3.0))                        # behind the camera
    got = render_3dgs_composed(st.prepare(), cam_t, ct, 32768, mt)
    want = render_3dgs(st.prepare(), cam_t, ct, 32768)
    for f in ("image", "transmittance", "depth", "splat_id"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
    from vk_gaussian_splatting_tpu_torch.render.pipelines import (
        bin_for_cfg,
        gs_attr_rows,
        raster_statics,
    )
    proj = project_splats(st.prepare(), cam_t, ct)
    bins = bin_for_cfg(proj, *gs_attr_rows(proj), ct, 0)
    zero = tmr.depth_limit_pix_ctx(torch.zeros(64, 64), ct)
    for stochastic in (False, True):
        base = dataclasses.replace(raster_statics(ct), stochastic=stochastic)
        clip = dataclasses.replace(base, model="gs2d_clip")
        a = tr.rasterize_bins(bins, clip, zero, seed=3)
        b = tr.rasterize_bins(bins, base, None, seed=3)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # a limit at the median depth drops every splat behind it
    limit = tmr.depth_limit_pix_ctx(torch.full((64, 64), float(proj.depth.median())), ct)
    clipped = tr.rasterize_bins(bins, clip, limit, seed=3)[0]
    assert (clipped[:, 3] >= b[0][:, 3]).all() and (clipped[:, 3] > b[0][:, 3]).any()


def field_grads_close(got: dict, want: dict, rtol=GRAD_RTOL):
    for f, b in want.items():
        a, b = np.asarray(got[f], np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        assert scale > 0, f
        assert np.abs(a - b).max() <= rtol * scale, (f, np.abs(a - b).max() / scale)


def test_composed_gradients_match_jax(splat_scene):
    """Weighted image plus weighted transmittance of a frame whose mesh cuts
    through the splats: the six SplatSet fields (K2's gs2d_clip form, its
    twin here)."""
    d, sj, _ = splat_scene
    cam_j, cam_t = cameras([0, 0, -10], 64, 64)
    cj, ct = cfgs(w=64, h=64)
    mj, mt = meshes(quad(z=0.3, half=1.6, color=(0.2, 0.5, 0.9)))
    rng = np.random.default_rng(11)
    wimg = rng.normal(size=(64, 64, 3)).astype(np.float32)
    wt = rng.normal(size=(64, 64)).astype(np.float32)

    def loss_j(s):
        o = j_composed(s.prepare(), cam_j, cj, 32768, mj)
        return jnp.sum(o.image * wimg) + jnp.sum(o.transmittance * wt)

    g_j = jax.jit(jax.grad(loss_j))(sj)
    s = interop.splat_set_from_numpy(d, "cpu")
    for f in interop.SPLAT_FIELDS:
        getattr(s, f).requires_grad_()
    before = tr.rasterize_tiles_bwd.launches_gs2d_clip
    o = render_3dgs_composed(s.prepare(), cam_t, ct, 32768, mt)
    assert bool((o.transmittance == 0).any()) and bool((o.transmittance > 0.5).any())
    (torch.sum(o.image * torch.from_numpy(wimg))
     + torch.sum(o.transmittance * torch.from_numpy(wt))).backward()
    assert tr.rasterize_tiles_bwd.launches_gs2d_clip == before  # CPU: the twin, no launch
    field_grads_close({f: getattr(s, f).grad.numpy() for f in interop.SPLAT_FIELDS},
                      {f: getattr(g_j, f) for f in interop.SPLAT_FIELDS})


def test_flat_mesh_face_colour_gradients_match_jax():
    """d(sum image * w)/d face_colors through the flat model (K2's tri2d
    form, its twin here), and tri2d's vertex rows exactly 0."""
    mj, mt = meshes(octa_sphere(1))
    cam_j, cam_t = cameras([0.3, -0.5, -7.0])
    cj, ct = cfgs("flat")
    wimg = np.random.default_rng(12).normal(size=(H, W, 3)).astype(np.float32)

    def loss_j(fc):
        img = jmr.render_mesh(dataclasses.replace(mj, face_colors=fc), cam_j, cj, 16384)[0]
        return jnp.sum(img * wimg)

    g_j = jax.grad(loss_j)(mj.face_colors)
    mt.face_colors.requires_grad_()
    torch.sum(render_mesh(mt, cam_t, ct, 16384)[0] * torch.from_numpy(wimg)).backward()
    field_grads_close({"face_colors": mt.face_colors.grad.numpy()}, {"face_colors": g_j})
    bins, st = tmr.mesh_bins(mt, cam_t, ct, 16384)
    ctx = torch.from_numpy(np.random.default_rng(13).normal(
        size=(st.tiles_x * st.tiles_y, tr.CTX_ROWS, tr.PIX)).astype(np.float32))
    d = tr.rasterize_tiles_bwd(bins.attrs.detach(), bins.tile_start, bins.tile_count, ctx, st)
    assert (d[:6] == 0).all() and (d[9] == 0).all()
    assert (d[6:9] != 0).any()


# ---- refusals ----------------------------------------------------------------------

def test_smooth_triangles_are_forward_only():
    _, mt = meshes(quad())
    _, cam_t = cameras([0, 0, -10])
    _, ct = cfgs("smooth")
    mt.face_colors.requires_grad_()
    img = render_mesh(mt, cam_t, ct, 16384)[0]
    with pytest.raises(NotImplementedError, match="forward-only"):
        img.sum().backward()
    st = tmr.mesh_statics(ct)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tr.rasterize_tiles_bwd(torch.zeros((18, 0)), torch.zeros((24,), dtype=torch.int32),
                               torch.zeros((24,), dtype=torch.int32),
                               torch.zeros((24, tr.CTX_ROWS, tr.PIX)), st)


@pytest.mark.parametrize("model", ["tri2d", "tri2d_smooth"])
def test_triangles_have_no_stochastic_form(model):
    st = tr.RasterStatics(1, 1, model=model, stochastic=True)
    with pytest.raises(ValueError, match="no stochastic form"):
        tr.rasterize_tiles(torch.zeros((tresp.MODELS[model].rows, 0)),
                           torch.zeros((0,), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32), st)
    assert tr.entry_name("rasterize_fwd", dataclasses.replace(st, stochastic=False)) == (
        "rasterize_fwd_" + model)


def test_bucket_kernels_refuse_the_mesh_models():
    from vk_gaussian_splatting_tpu_torch.ops import raster_bucket as rb
    for model in ("gs2d_clip", "tri2d", "tri2d_smooth"):
        st = tr.RasterStatics(2, 2, model=model)
        with pytest.raises(NotImplementedError, match="queue 2"):
            tr.entry_name("raster_bucket_bwd", st)
        bins = types.SimpleNamespace(attrs=torch.zeros((tresp.MODELS[model].rows, 0)),
                                     ids=torch.zeros((0,), dtype=torch.int32),
                                     bucket_starts=torch.zeros((1,), dtype=torch.int32))
        with pytest.raises(NotImplementedError, match="queue 2"):
            rb.rasterize_buckets(bins, st, (128,) * 4, torch.zeros((4, 8, 256)))


# ---- the counters ----------------------------------------------------------------

def test_zero_counters_matches_the_model_exactly():
    w = types.SimpleNamespace()
    tr.zero_counters(w)
    for name in tr.LAUNCH_COUNTER.values():
        setattr(w, name, 5)
    tr.zero_counters(w, ("gs2d", "tri2d"))
    for form, name in tr.LAUNCH_COUNTER.items():
        want = 0 if tr.FORM_MODEL[form] in ("gs2d", "tri2d") else 5
        assert getattr(w, name) == want, form
    assert w.launches_gs2d_clip == w.launches_gs2d_clip_stoch == w.launches_tri2d_smooth == 5
    assert w.launches == w.launches_stoch == w.launches_keyrow == w.launches_tri2d == 0
    assert "tri2d_stoch" not in tr.LAUNCH_COUNTER
    assert tr.TRAINED == ("gs2d", "gut3d", "gs2d_clip", "tri2d")
    bwd = tr.rasterize_tiles_bwd
    assert bwd.launches_gs2d_clip_stoch == 0 and not hasattr(bwd, "launches_tri2d_smooth")


# ---- the triangle cull ---------------------------------------------------------------

def triangle_lists(case, tiles_x=4, tiles_y=4):
    """(attrs, tile_start, tile_count) with every triangle of ``case`` in
    every tile's list: rows 0-5 the vertices, 6-8 a colour, 9 a depth."""
    rng = np.random.default_rng(7)
    if case == "sliver":  # long and thin, sharp vertices, either winding
        a = rng.uniform(-10, 74, (60, 2))
        b = rng.uniform(-10, 74, (60, 2))
        c = a + rng.normal(scale=0.05, size=(60, 2)) + (b - a) * rng.uniform(0, 1, (60, 1))
        tris = np.stack([a, b, c], axis=1)
    elif case == "collinear":  # zero area: the edge functions vanish along the line
        a = rng.uniform(-10, 74, (40, 2))
        b = rng.uniform(-10, 74, (40, 2))
        tris = np.stack([a, b, a + (b - a) * rng.uniform(-0.5, 1.5, (40, 1))], axis=1)
        tris[:8] = np.round(tris[:8])  # some through pixel corners and centres
        tris[8:12] = np.floor(tris[8:12]) + 0.5
    elif case == "point":  # coincident vertices cover every pixel they are binned to
        tris = np.repeat(rng.uniform(0, 64, (10, 1, 2)), 3, axis=1)
    else:  # large and small, on and off screen, against the tile origins
        a = rng.uniform(-300, 360, (80, 2))
        tris = a[:, None, :] + rng.normal(scale=rng.uniform(0.5, 120, (80, 1, 1)), size=(80, 3, 2))
    f = tris.shape[0]
    rows = np.zeros((10, f), np.float32)
    rows[:6] = tris.reshape(f, 6).T
    rows[6:9], rows[9] = 0.5, np.arange(f)
    t = tiles_x * tiles_y
    attrs = torch.from_numpy(np.tile(rows, (1, t)))
    start = torch.arange(t, dtype=torch.int32) * f
    return attrs, start, torch.full((t,), f, dtype=torch.int32)


@pytest.mark.parametrize("case", ["sliver", "collinear", "point", "mixed"])
def test_triangle_cull_keeps_every_hit(case):
    attrs, start, count = triangle_lists(case)
    st = tr.RasterStatics(4, 4, model="tri2d", depth_iso=0.999)
    keep_w = tr.pair_warp_may_hit(attrs, start, count, st)
    hits_w = tr.pair_hits(attrs, start, count, st, per_warp=True)
    assert not (hits_w & ~keep_w).any()
    keep = tr.pair_may_hit(attrs, start, count, st)
    hits = tr.pair_hits(attrs, start, count, st)
    assert not (hits & ~keep).any()
    assert hits_w.any()
    if case != "point":  # the reach culls: the cull is worth its tests
        assert keep_w.float().mean() < 0.8, keep_w.float().mean()
    # the culled (warp, pair)s change nothing: the sweep over the kept ones
    ids = torch.arange(attrs.shape[1], dtype=torch.int32)
    out = tr.rasterize_tiles_ref(attrs, ids, start, count, st)[0]
    assert ((out[:, 3] == 0) | (out[:, 3] == 1)).all()
    dropped = attrs.clone()
    dropped[:6, ~keep_w.any(dim=1)] = float("nan")
    assert torch.equal(tr.rasterize_tiles_ref(dropped, ids, start, count, st)[0], out)
