"""Project files on the CPU: the port's io/project.py and CameraSet against the
JAX package's. A project written by either package opens in the other with
the same configuration, instances, cameras and lights, and its flattened
scene renders the same frame.

Tolerances:
- configuration, instances (transforms, overrides, names), camera fields
  and light fields: exactly (both write the same JSON keys from float32
  values and read them back to float32);
- the JSON text either package writes for the same session: equal;
- frames of the reopened scenes, the port against JAX: the gs2d gate of
  tests/test_torch_render.py with 3e-5 (image and T within 3e-5 on
  >= 99.9 % of channels, none beyond 1.2e-2; ids on >= 99.9 % of pixels;
  depth 1e-5 where the ids agree); the port's frame of the reopened scene
  against its in-memory scene: bit for bit.

JAX programs built here: one raster frame (both directions render the same
shapes; about 15 s alone).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
from vk_gaussian_splatting_tpu.io import save_ply as j_save_ply
from vk_gaussian_splatting_tpu.io import project as jp
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs as j_render
from vk_gaussian_splatting_tpu.scene import cameras as jcam
from vk_gaussian_splatting_tpu.scene import instances as ji
from vk_gaussian_splatting_tpu.scene import lights as jl
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch as gt
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.io import project as tp
from vk_gaussian_splatting_tpu_torch.io import save_ply
from vk_gaussian_splatting_tpu_torch.render import render_3dgs
from vk_gaussian_splatting_tpu_torch.scene import lights as tl
from vk_gaussian_splatting_tpu_torch.scene.cameras import CameraSet, make_camera
from vk_gaussian_splatting_tpu_torch.scene.instances import SplatScene

torch.set_num_threads(2)

IMG_ATOL, IMG_SHARE, IMG_MAX = 3e-5, 0.999, 1.2e-2
DEPTH_ATOL = 1e-5
ID_AGREE = 0.999
W, H = 96, 72
CAMERA_FIELDS = interop.CAMERA_FIELDS
LIGHT_FIELDS = ("type", "position", "direction", "color", "intensity", "range",
                "attenuation_mode", "inner_cone_deg", "outer_cone_deg", "radius")


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rigid(angle, scale, t):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    m[:3, :3] = scale * np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    m[:3, 3] = t
    return m


SHEAR = np.eye(4)
SHEAR[:3, :3] = [[1.4, 0.25, 0.0], [0.0, 0.7, 0.0], [0.0, 0.0, 1.0]]
SHEAR[:3, 3] = [-1.5, 0.3, 0.5]
INSTANCES = [dict(asset=0, name="base"),
             dict(asset=0, transform=rigid(0.7, 0.8, (1.6, -0.3, 0.4)), splat_scale=1.25,
                  opacity_gain=0.6, name="rigid"),
             dict(asset=1, transform=SHEAR, name="sheared"),
             dict(asset=1, visible=False, name="hidden")]
CONFIG = dict(pipeline=4, sh_degree=2, sh_format=1, camera_type=1, shutter=3,
              splat_scale=1.1, stochastic=1, temporal_samples=4, opacity_gain=0.9,
              show_sh_only=True, width=320, height=240, background=(0.1, 0.2, 0.3))
RASTER = dict(size_culling=True, size_culling_min_px=2.0, point_cloud_mode=True,
              ms_antialiasing=True, depth_iso_threshold=0.5, pair_format="packed")
RT = dict(kernel_degree=3, max_bounces=5)
LIGHTS = (dict(light_type=1, position=(1.0, 1.0, 1.0), direction=(0.0, -1.0, 0.2),
               color=(1.0, 0.8, 0.6), intensity=2.0, range=50.0, attenuation=2,
               inner_cone_deg=15.0, outer_cone_deg=45.0, radius=0.1),
          dict(light_type=2, direction=(0.3, -1.0, 0.2), intensity=1.2))


def configs():
    out = []
    for pkg in (jc, tc):
        cfg = pkg.RenderConfig(
            pipeline=pkg.Pipeline(CONFIG["pipeline"]), sh_degree=CONFIG["sh_degree"],
            sh_format=pkg.ShFormat(CONFIG["sh_format"]),
            camera_type=pkg.CameraType(CONFIG["camera_type"]),
            shutter=pkg.ShutterType(CONFIG["shutter"]),
            stochastic=pkg.StochasticMode(CONFIG["stochastic"]),
            **{k: v for k, v in CONFIG.items()
               if k not in ("pipeline", "sh_format", "camera_type", "shutter", "stochastic",
                            "sh_degree")})
        out.append(cfg.replace(raster=dataclasses.replace(cfg.raster, **RASTER),
                               rt=dataclasses.replace(cfg.rt, **RT)))
    return out


def camera_arrays():
    """Two cameras: a pinhole one and a fisheye rolling-shutter one with a
    distortion pack and an end pose."""
    cam = gt.look_at([0.3, -0.4, -11.0], [0, 0.3, 0.5], [0, 1, 0], W, H, fov_y_rad=0.9,
                     device="cpu")
    a = interop.camera_to_numpy(cam)
    b = {k: np.array(v, copy=True) for k, v in a.items()}
    b["viewmat_end"][0, 3] += 0.25
    b["distortion"][[0, 6, 12, 16]] = (0.1, -0.02, 0.3, 1.4)
    b["focus_dist"], b["aperture"] = np.float32(7.5), np.float32(0.05)
    return a, b


def asset_arrays():
    return [interop.random_splat_arrays(50, 300, sh_degree=3, extent=1.5,
                                        scale_range=(-3.5, -1.8)),
            interop.random_splat_arrays(51, 200, sh_degree=1, extent=1.5,
                                        scale_range=(-3.5, -1.8))]


def port_project(tmp_path, assets):
    scene = interop.splat_scene_from_numpy(assets, INSTANCES, device="cpu")
    paths = []
    for i, a in enumerate(scene.assets):
        paths.append(str(tmp_path / f"asset{i}.ply"))
        save_ply(paths[-1], a)
        scene.asset_names[i] = f"set {i}"
    cams = CameraSet()
    for name, arr in zip(("main", "fisheye"), camera_arrays()):
        cams.add(interop.camera_from_numpy(arr, device="cpu"), name)
    lights = [tl.make_light(**kw, device="cpu") for kw in LIGHTS]
    return tp.Project(scene=scene, cameras=cams, lights=lights, config=configs()[1],
                      asset_paths=paths, mesh_paths=[str(tmp_path / "mesh.obj")])


def jax_project(tmp_path, assets):
    scene = ji.SplatScene()
    paths = []
    for i, d in enumerate(assets):
        splats = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
        paths.append(str(tmp_path / f"asset{i}.ply"))
        j_save_ply(paths[-1], splats)
        scene.add_asset(splats, f"set {i}")
    for kw in INSTANCES:
        kw = dict(kw)
        scene.add_instance(kw.pop("asset"), **kw)
    cams = jcam.CameraSet()
    for name, arr in zip(("main", "fisheye"), camera_arrays()):
        cams.add(jcam.make_camera(**arr), name)
    lights = []
    for kw in LIGHTS:
        kw = dict(kw)
        kind = jl.LightType(kw.pop("light_type"))
        att = jl.AttenuationMode(kw.pop("attenuation", 0))
        lights.append(jl.make_light(kind, attenuation=att, **kw))
    return jp.Project(scene=scene, cameras=cams, lights=lights, config=configs()[0],
                      asset_paths=paths, mesh_paths=[str(tmp_path / "mesh.obj")])


def assert_same_session(a, b):
    """Project ``a`` (either package) holds what ``b`` (either) holds."""
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert a.asset_paths == b.asset_paths and a.mesh_paths == b.mesh_paths
    assert a.scene.asset_names == b.scene.asset_names
    assert len(a.scene.instances) == len(b.scene.instances)
    for x, y in zip(a.scene.instances, b.scene.instances):
        np.testing.assert_array_equal(x.transform, y.transform)
        assert (x.asset, x.splat_scale, x.opacity_gain, x.visible, x.name) == (
            y.asset, y.splat_scale, y.opacity_gain, y.visible, y.name)
    assert a.cameras.names == b.cameras.names and a.cameras.active == b.cameras.active
    for x, y in zip(a.cameras.cameras, b.cameras.cameras):
        for f in CAMERA_FIELDS:
            np.testing.assert_array_equal(np_(getattr(x, f)), np_(getattr(y, f)), err_msg=f)
    assert len(a.lights) == len(b.lights)
    for x, y in zip(a.lights, b.lights):
        for f in LIGHT_FIELDS:
            np.testing.assert_array_equal(np_(getattr(x, f)), np_(getattr(y, f)), err_msg=f)


def assert_frames_close(oj, ot):
    assert int(oj.num_pairs) == int(ot.num_pairs) and bool(oj.overflow) == bool(ot.overflow)
    for a, b in ((ot.image, oj.image), (ot.transmittance, oj.transmittance)):
        diff = np.abs(np_(a) - np.asarray(b))
        assert (diff <= IMG_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()
    id_j, id_t = np.asarray(oj.splat_id), np_(ot.splat_id)
    same = id_j == id_t
    assert same.mean() >= ID_AGREE
    both = same & (id_j >= 0)
    assert both.mean() > 0.05
    np.testing.assert_allclose(np_(ot.depth)[both], np.asarray(oj.depth)[both], rtol=0,
                               atol=DEPTH_ATOL)


def frames(pj, pt):
    """(JAX frame, port frame) of the two reopened projects' flattened
    scenes, from their first camera, at 96x72 SH 3 (the saved config is
    the packed fisheye one; the frame is the plain 3DGS pass)."""
    prep_j, _ = pj.scene.flatten()
    prep_t, _ = pt.scene.flatten()
    cj = jc.RenderConfig(width=W, height=H, sh_degree=3)
    ct = tc.RenderConfig(width=W, height=H, sh_degree=3)
    return (j_render(prep_j, pj.cameras.get(), cj, max_pairs=0),
            render_3dgs(prep_t, pt.cameras.get(), ct, max_pairs=0))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The same session saved by each package, in two directories."""
    assets = asset_arrays()
    dt, dj = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    tp.save_project(str(dt / "session.vkgs.json"), port_project(dt, assets))
    jp.save_project(str(dj / "session.vkgs.json"), jax_project(dj, assets))
    return str(dt / "session.vkgs.json"), str(dj / "session.vkgs.json")


def test_both_packages_write_the_same_json(saved):
    with open(saved[0]) as f, open(saved[1]) as g:
        assert f.read() == g.read()


def test_port_project_opens_in_jax(saved):
    pt = tp.load_project(saved[0], device="cpu")
    pj = jp.load_project(saved[0])
    assert_same_session(pt, pj)
    assert pt.config.raster.pair_format == "packed" and pt.config.rt.max_bounces == 5
    assert pt.config.shutter == tc.ShutterType.ROLLING_RIGHT_TO_LEFT
    assert len(pt.scene.assets) == 2 and pt.scene.assets[0].num_splats == 300
    oj, ot = frames(pj, pt)
    assert_frames_close(oj, ot)


def test_jax_project_opens_in_port(saved, tmp_path):
    pj = jp.load_project(saved[1])
    pt = tp.load_project(saved[1], device="cpu")
    assert_same_session(pt, pj)
    oj, ot = frames(pj, pt)
    assert_frames_close(oj, ot)
    # the reopened scene renders the in-memory scene's frame bit for bit
    mem = interop.splat_scene_from_numpy(asset_arrays(), INSTANCES, device="cpu")
    prep, table = mem.flatten()
    ref = render_3dgs(prep, pt.cameras.get(), tc.RenderConfig(width=W, height=H, sh_degree=3))
    for f in ("image", "transmittance", "depth", "splat_id"):
        assert torch.equal(getattr(ref, f), getattr(ot, f)), f
    # and a second save of the reopened session writes the same JSON
    again = str(tmp_path / "again.vkgs.json")
    pt.asset_paths = [str(tmp_path / p) for p in ("asset0.ply", "asset1.ply")]
    pt.mesh_paths = [str(tmp_path / "mesh.obj")]
    tp.save_project(again, pt)
    with open(again) as f, open(saved[1]) as g:
        assert f.read() == g.read()


def test_project_roundtrip(tmp_path):
    """The JAX package's test_project_roundtrip, on the port."""
    d = interop.random_splat_arrays(0, 100, sh_degree=1)
    splats = interop.splat_set_from_numpy(d, "cpu")
    ply = tmp_path / "scene.ply"
    save_ply(str(ply), splats)

    scene = SplatScene()
    scene.add_asset(splats, "main")
    m = np.eye(4)
    m[:3, 3] = [1, 2, 3]
    scene.add_instance(0, transform=m, splat_scale=1.5, name="inst0")
    cams = CameraSet()
    cam0 = gt.look_at([0, 0, -5], [0, 0, 0], [0, 1, 0], 320, 240, device="cpu")
    vm_end = cam0.viewmat.numpy().copy()
    vm_end[0, 3] += 0.25
    dist = np.zeros(18, np.float32)
    dist[0], dist[6], dist[12] = 0.1, -0.02, 0.3
    cam0 = dataclasses.replace(cam0, viewmat_end=torch.from_numpy(vm_end),
                               distortion=torch.from_numpy(dist))
    cams.add(cam0, "view0")
    lights = [tl.make_light(tl.LightType.SPOT, position=(1, 1, 1), intensity=2.0,
                            outer_cone_deg=45.0, device="cpu")]
    cfg = tc.RenderConfig(pipeline=tc.Pipeline.MESH_3DGUT, sh_degree=2,
                          sh_format=tc.ShFormat.FLOAT16, width=320, height=240)
    proj = tp.Project(scene=scene, cameras=cams, lights=lights, config=cfg,
                      asset_paths=[str(ply)])
    pp = tmp_path / "session.vkgs.json"
    tp.save_project(str(pp), proj)

    loaded = tp.load_project(str(pp), device="cpu")
    assert loaded.config.pipeline == tc.Pipeline.MESH_3DGUT
    assert loaded.config.sh_format == tc.ShFormat.FLOAT16
    assert loaded.config.sh_degree == 2
    assert len(loaded.scene.assets) == 1 and loaded.scene.assets[0].num_splats == 100
    inst = loaded.scene.instances[0]
    np.testing.assert_allclose(inst.transform[:3, 3], [1, 2, 3])
    assert inst.splat_scale == 1.5 and inst.name == "inst0"
    assert loaded.scene.asset_names == ["main"]
    assert len(loaded.cameras.cameras) == 1 and loaded.cameras.names == ["view0"]
    np.testing.assert_allclose(np_(loaded.cameras.get().viewmat), np_(cams.get().viewmat),
                               atol=1e-6)
    np.testing.assert_allclose(np_(loaded.cameras.get().viewmat_end), vm_end, atol=1e-6)
    np.testing.assert_allclose(np_(loaded.cameras.get().distortion), dist, atol=1e-7)
    li = loaded.lights[0]
    assert int(li.type) == int(tl.LightType.SPOT) and float(li.intensity) == 2.0
    assert float(li.outer_cone_deg) == 45.0
    prepared, _ = loaded.scene.flatten(loaded.config.sh_format)
    assert prepared.sh.dtype == torch.float16
    out = render_3dgs(prepared, loaded.cameras.get(),
                      tc.RenderConfig(width=64, height=48, sh_degree=1), 16384)
    assert np.isfinite(np_(out.image)).all()


def test_project_roundtrips_new_config_fields(tmp_path):
    """The JAX package's test_project_roundtrips_new_config_fields."""
    cfg = tc.RenderConfig(shutter=tc.ShutterType.ROLLING_LEFT_TO_RIGHT)
    cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, pair_format="packed"),
                      rt=dataclasses.replace(cfg.rt, max_bounces=5))
    proj = tp.Project(scene=SplatScene(), cameras=CameraSet(), lights=[], config=cfg,
                      asset_paths=[])
    path = str(tmp_path / "p.vkgs.json")
    tp.save_project(path, proj)
    back = tp.load_project(path, device="cpu")
    assert back.config.shutter == tc.ShutterType.ROLLING_LEFT_TO_RIGHT
    assert back.config.raster.pair_format == "packed"
    assert back.config.rt.max_bounces == 5


def test_kernel_min_response_is_written_and_never_read(saved, tmp_path):
    with open(saved[0]) as f:
        data = json.load(f)
    assert data["renderer"]["kernelMinResponse"] == 0.0113
    assert data["version"] == tp.PROJECT_VERSION == jp.PROJECT_VERSION
    data["renderer"]["kernelMinResponse"] = 0.5
    path = str(tmp_path / "edited.vkgs.json")
    with open(path, "w") as f:
        json.dump(data, f)
    cfg = tp.load_project(path, load_assets=False, device="cpu").config
    assert cfg == tp.load_project(saved[0], load_assets=False, device="cpu").config
    assert cfg == tp._config_from_json(data["renderer"])
    assert tp._config_to_json(cfg)["kernelMinResponse"] == 0.0113


def test_load_assets_false_appends_none_assets(saved):
    pt = tp.load_project(saved[0], load_assets=False, device="cpu")
    pj = jp.load_project(saved[0], load_assets=False)
    assert pt.scene.assets == pj.scene.assets == [None, None]
    assert pt.scene.asset_names == pj.scene.asset_names == ["set 0", "set 1"]
    assert len(pt.scene.instances) == len(INSTANCES)


def test_active_camera_defaults(tmp_path):
    """activeCamera absent: 0 with cameras, -1 without (both packages)."""
    base = {"version": 1, "renderer": {}}
    cam = {"viewMatrix": np.eye(4).tolist(), "fx": 100.0, "fy": 100.0, "cx": 50.0,
           "cy": 40.0}
    for cams, want in (([], -1), ([cam, cam], 0)):
        path = str(tmp_path / f"c{len(cams)}.vkgs.json")
        with open(path, "w") as f:
            json.dump({**base, "cameras": cams}, f)
        pt = tp.load_project(path, device="cpu")
        assert pt.cameras.active == jp.load_project(path).cameras.active == want
        assert pt.config == tp._config_from_json({})
        if cams:
            c = pt.cameras.get()
            assert pt.cameras.names == ["camera 0", "camera 1"]
            assert torch.equal(c.viewmat_end, c.viewmat) and not bool(c.distortion.any())
            assert float(c.near) == np.float32(0.01) and float(c.far) == 1e4


def test_camera_set():
    cams = CameraSet()
    assert cams.active == -1
    a = make_camera(np.eye(4), 100, 100, 50, 40, device="cpu")
    b = make_camera(np.eye(4), 200, 200, 50, 40, device="cpu")
    assert cams.add(a) == 0 and cams.add(b, "second") == 1
    assert cams.names == ["camera 0", "second"] and cams.get() is a
    cams.active = 1
    assert cams.get() is b
    assert gt.scene.CameraSet is CameraSet


def test_load_project_defaults_to_the_card(saved):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.load_project(saved[0])


def test_make_camera_copies_its_inputs():
    """On the CPU a camera shares no memory with the caller's arrays, nor
    viewmat_end with viewmat, nor camera_to_numpy's arrays with the camera:
    editing one must not move another (a fisheye end pose made from the
    headline camera's arrays must leave the headline camera as it is)."""
    vm = np.eye(4, dtype=np.float32)
    cam = make_camera(vm, 100.0, 100.0, 50.0, 40.0, device="cpu")
    vm[0, 3] = 5.0
    assert float(cam.viewmat[0, 3]) == 0.0
    cam.viewmat_end[0, 3] += 0.25
    assert float(cam.viewmat[0, 3]) == 0.0
    arr = interop.camera_to_numpy(cam)
    arr["viewmat"][0, 0] = 9.0
    arr["distortion"][0] = 0.1
    assert float(cam.viewmat[0, 0]) == 1.0 and not bool(cam.distortion.any())
