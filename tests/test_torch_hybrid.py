"""The hybrid frame with deep shadow maps (``render_hybrid``,
``rt.shadows="map"``) on the CPU, on seeded random splats.

- Against the benchmark's plain float32 reference
  (splatbench/reference/hybrid.py) at a small size (2,000 splats, 64x48, a
  spot light's cone map and an enclosed point light's six cube faces at
  the map size, 32 or 16): the primary frame, the normal image, the
  shaded image and each map face's four iso depths. The program freezes a
  pixel at the end of its 128-pair chunk and the reference at the splat,
  so the images agree to 2e-4 (the transmittance's 1e-4 termination,
  twice); a splat that one of the two rounds across a cutoff or a
  transmittance level moves a pixel or a texel further, so each agreement
  is asked of all but a share of 1 % of them.
- A map budget too small for the maps sets the frame's ``overflow``, the
  primary's budget being enough.
- ``shadow_pairs`` is the sum of the map faces' live pairs.
- Each map opens shadow_map.project, shadow_map.bin and shadow_map.blend
  inside its light's shadow_map span.
- The default map budget gives, bit for bit, the frame of an explicit
  max(4 N, 2^18) and of the maps and shade composed by hand as the frame
  did before it took a budget.
"""

import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch.render.deferred import DeferredMaterial, deferred_shade
from vk_gaussian_splatting_tpu_torch.render.pipelines import render_hybrid
from vk_gaussian_splatting_tpu_torch.render.shadows import CubeShadowMap, make_shadow_fn
from vk_gaussian_splatting_tpu_torch.scene.lights import AttenuationMode, LightType, make_light
from splatbench import cameras, scene
from splatbench.reference import hybrid as ref

torch.set_num_threads(2)

W, H, N = 64, 48, 2000
EXTENT = 2.0
MIX = [[0.6, -4.0, -3.0], [0.3, -3.0, -2.5], [0.1, -2.5, -2.0]]
IMG_ATOL = 2e-4
SHARE = 0.01
MAX_PAIRS = 1 << 16


def plain_lights(eye):
    spot = np.asarray(eye, np.float64) + [0.0, 0.25 * EXTENT, 0.0]
    point = EXTENT * np.array([0.35 * math.sin(0.7), 0.25, -0.35 * math.cos(0.7)])
    out = []
    for kind, pos in (("spot", spot), ("point", point)):
        d = -pos / np.linalg.norm(pos)
        out.append(ref.Light(kind, tuple(float(v) for v in pos.astype(np.float32)),
                             tuple(float(v) for v in d.astype(np.float32))))
    return out


def program_lights(plain):
    kinds = {"spot": LightType.SPOT, "point": LightType.POINT}
    return tuple(make_light(kinds[p.kind], p.position, p.direction, p.color, p.intensity,
                            attenuation=AttenuationMode.NONE, inner_cone_deg=p.inner_cone_deg,
                            outer_cone_deg=p.outer_cone_deg, device="cpu") for p in plain)


@pytest.fixture(scope="module")
def setup():
    inputs = scene.bench_scene(torch.device("cpu"), N, 2147483901, 3, EXTENT, MIX)
    eye = [1.2, 0.0, -3.3]
    pose = cameras.look_at(eye, np.zeros(3), W, H, 0.9, 0.01, 1e4)
    cam = gt.make_camera(pose.viewmat, pose.fx, pose.fy, pose.cx, pose.cy, pose.near, pose.far,
                         device="cpu")
    cfg = gt.RenderConfig(width=W, height=H, sh_degree=3, pipeline=gt.Pipeline.HYBRID,
                          raster=gt.RasterConfig(expansion="exact"))
    prepared = gt.SplatSet(**inputs).prepare(cfg.sh_format)
    plain = plain_lights(eye)
    return inputs, pose, cam, cfg, prepared, plain, program_lights(plain)


def frame(setup, **kw):
    _, _, cam, cfg, prepared, _, lights = setup
    return render_hybrid(prepared, cam, cfg, MAX_PAIRS, lights=lights, **kw)


def faces(shadow_maps):
    return [f for m in shadow_maps for f in (m.faces if isinstance(m, CubeShadowMap) else [m])]


def share_off(a, b, atol):
    return float((torch.abs(a - b) > atol).float().mean())


@pytest.mark.parametrize("res", [32, 16])
def test_frame_matches_the_reference(setup, res):
    inputs, pose, _, _, _, plain, _ = setup
    out, shaded, normals = frame(setup, shadow_res=res)
    r = ref.render(inputs, pose, plain, res)
    assert not bool(out.overflow)
    assert share_off(out.image, r.primary.image, IMG_ATOL) <= SHARE
    assert share_off(out.transmittance, r.primary.transmittance, IMG_ATOL) <= SHARE
    assert float((out.splat_id.long() != r.primary.splat_id).float().mean()) <= SHARE
    assert share_off(out.depth, r.primary.depth, 1e-5) <= SHARE
    cov = r.covered
    assert int(cov.sum()) > W * H // 4
    cos = (normals * r.normals).sum(-1)[cov]
    assert float((cos < math.cos(math.radians(1.0))).float().mean()) <= SHARE
    assert share_off(shaded, r.shaded, IMG_ATOL) <= SHARE
    # the shadows darken part of the frame: the check sees them
    assert float((r.shadow_t < 1).float().mean()) > 0.05
    prog = faces(out.shadow_maps)
    want = [f for light in r.maps for f in light]
    assert len(prog) == len(want) == 7
    assert [f.breakpoints.shape[0] for f in prog] == [res] * 7
    for p, w in zip(prog, want):
        assert torch.allclose(p.cam.viewmat, torch.as_tensor(w.pose.viewmat), atol=1e-6)
        assert float(p.cam.fx) == pytest.approx(w.pose.fx, rel=1e-6)
        assert (p.breakpoints > 0).any()
        assert share_off(p.breakpoints, w.breakpoints, 1e-5) <= SHARE


def test_map_budget_too_small_overflows(setup):
    out, _, _ = frame(setup, shadow_res=32, shadow_max_pairs=128)
    assert bool(out.overflow)
    assert any(bool(f.overflow) for f in faces(out.shadow_maps))
    # the primary alone fits its budget
    assert not bool(frame(setup, shadow_res=32)[0].overflow)


def test_shadow_pairs_sum_the_faces(setup):
    out, _, _ = frame(setup, shadow_res=32)
    per_face = [int(f.num_pairs) for f in faces(out.shadow_maps)]
    assert len(per_face) == 7 and min(per_face) > 0
    assert int(out.shadow_pairs) == sum(per_face)
    assert int(out.num_pairs) > 0


def test_frames_without_maps_carry_none(setup):
    _, _, cam, cfg, prepared, _, lights = setup
    lit, _, _ = gt.render_3dgs_lit(prepared, cam, cfg, MAX_PAIRS, lights=lights)
    unshadowed, _, _ = render_hybrid(prepared, cam, cfg, MAX_PAIRS, lights=())
    for out in (lit, unshadowed):
        assert out.shadow_pairs is None and out.shadow_maps is None


def test_map_children_open_inside_shadow_map(setup):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            frame(setup, shadow_res=16)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "user_annotation"]
    parents = [(e["ts"], e["ts"] + e["dur"]) for e in events if e["name"] == "shadow_map"]
    assert len(parents) == 2
    for child in ("shadow_map.project", "shadow_map.bin", "shadow_map.blend"):
        spans = [e for e in events if e["name"] == child]
        assert len(spans) == 7, child
        for e in spans:
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in parents), child
    for name in ("normals", "shade"):
        assert sum(e["name"] == name for e in events) == 1


def test_default_budget_is_the_frame_before(setup):
    _, _, cam, cfg, prepared, _, lights = setup
    out, shaded, normals = frame(setup, shadow_res=32)
    explicit = frame(setup, shadow_res=32, shadow_max_pairs=max(4 * N, 1 << 18))
    assert torch.equal(shaded, explicit[1]) and torch.equal(normals, explicit[2])
    assert int(out.shadow_pairs) == int(explicit[0].shadow_pairs)
    by_hand = deferred_shade(out.image, out.transmittance, normals, out.depth, cam, cfg,
                             list(lights), DeferredMaterial(),
                             shadow_fn=make_shadow_fn(prepared, lights, cfg, 32))
    assert torch.equal(shaded, by_hand)
