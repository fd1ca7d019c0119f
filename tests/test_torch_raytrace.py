"""The splat and mesh ray tracer of the PyTorch port (ops/raytrace.py) on the
CPU against the JAX package's (plain XLA there, no Pallas), on the setups
of tests/test_raytrace.py, from one numpy input.

Gates, each with its reason:
- radiance and transmittance: within 1e-4 on >= 99.9 % of rays and every
  ray within 1.2e-2 (one contribution flipped at KERNEL_MIN_RESPONSE: XLA
  contracts multiply-adds into FMAs, torch does not, so a response within
  rounding of a cutoff may land on either side);
- iso depth: the same pick (within 1e-5 relative) on >= 99.9 % of rays;
- the any-hit and pass estimators with the JAX draws substituted for the
  port's (``raytrace.trace_uniforms``): the same gates, value for value;
  with the port's own draws: unbiased at the JAX tests' Monte-Carlo gates;
- gradients in means, colours and opacities against ``jax.grad``: within
  1e-4 of each row's max, and >= 99.9 % within 1e-2 of (|ref| + the row's
  median nonzero |ref|);
- ``trace_mesh``: face ids equal and t within 1e-5 relative, against JAX
  and against a float64 sweep of every face (no chunks, no skip);
- ``reflect`` and ``refract_or_reflect``: 1e-6;
- results bit-equal across two ``BATCH_BYTES`` caps.

JAX programs built here: a dozen small ``trace_splats`` / ``trace_mesh``
programs (about 20 s alone).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
import vk_gaussian_splatting_tpu.ops.raytrace as jr
from vk_gaussian_splatting_tpu.scene import splat_set as jss
import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.io.obj import octa_sphere
from vk_gaussian_splatting_tpu_torch.ops import raytrace as tr

torch.set_num_threads(2)

ATOL, AGREE, MAX_FLIP = 1e-4, 0.999, 1.2e-2
DEPTH_RTOL = 1e-5
GRAD_RTOL, GRAD_ELEM = 1e-4, 1e-2
MESH_RTOL = 1e-5


def np_(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def both_prepared(d):
    pj = jss.SplatSet(**{k: jnp.asarray(v) for k, v in d.items()}).prepare()
    return pj, interop.splat_set_from_numpy(d, "cpu").prepare()


def cfgs(**kw):
    rt = kw.pop("rt", {})
    base = dict(width=8, height=8, sh_degree=0)
    base.update(kw)
    cj, ct = jc.RenderConfig(**base), tc.RenderConfig(**base)
    return (cj.replace(rt=dataclasses.replace(cj.rt, **rt)),
            ct.replace(rt=dataclasses.replace(ct.rt, **rt)))


def ray_batch(seed, r, spread=0.3, cone=0.5):
    """tests/test_raytrace.py's batch: origins about (0, -0.5, -6), unit
    directions in a cone about +z."""
    rng = np.random.default_rng(seed)
    o = np.float32([0.0, -0.5, -6.0]) + spread * rng.normal(size=(r, 3)).astype(np.float32)
    d = np.float32([0.0, 0.0, 1.0]) + cone * rng.normal(size=(r, 3)).astype(np.float32)
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def trace_both(pj, pt, cj, ct, o, d, tmin, tmax, **kw):
    """(JAX TraceResult, port TraceResult) on one numpy input."""
    rj = jr.trace_splats(pj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                         jnp.asarray(tmax), cj, **kw)
    rt = tr.trace_splats(pt, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmin),
                         torch.from_numpy(tmax), ct, **kw)
    return rj, rt


def ray_gate(got, want, label=""):
    """The per-ray gate of radiance or transmittance (the module docstring)."""
    diff = np.abs(np_(got) - np.asarray(want))
    per_ray = diff.reshape(diff.shape[0], -1).max(axis=1)
    print(f"{label}: max {per_ray.max():.3e}, {int((per_ray > ATOL).sum())} of {len(per_ray)} "
          f"rays beyond {ATOL}")
    assert (per_ray <= ATOL).mean() >= AGREE and per_ray.max() <= MAX_FLIP, per_ray.max()


def result_gate(rj, rt, label=""):
    ray_gate(rt.radiance, rj.radiance, label + " radiance")
    ray_gate(rt.transmittance, rj.transmittance, label + " T")
    dj, dt = np.asarray(rj.depth), np_(rt.depth)
    same = np.abs(dt - dj) <= DEPTH_RTOL * np.maximum(np.abs(dj), 1.0)
    assert same.mean() >= AGREE, (dt[~same], dj[~same])


def full_window(r, lo=0.0):
    return np.full(r, lo, np.float32), np.full(r, np.inf, np.float32)


# ---- trace_splats against JAX ---------------------------------------------------

def test_trace_splats_radial_matches_jax():
    """tests/test_raytrace.py:49: 800 splats at SH 1, 768 rays, chunk 128,
    ray blocks of 256 (three blocks), the window (-inf, inf)."""
    pj, pt = both_prepared(interop.random_splat_arrays(0, 800, sh_degree=1))
    cj, ct = cfgs(width=32, height=24, sh_degree=1)
    o, d = ray_batch(1, 768)
    tmin, tmax = full_window(768, -np.inf)
    rj, rt = trace_both(pj, pt, cj, ct, o, d, tmin, tmax, chunk=128, ray_block=256,
                        order="radial")
    result_gate(rj, rt, "radial")
    assert float(rt.transmittance.min()) < 0.5 and (np_(rt.depth) > 0).any()


def test_trace_splats_t_window_matches_jax():
    """tests/test_raytrace.py:78: t_max clipping removes everything beyond
    the window (exactly), and the open window agrees with JAX."""
    pj, pt = both_prepared(interop.random_splat_arrays(2, 200, sh_degree=0))
    cj, ct = cfgs()
    o, d = ray_batch(3, 64, spread=0.05, cone=0.2)
    tmin, tmax = full_window(64)
    rj, rt = trace_both(pj, pt, cj, ct, o, d, tmin, tmax, chunk=64, ray_block=64)
    result_gate(rj, rt, "full window")
    assert float(rt.transmittance.min()) < 1.0
    none = tr.trace_splats(pt, torch.from_numpy(o), torch.from_numpy(d), torch.zeros(64),
                           torch.full((64,), 1e-4), ct, chunk=64, ray_block=64)
    assert float(none.radiance.abs().max()) == 0.0
    assert float((none.transmittance - 1.0).abs().max()) == 0.0


def line_scene(seed, n, jitter):
    """tests/test_raytrace.py:338's scene: opaque-ish splats (sigmoid 4 =
    0.98) of scale 0.25 along the x axis, where composition order matters."""
    d = interop.random_splat_arrays(seed, n, sh_degree=0)
    rng = np.random.default_rng(seed + 100)
    d["means"] = np.stack([np.linspace(-4.0, 4.0, n), rng.uniform(0, jitter, n),
                           np.zeros(n)], 1).astype(np.float32)
    d["opacities"] = np.full(n, 4.0, np.float32)
    d["scales"] = np.full((n, 3), np.log(0.25), np.float32)
    return d


def wide_baseline(r):
    """Origins on two opposite sides of the line, opposed directions."""
    half = r // 2
    left = np.stack([np.full(half, -8.0), np.linspace(-0.1, 0.3, half), np.zeros(half)], 1)
    right = np.stack([np.full(half, 8.0), np.linspace(-0.1, 0.3, half), np.zeros(half)], 1)
    dirs = np.concatenate([np.tile([[1.0, 0.0, 0.0]], (half, 1)),
                           np.tile([[-1.0, 0.0, 0.0]], (half, 1))])
    return (np.concatenate([left, right]).astype(np.float32), dirs.astype(np.float32))


@pytest.mark.parametrize("order", ["radial", "windowed", "auto"])
def test_orders_on_the_wide_baseline_match_jax(order):
    """tests/test_raytrace.py:338 and :387: each order against JAX on the
    wide-baseline batch (max_passes 64); auto picks windowed there, and
    windowed differs from radial (the radial order is wrong for half the
    rays)."""
    pj, pt = both_prepared(line_scene(7, 64, 0.2))
    cj, ct = cfgs(rt=dict(max_passes=64))
    o, d = wide_baseline(32)
    tmin, tmax = full_window(32)
    rj, rt = trace_both(pj, pt, cj, ct, o, d, tmin, tmax, chunk=64, ray_block=32, order=order)
    result_gate(rj, rt, order)
    if order != "radial":
        radial = tr.trace_splats(pt, torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(tmin), torch.from_numpy(tmax), ct, chunk=64,
                                 ray_block=32, order="radial")
        assert float((radial.radiance - rt.radiance).abs().max()) > 1e-2


def test_auto_takes_the_midpoint_median():
    """``order="auto"`` compares the origin spread with the midpoint median
    of the splat distances (``jnp.median``), not the lower middle value
    (``torch.median``): distances (1, 2, 10, 12) and a spread of 0.4 pick
    radial (0.4 < 0.1 * 6), where the lower median would pick windowed
    (0.4 > 0.1 * 2). Counted by the sweep steps: radial sweeps each chunk
    once, windowed once per slab."""
    d = interop.random_splat_arrays(4, 4, sh_degree=0)
    d["means"] = np.float32([[0, 1, 0], [0, 2, 0], [0, 10, 0], [0, 12, 0]])
    d["scales"] = np.full((4, 3), np.log(0.3), np.float32)
    pj, pt = both_prepared(d)
    cj, ct = cfgs()
    o = np.float32([[-0.4, 0, 0], [0.4, 0, 0]])
    dirs = np.float32([[0, 1, 0], [0, 1, 0]])
    tmin, tmax = full_window(2)
    calls = []
    real = tr._chunk_alpha_t

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tr, "_chunk_alpha_t", counting)
    try:
        rj, rt = trace_both(pj, pt, cj, ct, o, dirs, tmin, tmax, chunk=4, ray_block=2,
                            order="auto")
    finally:
        mp.undo()
    srt = np.sort(np.linalg.norm(np.float32(d["means"]) - o.mean(0), axis=-1))
    spread = np.linalg.norm(o - o.mean(0), axis=-1).mean()
    assert 0.1 * srt[1] < spread < 0.1 * np.median(srt)  # the two rules disagree here
    assert len(calls) == 1  # radial: one chunk, one sweep
    result_gate(rj, rt, "auto")


# ---- the estimators ---------------------------------------------------------------

def jax_uniforms(stream, seed, shape, device, pass_id=0, chunk_id=0):
    """The JAX module's draws of ``trace_uniforms``'s arguments."""
    if stream == tr.PASS_STREAM:
        key = jax.random.fold_in(jax.random.key(stream), jnp.asarray(seed, jnp.int32))
    else:
        key = jax.random.fold_in(jax.random.key(stream), jnp.asarray(seed, jnp.int32) * 131071
                                 + jnp.int32(pass_id) * 677 + jnp.int32(chunk_id))
    return torch.from_numpy(np.array(jax.random.uniform(key, shape))).to(device)


@pytest.mark.parametrize("stochastic, order", [("pass", "radial"), ("anyhit", "radial"),
                                               ("anyhit", "windowed")])
def test_estimators_with_the_jax_draws_match_jax(monkeypatch, stochastic, order):
    """With the JAX draws substituted, each estimator equals JAX's value for
    value (the any-hit draws are (ray_block, chunk) per pass and chunk, read
    by every ray block: 96 rays in three blocks of 32), and T is 0 or 1."""
    monkeypatch.setattr(tr, "trace_uniforms", jax_uniforms)
    pj, pt = both_prepared(interop.random_splat_arrays(12, 120, sh_degree=0,
                                                       scale_range=(-2.0, -1.0)))
    cj, ct = cfgs(rt=dict(max_passes=6))
    o, d = ray_batch(13, 96, spread=0.05, cone=0.3)
    tmin, tmax = full_window(96)
    rj, rt = trace_both(pj, pt, cj, ct, o, d, tmin, tmax, chunk=64, ray_block=32,
                        stochastic=stochastic, seed=5, order=order)
    result_gate(rj, rt, f"{stochastic} {order}")
    t = np_(rt.transmittance)
    assert np.isin(t, (0.0, 1.0)).all() and 0 < t.sum() < len(t)


def test_pass_estimator_unbiased():
    """tests/test_raytrace.py:270 with the port's draws: 300 samples of the
    pass estimator average to the deterministic integral."""
    _, pt = both_prepared(interop.random_splat_arrays(10, 150, sh_degree=0))
    _, ct = cfgs()
    o, d = (torch.from_numpy(a) for a in ray_batch(11, 64, spread=0.05, cone=0.2))
    tmin, tmax = torch.zeros(64), torch.full((64,), float("inf"))
    ref = tr.trace_splats(pt, o, d, tmin, tmax, ct, chunk=64, ray_block=64).radiance.numpy()
    acc = np.zeros_like(ref)
    for s in range(300):
        acc += tr.trace_splats(pt, o, d, tmin, tmax, ct, chunk=64, ray_block=64,
                               stochastic=True, seed=s).radiance.numpy()
    mean = acc / 300
    sig = max(float(ref.max()), 0.1)
    assert np.abs(mean - ref).mean() < 0.03 * sig
    assert np.abs(mean - ref).max() < 0.25 * sig


def test_anyhit_estimator_unbiased():
    """tests/test_raytrace.py:416 with the port's draws: 96 samples of the
    any-hit estimator within 0.15 of the deterministic blend's max."""
    _, pt = both_prepared(interop.random_splat_arrays(11, 120, sh_degree=0))
    _, ct = cfgs()
    o, d = (torch.from_numpy(a) for a in ray_batch(12, 32, spread=0.05, cone=0.3))
    tmin, tmax = torch.zeros(32), torch.full((32,), float("inf"))
    ref = tr.trace_splats(pt, o, d, tmin, tmax, ct, chunk=64, ray_block=32).radiance.numpy()
    acc = np.zeros(ref.shape, np.float64)
    for s in range(96):
        acc += tr.trace_splats(pt, o, d, tmin, tmax, ct, chunk=64, ray_block=32,
                               stochastic="anyhit", seed=s).radiance.numpy()
    err = np.abs(acc / 96 - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 0.15, err


# ---- gradients -------------------------------------------------------------------------

def grad_gate(got, want, label):
    """1e-4 of each row's max, and >= 99.9 % of each row within 1e-2 of
    (|ref| + the row's median nonzero |ref|)."""
    got, want = got.reshape(got.shape[0], -1).T, want.reshape(want.shape[0], -1).T
    for row, (g, w) in enumerate(zip(got, want)):
        scale = np.abs(w).max()
        diff = np.abs(g - w)
        assert diff.max() <= GRAD_RTOL * max(scale, 1e-12), (label, row, diff.max(), scale)
        nz = np.abs(w)[np.abs(w) > 0]
        typical = np.median(nz) if nz.size else 0.0
        assert (diff <= GRAD_ELEM * (np.abs(w) + typical)).mean() >= AGREE, (label, row)


def test_gradient_matches_jax_grad():
    """tests/test_raytrace.py:213: the gradient of sum(radiance^2) (plus the
    transmittance) in means and colours (rgb and opacity) against
    ``jax.grad``, finite and nonzero; cumprod's backward stays finite."""
    pj, pt = both_prepared(interop.random_splat_arrays(5, 100, sh_degree=0))
    cj, ct = cfgs()
    o, d = ray_batch(6, 32, spread=0.05, cone=0.2)
    tmin, tmax = full_window(32)

    def loss_j(means, color):
        s = dataclasses.replace(pj, means=means, color=color)
        res = jr.trace_splats(s, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                              jnp.asarray(tmax), cj, chunk=64, ray_block=32)
        return jnp.sum(res.radiance ** 2) + jnp.sum(res.transmittance)

    gj = jax.grad(loss_j, argnums=(0, 1))(pj.means, pj.color)
    means = pt.means.clone().requires_grad_()
    color = pt.color.clone().requires_grad_()
    s = dataclasses.replace(pt, means=means, color=color)
    res = tr.trace_splats(s, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmin),
                          torch.from_numpy(tmax), ct, chunk=64, ray_block=32)
    (torch.sum(res.radiance ** 2) + torch.sum(res.transmittance)).backward()
    for label, g, w in (("means", means.grad, gj[0]), ("color", color.grad, gj[1])):
        g = g.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, label
        grad_gate(g, np.asarray(w), label)


# ---- trace_mesh ------------------------------------------------------------------------

def mesh_both(pos, idx, o, d, tmin, **kw):
    mj = jr.trace_mesh(jnp.asarray(pos), jnp.asarray(idx), jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(tmin), **kw)
    mt = tr.trace_mesh(torch.from_numpy(pos), torch.from_numpy(idx), torch.from_numpy(o),
                       torch.from_numpy(d), torch.from_numpy(tmin), **kw)
    return mj, mt


def mesh_gate(mj, mt):
    fj, ft = np.asarray(mj.face), np_(mt.face)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(np_(mt.hit), np.asarray(mj.hit))
    tj, tt = np.asarray(mj.t), np_(mt.t)
    hit = np.isfinite(tj)
    np.testing.assert_array_equal(np.isfinite(tt), hit)
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=MESH_RTOL)


def test_trace_mesh_closest_hit_matches_jax():
    """tests/test_raytrace.py:93: two stacked triangles, the closer wins;
    t_min beyond it picks the far one."""
    pos = np.float32([[0, 0, 5], [4, 0, 5], [0, 4, 5], [0, 0, 3], [4, 0, 3], [0, 4, 3]])
    idx = np.int32([[0, 1, 2], [3, 4, 5]])
    o = np.float32([[1, 1, 0], [3.9, 3.9, 0]])
    d = np.float32([[0, 0, 1], [0, 0, 1]])
    for t0, face, t in ((0.0, 1, 3.0), (4.0, 0, 5.0)):
        mj, mt = mesh_both(pos, idx, o, d, np.full(2, t0, np.float32))
        mesh_gate(mj, mt)
        assert bool(mt.hit[0]) and not bool(mt.hit[1])
        assert int(mt.face[0]) == face and float(mt.t[0]) == pytest.approx(t)


def sphere_rays(seed, r):
    """Rays from a shell of radius 6 about the origin, aimed at points
    within 2.5 of it: most hit the sphere of radius 2, some miss."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(r, 3))
    o = 6.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(-2.5, 2.5, (r, 3))
    d = target - o
    return o.astype(np.float32), (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def every_face_hit(pos, idx, o, d, tmin):
    """(t, face) of the closest hit over every face at once, in float64:
    Moller-Trumbore with trace_mesh's tests, no face chunks and no skip."""
    v0, v1, v2 = (pos[idx[:, k]].astype(np.float64) for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    o, d = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    p = np.cross(d, e2[None])
    det = (p * e1[None]).sum(-1)
    inv = 1.0 / np.where(np.abs(det) < 1e-12, 1.0, det)
    tv = o - v0[None]
    u = (tv * p).sum(-1) * inv
    q = np.cross(tv, e1[None])
    v = (q * d).sum(-1) * inv
    t = (q * e2[None]).sum(-1) * inv
    ok = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin[:, None])
    t = np.where(ok, t, np.inf)
    face = np.where(np.isfinite(t.min(1)), t.argmin(1), -1)
    return t.min(1), face


def test_trace_mesh_sphere_matches_jax_and_every_face():
    """An octahedron sphere of 2048 faces (eight chunks of 256, Morton
    ordered) against 1000 rays in blocks of 256: against JAX, face ids
    equal and t within 1e-5; against a float64 sweep of every face (which
    skips no chunk), the same hits, face ids and t within 1e-5."""
    sphere = octa_sphere(4, 2.0)
    pos, idx = np.asarray(sphere.positions, np.float32), np.asarray(sphere.indices, np.int32)
    o, d = sphere_rays(9, 1000)
    tmin = np.full(1000, 1e-3, np.float32)
    mj, mt = mesh_both(pos, idx, o, d, tmin, chunk=256, ray_block=256)
    mesh_gate(mj, mt)
    hits = np_(mt.hit)
    assert 0.3 < hits.mean() < 0.95
    t64, f64 = every_face_hit(pos, idx, o, d, tmin)
    np.testing.assert_array_equal(np_(mt.face), f64)
    np.testing.assert_allclose(np_(mt.t)[hits], t64[hits], rtol=MESH_RTOL)
    # rays starting inside the sphere hit its far side
    inner = tr.trace_mesh(torch.from_numpy(pos), torch.from_numpy(idx), torch.zeros((3, 3)),
                          torch.eye(3), torch.zeros(3), chunk=256)
    assert bool(inner.hit.all())
    np.testing.assert_allclose(inner.t.numpy(), 2.0, rtol=2e-2)


def mirror_quad():
    """tests/test_raytrace.py's mirror floor: two faces at y = -2."""
    pos = np.float32([[-6, -2, -6], [6, -2, -6], [6, -2, 6], [-6, -2, 6]])
    return pos, np.int32([[0, 1, 2], [0, 2, 3]])


def test_trace_mesh_mirror_quad_matches_jax():
    pos, idx = mirror_quad()
    rng = np.random.default_rng(3)
    o = (np.float32([0, 0.5, -7]) + 0.2 * rng.normal(size=(300, 3))).astype(np.float32)
    d = np.float32([0, -0.3, 1]) + 0.3 * rng.normal(size=(300, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mj, mt = mesh_both(pos, idx, o, d, np.full(300, 1e-3, np.float32))
    mesh_gate(mj, mt)
    assert np_(mt.hit).any() and not np_(mt.hit).all()


# ---- reflect, refract ------------------------------------------------------------------

def test_reflect_and_refract_match_jax():
    """tests/test_raytrace.py:109: normal incidence passes straight
    through, Snell's law entering the medium, total internal reflection
    exiting at a grazing angle; and a random batch against JAX."""
    n = torch.tensor([[0.0, 0.0, -1.0]])
    ior = torch.tensor([1.5])
    np.testing.assert_allclose(tr.refract_or_reflect(torch.tensor([[0.0, 0.0, 1.0]]), n,
                                                     ior).numpy(), [[0, 0, 1]], atol=1e-6)
    th = 0.7
    d1 = tr.refract_or_reflect(torch.tensor([[np.sin(th), 0.0, np.cos(th)]],
                                            dtype=torch.float32), n, ior).numpy()[0]
    assert d1[0] == pytest.approx(np.sin(th) / 1.5, abs=1e-6)
    th2 = 1.2  # sin(1.2) * 1.5 > 1: total internal reflection
    d2 = tr.refract_or_reflect(torch.tensor([[np.sin(th2), 0.0, -np.cos(th2)]],
                                            dtype=torch.float32), n, ior).numpy()[0]
    np.testing.assert_allclose(d2, [np.sin(th2), 0.0, np.cos(th2)], atol=1e-6)

    rng = np.random.default_rng(4)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nn = rng.normal(size=(500, 3)).astype(np.float32)
    nn /= np.linalg.norm(nn, axis=-1, keepdims=True)
    eta = rng.uniform(1.0, 2.4, 500).astype(np.float32)
    got = tr.refract_or_reflect(torch.from_numpy(d), torch.from_numpy(nn), torch.from_numpy(eta))
    want = jr.refract_or_reflect(jnp.asarray(d), jnp.asarray(nn), jnp.asarray(eta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tr.reflect(torch.from_numpy(d), torch.from_numpy(nn)).numpy(),
                               np.asarray(jr.reflect(jnp.asarray(d), jnp.asarray(nn))),
                               atol=1e-6)


# ---- batching ----------------------------------------------------------------------------

def test_results_do_not_depend_on_the_batch_cap(monkeypatch):
    """One ray block per sweep step against every block in one step:
    trace_splats (windowed, any-hit: the draws' reuse across blocks) and
    trace_mesh (the per-block chunk skip) give the same bits."""
    _, pt = both_prepared(interop.random_splat_arrays(12, 120, sh_degree=0))
    _, ct = cfgs(rt=dict(max_passes=4))
    o, d = (torch.from_numpy(a) for a in ray_batch(13, 96, spread=0.05, cone=0.3))
    tmin, tmax = torch.zeros(96), torch.full((96,), float("inf"))
    sphere = octa_sphere(3, 2.0)
    pos = torch.from_numpy(np.asarray(sphere.positions, np.float32))
    idx = torch.from_numpy(np.asarray(sphere.indices, np.int32))
    mo, md = (torch.from_numpy(a) for a in sphere_rays(9, 96))

    def run():
        a = tr.trace_splats(pt, o, d, tmin, tmax, ct, chunk=64, ray_block=16,
                            stochastic="anyhit", seed=3, order="windowed")
        m = tr.trace_mesh(pos, idx, mo, md, torch.full((96,), 1e-3), chunk=64, ray_block=16)
        return [a.radiance, a.transmittance, a.depth, m.t, m.face]

    wide = run()
    monkeypatch.setattr(tr, "BATCH_BYTES", 1)  # one block per step
    narrow = run()
    assert tr._ray_batches(96, 16, 64)[0] == slice(0, 16)
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)
