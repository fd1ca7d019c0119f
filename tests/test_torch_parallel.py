"""The port's multi-device rendering (parallel/sharded_render.py,
parallel/distributed.py) against the JAX package's shard_map functions and
the port's single-device frames, on the CPU.

The port's ranks are real processes joined by gloo on the loopback
(tests/torch_parallel_worker.py, one process per rank), at world size 2
(two bands of 4 tile rows) and 3 (bands of 3, 3 and 2 tile rows: the last
band's padding is cropped). The JAX functions run in this process on
``make_mesh(2)`` of the 8 virtual CPU devices (tests/conftest.py). Gates:
frames within 3e-5 absolute and 1e-4 relative of the JAX sharded frame and
of the port's single-device frame (tests/test_sharded.py's); the loss
within 1e-5 relative of JAX's; gradients and updates within 3e-5 of each
field's largest magnitude. Every subprocess has a 120 s timeout and every
collective a 60 s one (the worker's ``TIMEOUT_S``), so a hung rank fails.
"""

import json
import os
import re
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from vk_gaussian_splatting_tpu.config import RenderConfig as JaxRenderConfig
from vk_gaussian_splatting_tpu.parallel import make_mesh as jax_make_mesh
from vk_gaussian_splatting_tpu.parallel import render_3dgs_sharded as jax_render_3dgs_sharded
from vk_gaussian_splatting_tpu.parallel import train_step_sharded as jax_train_step_sharded
from vk_gaussian_splatting_tpu.scene.cameras import look_at as jax_look_at
from vk_gaussian_splatting_tpu.scene.splat_set import SplatSet as JaxSplatSet
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.parallel.sharded_render import band_span
from vk_gaussian_splatting_tpu_torch.render import render_3dgrt, render_3dgs, render_3dgut

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
ATOL, RTOL = 3e-5, 1e-4
GRAD_TOL = 3e-5
FIELDS = interop.SPLAT_FIELDS


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _start_ranks(world, out, *extra):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_parallel_worker.py"),
         "--rank", str(r), "--world", str(world), "--port", str(port), "--out", str(out),
         *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(), text=True)
        for r in range(world)]


def _finish(procs):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _jax_splats(d):
    return JaxSplatSet(**{k: jnp.asarray(v) for k, v in d.items()})


def _jax_cfg(method):
    cfg = w.config(method)
    return JaxRenderConfig(width=cfg.width, height=cfg.height, sh_degree=cfg.sh_degree,
                           raster=type(JaxRenderConfig().raster)(
                               method=cfg.raster.method, bucket_caps=cfg.raster.bucket_caps))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks at world sizes 2 (everything) and 3 (the 3DGS frames
    on 255 splats), started first; the JAX sharded frames and step computed
    while they run."""
    out2, out3 = tmp_path_factory.mktemp("world2"), tmp_path_factory.mktemp("world3")
    procs2 = _start_ranks(2, out2, "--full")
    procs3 = _start_ranks(3, out3, "--n", "255")
    try:
        splats = _jax_splats(w.scene_arrays())
        cam = jax_look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], w.WIDTH, w.HEIGHT)
        mesh = jax_make_mesh(2)
        jax_frames = {m: [np.asarray(x) for x in jax_render_3dgs_sharded(
            splats, cam, _jax_cfg(m), w.MAX_PAIRS, mesh)] for m in ("pairs", "bucket")}
        new, loss = jax_train_step_sharded(splats, cam, jnp.zeros((w.HEIGHT, w.WIDTH, 3)),
                                           _jax_cfg("pairs"), w.MAX_PAIRS, mesh, lr=w.LR)
        jax_step = ({f: np.asarray(getattr(new, f)) for f in FIELDS}, float(loss))
    finally:
        _finish(procs2)
        _finish(procs3)
    ranks = {world: [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]
             for world, out in ((2, out2), (3, out3))}
    return ranks, jax_frames, jax_step


def _bands(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def _single(fn, method, n=None, arrays=None):
    prepared = interop.splat_set_from_numpy(arrays or w.scene_arrays(n=n), "cpu").prepare()
    return fn(prepared, w.camera(), w.config(method), w.MAX_PAIRS)


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_sharded_3dgs_matches_jax_and_single_device(runs, method):
    ranks, jax_frames, _ = runs
    img, trans = _bands(ranks[2], f"{method}_img"), _bands(ranks[2], f"{method}_trans")
    assert [r[f"{method}_img"].shape[0] for r in ranks[2]] == [64, 64]
    j_img, j_trans, j_ov = jax_frames[method]
    np.testing.assert_allclose(img, j_img, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(trans, j_trans, atol=ATOL, rtol=RTOL)
    ref = _single(render_3dgs, method)
    np.testing.assert_allclose(img, ref.image.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(trans, ref.transmittance.numpy(), atol=ATOL, rtol=RTOL)
    assert trans.min() < 0.9  # non-vacuous
    assert [bool(r[f"{method}_ov"]) for r in ranks[2]] == [bool(j_ov)] * 2 == [False] * 2


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_sharded_3dgs_pads_the_last_band(runs, method):
    """Three ranks over 8 tile rows: bands of 48, 48 and 32 rows (the last
    band's padding cropped), equal to the single-device frame."""
    ranks = runs[0][3]
    assert [r[f"{method}_img"].shape[0] for r in ranks] == [48, 48, 32]
    assert [band_span(w.config(), b, 3) for b in range(3)] == [(0, 48), (48, 96), (96, 128)]
    ref = _single(render_3dgs, method, n=255)
    np.testing.assert_allclose(_bands(ranks, f"{method}_img"), ref.image.numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_bands(ranks, f"{method}_trans"), ref.transmittance.numpy(),
                               atol=ATOL, rtol=RTOL)


def test_band_span_past_the_image():
    """Four bands over 2 tile rows: one row of tiles each for the first two,
    nothing for the rest."""
    cfg = w.config().replace(height=32)
    assert [band_span(cfg, b, 4) for b in range(4)] == [(0, 16), (16, 32), (32, 32), (32, 32)]


@pytest.mark.parametrize("name", ["gut-pairs", "gut-bucket", "grt-pairs", "grt-bucket"])
def test_sharded_gut_and_grt_match_single_device(runs, name):
    ranks = runs[0][2]
    kind, method = name.split("-")
    ref = _single({"gut": render_3dgut, "grt": render_3dgrt}[kind], method)
    key = f"{kind}_{method}"
    np.testing.assert_allclose(_bands(ranks, key + "_img"), ref.image.numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_bands(ranks, key + "_trans"), ref.transmittance.numpy(),
                               atol=ATOL, rtol=RTOL)
    assert ref.transmittance.min() < 0.9


def test_sharded_bucket_overflow_propagates(runs):
    """A band whose fine window exceeds the cap flips every rank's flag."""
    ranks = runs[0][2]
    assert [bool(r["ov_small"]) for r in ranks] == [True, True]
    assert [bool(r["ov_big"]) for r in ranks] == [False, False]


def test_refusals(runs):
    """A mesh of another size than the group, leading dims that do not
    divide the mesh, a target band of the wrong height: ValueError."""
    for r in runs[0][2]:
        assert r["refusals"].tolist() == [True, True, True]


def test_train_step_matches_jax(runs):
    ranks, _, (jax_new, jax_loss) = runs
    start = w.scene_arrays()
    for r in ranks[2]:
        assert abs(float(r["pairs_step_loss"]) - jax_loss) <= 1e-5 * abs(jax_loss)
    for f in FIELDS:
        got = _bands(ranks[2], f"pairs_step_{f}")
        np.testing.assert_allclose(got, jax_new[f], atol=1e-6, err_msg=f)
        step, jstep = got - start[f], jax_new[f] - start[f]
        scale = np.abs(jstep).max() + 1e-12
        assert np.abs(step - jstep).max() <= GRAD_TOL * scale + 1e-7, f


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_sharded_gradient_equals_single_device(runs, method):
    """lr = 1: the step is the gradient, gathered from the ranks' shards
    through the all-gather's reduce-scatter, against autograd of the
    single-device frame's loss."""
    ranks = runs[0][2]
    start = w.scene_arrays()
    splats = interop.splat_set_from_numpy(start, "cpu")
    for f in FIELDS:
        getattr(splats, f).requires_grad_(True)
    img = render_3dgs(splats.prepare(), w.camera(), w.config(method), w.MAX_PAIRS).image
    torch.sum(img ** 2).backward()
    for f in FIELDS:
        g_sh = start[f] - _bands(ranks, f"{method}_grad_{f}")
        g = getattr(splats, f).grad.numpy()
        scale = np.abs(g).max() + 1e-12
        assert scale > 1e-6 or f == "sh_rest", f
        assert np.abs(g_sh - g).max() <= GRAD_TOL * scale + 1e-7, (f, np.abs(g_sh - g).max(),
                                                                    scale)


def test_two_process_distributed_main():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vk_gaussian_splatting_tpu_torch.parallel.distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r),
         "--platform", "cpu", "--splats", "128", "--steps", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(), text=True)
        for r in range(2)]
    stats = []
    for out in _finish(procs):
        m = re.search(r"MULTIHOST_OK process=\d+ (\{.*\})", out)
        assert m, out[-2000:]
        stats.append(json.loads(m.group(1)))
    assert stats[0]["num_processes"] == 2 and stats[0]["num_devices"] == 2
    assert stats[0]["losses"] == stats[1]["losses"]
    assert all(np.isfinite(stats[0]["losses"]))
    assert stats[0]["collective_bytes_per_step"] > 0
