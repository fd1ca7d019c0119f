"""The port's viewers (viewer.py, viewer_web.py) against the JAX
package's, on the CPU.

The orbit cameras must be equal; the orbit viewer's frames within the
flip-aware render gate of tests/test_torch_render.py (>= 99.9 % of
channels within 5e-5, none beyond 1.2e-2) of the JAX viewer's, each PNG
written equal to the 8-bit image of the port's own frame. The web viewer
is served on 127.0.0.1, port 0, in a thread: it answers the page and
three frames (3DGS rgb, 3DGUT depth, 3DGRT transmittance), each PNG equal
to ``RenderSession.render`` quantised. Both PNG writers (Pillow's and the
stdlib one that runs where Pillow is absent) decode to the same pixels.
Each request has a 60 s timeout.
"""

import io
import re
import struct
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from vk_gaussian_splatting_tpu import viewer as jax_viewer
from vk_gaussian_splatting_tpu import viewer_web as jax_viewer_web
from vk_gaussian_splatting_tpu.io import load_scene as jax_load_scene
import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch import interop, viewer, viewer_web
from vk_gaussian_splatting_tpu_torch.io import load_scene, save_ply
from vk_gaussian_splatting_tpu_torch.render import render

torch.set_num_threads(2)

W, H = 64, 48
IMG_ATOL, IMG_SHARE, IMG_MAX = 5e-5, 0.999, 1.2e-2
TIMEOUT_S = 60


def _gate(got, want):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff <= IMG_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG_MAX, diff.max()


def _u8(img):
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _decode_stdlib(data: bytes) -> np.ndarray:
    """The stdlib writer's PNG (one IDAT, filter 0 on every row) by zlib."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    raw = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    path = tmp_path_factory.mktemp("scene") / "scene.ply"
    d = interop.random_splat_arrays(3, 400, sh_degree=1, scale_range=(-3.0, -1.5))
    save_ply(str(path), interop.splat_set_from_numpy(d, "cpu"))
    return str(path)


@pytest.mark.parametrize("az,el", [(0.0, 0.3), (1.3, -0.4), (4.0, 1.2)])
def test_orbit_camera_equals_jax(az, el):
    center = np.asarray([0.1, -0.2, 0.3])
    cam = viewer.orbit_camera(center, 5.0, az, el, W, H, device="cpu")
    jcam = jax_viewer.orbit_camera(center, 5.0, az, el, W, H)
    for f in ("viewmat", "fx", "fy", "cx", "cy", "near", "far"):
        np.testing.assert_array_equal(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)))


def test_orbit_viewer_matches_jax(ply, tmp_path, capsys):
    args = [ply, "--frames", "2", "--size", str(W), str(H), "--shdegree", "1"]
    viewer.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    jax_viewer.main(args + ["-o", str(tmp_path / "jax")])
    theirs = capsys.readouterr().out.splitlines()
    assert [s.replace("/port/", "/jax/") for s in ours] == theirs
    assert re.fullmatch(r".*/frame_000\.png  \(pairs \d+, overflow False\)", ours[0])

    splats = load_scene(ply, device="cpu")
    prepared = splats.prepare()
    jprepared = jax_load_scene(ply).prepare()
    means = prepared.means.numpy()
    center = means.mean(axis=0)
    radius = 4.0 * max(float(np.abs(means - center).mean()), 1e-3)
    cfg = gt.RenderConfig(width=W, height=H, sh_degree=1)
    from vk_gaussian_splatting_tpu.config import RenderConfig as JaxRenderConfig
    from vk_gaussian_splatting_tpu.render import render as jax_render
    for i in range(2):
        az = 2 * np.pi * i / 2
        frame = render(prepared, viewer.orbit_camera(center, radius, az, 0.3, W, H,
                                                     device="cpu"), cfg).image.numpy()
        jframe = jax_render(jprepared, jax_viewer.orbit_camera(center, radius, az, 0.3, W, H),
                            JaxRenderConfig(width=W, height=H, sh_degree=1)).image
        _gate(frame, jframe)
        png = (tmp_path / "port" / f"frame_{i:03d}.png").read_bytes()
        np.testing.assert_array_equal(_decode(png), _u8(frame))
        assert frame.std() > 0.01


def test_save_png_without_pillow(tmp_path, monkeypatch):
    img = np.random.default_rng(1).uniform(-0.2, 1.2, (7, 5, 3)).astype(np.float32)
    monkeypatch.setitem(sys.modules, "PIL", None)
    viewer.save_png(str(tmp_path / "a.png"), torch.from_numpy(img))
    data = (tmp_path / "a.png").read_bytes()
    np.testing.assert_array_equal(_decode_stdlib(data), _u8(img))


@pytest.mark.parametrize("shape", [(48, 64), (5, 7), (1, 1)])
def test_png_branches_decode_equal(shape, monkeypatch):
    img = np.random.default_rng(2).uniform(0, 1, (*shape, 3)).astype(np.float32)
    with_pillow = viewer_web.encode_png(img)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        stdlib = viewer_web.encode_png(img)
        jax_stdlib = jax_viewer_web.encode_png(img)
    assert stdlib != with_pillow
    want = (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(_decode(with_pillow), want)
    np.testing.assert_array_equal(_decode(stdlib), want)
    np.testing.assert_array_equal(_decode_stdlib(stdlib), want)
    assert jax_stdlib == stdlib  # the JAX package's stdlib writer: the same bytes


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_web_viewer_serves_page_and_frames(ply):
    splats = load_scene(ply, device="cpu")
    means = splats.means.numpy()
    center = means.mean(axis=0)
    radius = float(np.linalg.norm(means - center, axis=1).mean())
    httpd = viewer_web.serve(splats.prepare(), center, radius, port=0, host="127.0.0.1",
                             width=W, height=H, max_pairs=1 << 16)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        code, ctype, body = _get(base + "/")
        assert code == 200 and ctype == "text/html"
        assert f"r={radius * 2.2:.3f}" in body.decode() and "%RADIUS%" not in body.decode()
        session = httpd.RequestHandlerClass.session
        for q in (dict(pipeline=1, mode="rgb"), dict(pipeline=4, mode="depth"),
                  dict(pipeline=2, mode="trans")):
            query = "&".join(f"{k}={v}" for k, v in dict(az=0.4, el=0.2, r=6.0, sh=1,
                                                         **q).items())
            code, ctype, body = _get(f"{base}/frame.png?{query}")
            assert code == 200 and ctype == "image/png", body[:200]
            want = session.render(0.4, 0.2, 6.0, sh=1, **q)
            np.testing.assert_array_equal(_decode(body), (want * 255).astype(np.uint8))
            assert want.std() > 0.01
        code, ctype, body = _get(base + "/frame.png?pipeline=9")
        assert code == 500 and b"error" in body
        assert _get(base + "/nope")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=TIMEOUT_S)
    assert not thread.is_alive()


def test_render_session_matches_jax(ply):
    """RenderSession's rgb and depth frames against the JAX session's."""
    splats = load_scene(ply, device="cpu")
    means = splats.means.numpy()
    center = means.mean(axis=0)
    ours = viewer_web.RenderSession(splats.prepare(), center, 2.0, W, H, 1 << 16)
    theirs = jax_viewer_web.RenderSession(jax_load_scene(ply).prepare(), center, 2.0, W, H,
                                          1 << 16)
    for mode in ("rgb", "depth", "trans"):
        _gate(ours.render(0.7, 0.1, 6.0, sh=1, mode=mode),
              theirs.render(0.7, 0.1, 6.0, sh=1, mode=mode))
