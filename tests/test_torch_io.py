"""The port's IO (vk_gaussian_splatting_tpu_torch/io, native.py) against the
JAX package's, on seeded numpy scenes and on files each package wrote.

Tolerances, each with its reason:
- PLY: exact, both ways and on both readers (native and numpy): every
  value is an f32 copied or sign-flipped; the two writers' files are equal
  byte for byte.
- spz and .splat: each package's decode of one file equal bit for bit to
  the other's (the same numpy operations on the same bytes); the files
  each package writes decode alike; against the scene written, within the
  formats' quantisation (stated per field below).
- cameras.json: 1e-6 against the JAX cameras (both round a float64 view
  matrix to f32 once).
- the host sorter: its order equal to the JAX sorter's, index for index;
  ``radix_argsort_f32`` equal to numpy's stable argsort on ties and
  positive NaNs, and to the stable argsort of the radix's order-preserving
  keys where signed zeros and negative NaNs differ from numpy's order.

No JAX program is compiled here: the JAX IO is numpy.
"""

import json
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vk_gaussian_splatting_tpu.io import import_cameras_inria as j_cameras
from vk_gaussian_splatting_tpu.io import load_ply as j_load_ply
from vk_gaussian_splatting_tpu.io import load_splat_file as j_load_splat
from vk_gaussian_splatting_tpu.io import load_spz as j_load_spz
from vk_gaussian_splatting_tpu.io import save_ply as j_save_ply
from vk_gaussian_splatting_tpu.io import save_splat_file as j_save_splat
from vk_gaussian_splatting_tpu.io import save_spz as j_save_spz
from vk_gaussian_splatting_tpu.io.async_loader import AsyncHostSorter as JSorter
from vk_gaussian_splatting_tpu.scene import splat_set as jss
from vk_gaussian_splatting_tpu_torch import interop, native
from vk_gaussian_splatting_tpu_torch.io import (
    import_cameras_inria,
    load_ply,
    load_scene,
    load_splat_file,
    load_spz,
    save_ply,
    save_splat_file,
    save_spz,
)
from vk_gaussian_splatting_tpu_torch.io import async_loader
from vk_gaussian_splatting_tpu_torch.io import ply as tply
from vk_gaussian_splatting_tpu_torch.io.async_loader import (
    AsyncHostSorter,
    AsyncSceneLoader,
    LoadStatus,
    sort_order,
)

FIELDS = interop.SPLAT_FIELDS


def scene(n=300, sh_degree=2, seed=0):
    """Seeded numpy splats, quaternions unit (as trained scenes hold them)."""
    d = interop.random_splat_arrays(seed, n, sh_degree=sh_degree, scale_range=(-4.0, -1.0))
    d["quats"] /= np.linalg.norm(d["quats"], axis=1, keepdims=True)
    return d


def to_jax(d):
    return jss.SplatSet(**{k: np.asarray(v) for k, v in d.items()})


def to_port(d):
    return interop.splat_set_from_numpy(d, "cpu")


def arrays_of(s):
    """A SplatSet of either package as a dict of numpy arrays."""
    return {f: np.asarray(getattr(s, f).numpy() if isinstance(getattr(s, f), torch.Tensor)
                          else getattr(s, f)) for f in FIELDS}


def assert_equal_arrays(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("no C++ compiler: the native library did not build")


# ---- PLY ------------------------------------------------------------------

@pytest.mark.parametrize("reader", ["native", "numpy"])
def test_jax_ply_read_by_port(tmp_path, monkeypatch, reader):
    d = scene(sh_degree=3)
    path = str(tmp_path / "jax.ply")
    j_save_ply(path, to_jax(d))
    if reader == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ compiler: the native library did not build")
    got = arrays_of(load_ply(path, device="cpu"))
    assert_equal_arrays(got, d)
    assert_equal_arrays(got, arrays_of(j_load_ply(path)))
    raw = arrays_of(load_ply(path, to_rub=False, device="cpu"))
    np.testing.assert_array_equal(raw["means"][:, 1:], -d["means"][:, 1:])


def test_port_ply_read_by_jax(tmp_path):
    d = scene(sh_degree=1)
    ours, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    save_ply(ours, to_port(d))
    j_save_ply(theirs, to_jax(d))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert_equal_arrays(arrays_of(j_load_ply(ours)), d)


def test_ply_reordered_groups_take_the_numpy_reader(tmp_path, native_lib, monkeypatch):
    """A scale group split by the opacity property: the native extractor
    copies each group as one run, so such a file must take the numpy reader
    (tests/test_io.py's case), and reads as the JAX package reads it."""
    d = scene(n=64, sh_degree=0)
    names = ["x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "scale_0", "opacity", "scale_1",
             "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    assert not tply._groups_contiguous(names)
    cols = {"x": d["means"][:, 0], "y": d["means"][:, 1], "z": d["means"][:, 2],
            "opacity": d["opacities"]}
    cols.update({f"f_dc_{i}": d["sh_dc"][:, i] for i in range(3)})
    cols.update({f"scale_{i}": d["scales"][:, i] for i in range(3)})
    cols.update({f"rot_{i}": d["quats"][:, i] for i in range(4)})
    rec = np.zeros(64, dtype=np.dtype([(nm, "<f4") for nm in names]))
    for nm in names:
        rec[nm] = cols[nm]
    path = str(tmp_path / "reordered.ply")
    header = ["ply", "format binary_little_endian 1.0", "element vertex 64"]
    header += [f"property float {nm}" for nm in names] + ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        rec.tofile(f)
    calls = []
    monkeypatch.setattr(native, "ply_extract_3dgs", lambda *a: calls.append(a))
    got = arrays_of(load_ply(path, to_rub=False, device="cpu"))
    assert not calls
    assert_equal_arrays(got, arrays_of(j_load_ply(path, to_rub=False)))
    np.testing.assert_array_equal(got["scales"], d["scales"])


# ---- spz and .splat --------------------------------------------------------

# (loader, saver) of each package, and the largest quantisation error of each
# field against the scene written: spz positions 2^-13 (12 fractional bits),
# log scales 1/32 (u8 steps of 1/16), colours 0.5 / 255 / 0.15, SH 0.5 / 128,
# quaternion components sqrt(1/2) / 511 / 2 and the largest one's square
# root of the others (up to about 3e-3); .splat: f32 positions, exp / log
# scales (a few ulp), colours 0.5 / 255 / SH_C0, quaternion components 1/256
# (1/128 for a component that rounds to 256 and clips at 255); both: alpha
# 0.5 / 255
FORMATS = {
    "spz": (load_spz, save_spz, j_load_spz, j_save_spz,
            dict(means=2.0 ** -13, scales=1 / 32 + 1e-6, sh_dc=0.5 / 255 / 0.15 + 1e-6,
                 sh_rest=0.5 / 128 + 1e-6, quats=4e-3)),
    "splat": (load_splat_file, save_splat_file, j_load_splat, j_save_splat,
              dict(means=0.0, scales=2e-6, sh_dc=0.5 / 255 / jss.SH_C0 + 1e-6, quats=8e-3)),
}


def quantised_scene(fmt):
    """A scene the format can hold: spz positions within its fixed point,
    colours inside the u8 range, SH to degree 3 (spz) or 0 (.splat)."""
    d = scene(n=400, sh_degree=3 if fmt == "spz" else 0)
    d["sh_dc"] = np.clip(d["sh_dc"], -1.7, 1.7)
    return d


def sign_canonical(q):
    """The quaternion with its largest component positive, as spz stores it
    (q and -q are one rotation)."""
    big = np.take_along_axis(q, np.abs(q).argmax(axis=1)[:, None], axis=1)
    return q * np.where(big < 0, -1.0, 1.0)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_format_round_trips_against_jax(tmp_path, fmt):
    load_t, save_t, load_j, save_j, tol = FORMATS[fmt]
    d = quantised_scene(fmt)
    ours, theirs = str(tmp_path / f"port.{fmt}"), str(tmp_path / f"jax.{fmt}")
    save_t(ours, to_port(d))
    save_j(theirs, to_jax(d))
    for path in (ours, theirs):
        assert_equal_arrays(arrays_of(load_t(path, device="cpu")), arrays_of(load_j(path)))
    a, b = arrays_of(load_t(ours, device="cpu")), arrays_of(load_t(theirs, device="cpu"))
    assert_equal_arrays(a, b)
    if fmt == "splat":
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    for f, atol in tol.items():
        want = sign_canonical(d[f]) if f == "quats" and fmt == "spz" else d[f]
        np.testing.assert_allclose(a[f], want, rtol=0, atol=atol, err_msg=f)
    alpha = 1 / (1 + np.exp(-a["opacities"]))
    np.testing.assert_allclose(alpha, 1 / (1 + np.exp(-d["opacities"])), atol=0.5 / 255 + 1e-6)


def test_spz_header_and_fractional_bits(tmp_path):
    """The v3 header, and positions at another ``frac_bits`` read back at
    its step."""
    d = quantised_scene("spz")
    path = str(tmp_path / "s.spz")
    save_spz(path, to_port(d), frac_bits=8)
    import gzip
    with gzip.open(path, "rb") as f:
        head = struct.unpack_from("<IIIBBBB", f.read(16), 0)
    assert head[:5] == (0x5053474E, 3, 400, 3, 8)
    got = load_spz(path, device="cpu")
    np.testing.assert_allclose(got.means.numpy(), d["means"], rtol=0, atol=2.0 ** -9)
    assert_equal_arrays(arrays_of(got), arrays_of(j_load_spz(path)))


# ---- cameras.json ----------------------------------------------------------

def test_import_cameras_inria_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    items = []
    for i in range(5):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        items.append(dict(id=i, img_name=f"view{i}", width=800 + 10 * i, height=600,
                          position=rng.normal(size=3).tolist(), rotation=q.tolist(),
                          fx=700.0 + i, fy=710.0 - i))
    items[4].pop("img_name")
    path = str(tmp_path / "cameras.json")
    json.dump(items, open(path, "w"))
    for to_rub in (True, False):
        ours = import_cameras_inria(path, to_rub=to_rub, device="cpu")
        theirs = j_cameras(path, to_rub=to_rub)
        assert [n for n, _ in ours] == [n for n, _ in theirs] == [
            "view0", "view1", "view2", "view3", "4"]
        for (_, ct), (_, cj) in zip(ours, theirs):
            for k, v in interop.camera_to_numpy(ct).items():
                np.testing.assert_allclose(v, np.asarray(getattr(cj, k)), rtol=0, atol=1e-6,
                                           err_msg=k)


# ---- load_scene --------------------------------------------------------------

def test_load_scene_dispatches_each_suffix(tmp_path):
    d = quantised_scene("spz")
    paths = {}
    for ext, save in ((".ply", save_ply), (".spz", save_spz), (".splat", save_splat_file)):
        paths[ext] = str(tmp_path / f"scene{ext.upper()}")
        save(paths[ext], to_port(d))
    loaders = {".ply": load_ply, ".spz": load_spz, ".splat": load_splat_file}
    for ext, path in paths.items():
        assert_equal_arrays(arrays_of(load_scene(path, device="cpu")),
                            arrays_of(loaders[ext](path, device="cpu")))
    for bad in ("scene.xyz", "scene.obj", "scene"):
        with pytest.raises(ValueError, match="unsupported"):
            load_scene(str(tmp_path / bad), device="cpu")


# ---- the async loader and the host sorter -----------------------------------

def wait_while_loading(loader, polls=400):
    for _ in range(polls):
        if loader.get_status()[0] != LoadStatus.LOADING:
            return
        time.sleep(0.02)


def test_async_loader_ready_failure_and_cancel(tmp_path, monkeypatch):
    """tests/test_project_async.py:81-106's protocol: a load becomes READY
    and is consumed once; a missing file surfaces its exception on
    consume; a cancelled load ends CANCELLED and yields nothing."""
    path = str(tmp_path / "s.ply")
    save_ply(path, to_port(scene(n=500, sh_degree=1)))
    loader = AsyncSceneLoader(device="cpu")
    assert loader.load_scene(path)
    wait_while_loading(loader)
    assert loader.get_status() == (LoadStatus.READY, 1.0)
    got = loader.consume()
    assert got is not None and got.num_splats == 500 and got.means.device.type == "cpu"
    assert loader.consume() is None and loader.get_status()[0] == LoadStatus.IDLE

    loader.load_scene(str(tmp_path / "missing.ply"))
    wait_while_loading(loader)
    with pytest.raises(FileNotFoundError):
        loader.consume()
    assert loader.get_status()[0] == LoadStatus.IDLE

    import vk_gaussian_splatting_tpu_torch.io as tio
    fast = tio.load_scene
    monkeypatch.setattr(tio, "load_scene", lambda *a, **kw: (time.sleep(0.3), fast(*a, **kw))[1])
    assert loader.load_scene(path)
    assert not loader.load_scene(path)  # one load at a time
    loader.cancel()
    wait_while_loading(loader)
    assert loader.get_status()[0] == LoadStatus.CANCELLED
    assert loader.consume() is None


def consume_when_ready(sorter, polls=500):
    for _ in range(polls):
        res = sorter.consume()
        if res is not None:
            return res
        time.sleep(0.01)
    raise AssertionError("the sort never finished")


def test_host_sorter_matches_jax_and_restarts_lazily(monkeypatch):
    d = scene(n=20000, sh_degree=0, seed=3)
    dirs = [np.array([0.1, -0.2, 0.97]), np.array([0.6, 0.0, -0.8]), np.array([0, 1.0, 0])]
    ours, theirs = AsyncHostSorter(torch.from_numpy(d["means"])), JSorter(d["means"])
    for s in (ours, theirs):
        s.sort_async(dirs[0])
    order, vd = consume_when_ready(ours)
    order_j, _ = consume_when_ready(theirs)
    assert order.dtype == np.int32 and np.array_equal(vd, dirs[0])
    np.testing.assert_array_equal(order, order_j)
    dist = d["means"] @ dirs[0].astype(np.float32)
    assert (np.diff(dist[order]) >= 0).all()
    # two requests while a slow sort runs: the newer replaces the older, and
    # starts once the running sort ends; join waits for it
    sorted_dirs = []

    def slow(means, view_dir):
        sorted_dirs.append(view_dir)
        time.sleep(0.3)
        return sort_order(means, view_dir)

    monkeypatch.setattr(async_loader, "sort_order", slow)
    ours.sort_async(dirs[1])
    ours.sort_async(dirs[2])
    ours.sort_async(dirs[0])
    ours.join()
    assert [list(v) for v in sorted_dirs] == [list(dirs[1]), list(dirs[0])]
    last, vd = ours.consume()
    assert np.array_equal(vd, dirs[0])
    np.testing.assert_array_equal(last, order_j)
    assert ours.consume() is None


def test_host_sorter_under_concurrent_requests():
    """Requests from four threads at a short switch interval: after join no
    sort runs, the order consumed is the one of a requested direction, and
    it is that direction's sort."""
    means = scene(n=3000, sh_degree=0, seed=6)["means"]
    sorter = AsyncHostSorter(means)
    dirs = np.random.default_rng(1).normal(size=(4, 20, 3))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [sorter.sort_async(v) for v in dirs[k]])
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        sorter.join()
    finally:
        sys.setswitchinterval(interval)
    assert not sorter._running and sorter._pending_dir is None
    order, vd = sorter.consume()
    assert any(np.array_equal(vd, v) for v in dirs.reshape(-1, 3))
    np.testing.assert_array_equal(order, sort_order(means, vd))


def test_native_extractors_refuse_short_payloads(native_lib):
    payload = np.zeros(10 * 16, np.uint8)
    with pytest.raises(ValueError, match="records"):
        native.ply_extract(payload, 11, 16, [0])
    with pytest.raises(ValueError, match="outside"):
        native.ply_extract_block(payload, 10, 16, 8, 3)
    with pytest.raises(ValueError, match="outside"):
        native.ply_extract_3dgs(payload, 10, 8, [0, 4, 8] + [-1] * 12, 0)  # xyz: 12 bytes
    assert native.ply_extract(payload, 10, 16, [0, 12])[1].shape == (10,)


def test_host_sorter_without_the_library_is_numpy_stable(monkeypatch):
    d = scene(n=5000, sh_degree=0, seed=5)
    monkeypatch.setattr(native, "available", lambda: False)
    s = AsyncHostSorter(d["means"])
    s.sort_async([0.0, 0.0, 1.0])
    s.join()
    order, _ = s.consume()
    want = np.argsort(d["means"] @ np.float32([0, 0, 1]), kind="stable")
    np.testing.assert_array_equal(order, want)


def radix_keys(v):
    """The radix sort's order-preserving uint32 keys (fast_splats.cpp
    encode_minmax_f32)."""
    bits = v.view(np.uint32)
    return bits ^ np.where(bits >> 31 == 1, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))


def test_radix_argsort_matches_stable_argsort(native_lib):
    rng = np.random.default_rng(11)
    plain = rng.normal(size=100_003).astype(np.float32)
    ties = rng.integers(0, 50, size=70_000).astype(np.float32)
    ties[::7] = np.nan  # positive NaNs: last, in index order, as numpy's
    for v in (plain, ties, np.float32([3.0, 1.0, 2.0]), np.zeros(0, np.float32)):
        np.testing.assert_array_equal(native.radix_argsort_f32(v),
                                      np.argsort(v, kind="stable").astype(np.int32))
    # signed zeros and negative NaNs: the radix orders by its keys (-0
    # before +0, a negative NaN before -inf), numpy by value
    odd = np.float32([0.0, -0.0, 1.0, -np.nan, -np.inf, np.nan, -0.0, 0.0, -1.0])
    got = native.radix_argsort_f32(odd)
    np.testing.assert_array_equal(got, np.argsort(radix_keys(odd), kind="stable"))
    assert list(got[:2]) == [3, 4] and list(got[3:7]) == [1, 6, 0, 7]


def test_native_library_builds_into_build_dir(native_lib):
    path = native.library_path()
    assert path.exists() and path.name.startswith("libfast_splats-")
    assert path.parent == native.REPO / "build" / "native"
