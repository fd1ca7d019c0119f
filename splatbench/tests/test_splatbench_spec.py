"""BENCHMARK.json against the contract it is written to, and every entry
against its files, found by name."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu_torch.config import SortMethod
from splatbench import spec, workloads
from splatbench.tests.conftest import load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "_dim", "_rank")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_shape_of_the_file(bench):
    assert set(bench) == KEYS["top"]
    assert len(json.dumps(bench)) < 64 * 1024
    assert bench["paths"] == ["splatbench"] and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    for kind in ("config", "workload", "end_to_end", "per_layer"):
        key = {"config": "configs", "workload": "workloads"}.get(kind, kind)
        for entry in bench[key]:
            extra = set(entry) - KEYS[kind] - ({"workloads"} if kind in ("end_to_end", "per_layer")
                                               else set())
            assert KEYS[kind] <= set(entry) and not extra, (kind, entry["name"])
            assert NAME.match(entry["name"]), entry["name"]


def test_names_units_and_bounds(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"])
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in names
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_entries_resolve_to_their_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        data = load_json(spec.ROOT / c["file"])
        assert c["file"].startswith("splatbench/") and data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] and data["assumed"]
        assert not any(word in key for key in c["reduced"] for word in WIDTH_WORDS)
    for w in bench["workloads"]:
        traffic = load_json(spec.traffic_path(w["traffic"]))
        assert traffic["limits"] and traffic["render"]
        assert all(path.is_file() for path in spec.module_paths(traffic).values())
        assert callable(workloads.kind(traffic).run)
        assert callable(workloads.reference(traffic).render)
        assert all(callable(getattr(workloads.work(traffic), f))
                   for f in ("blend_fwd", "blend_bwd", "frame", "train_step"))
        cell = spec.resolve(bench, w["name"])
        cfg = workloads.render_config(cell["config"], traffic)
        assert cfg.pipeline.name == traffic["render"]["pipeline"]
        assert cfg.raster.expansion == "exact"
    for m in bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))


def test_render_blocks_build_every_field_kind():
    cfg = workloads.render_config(
        dict(width=64, height=48, sh_degree=1, background=[0.5, 0.5, 0.5]),
        {"render": {"pipeline": "MESH_3DGUT", "camera_type": "FISHEYE", "temporal_samples": 4,
                    "stochastic": "SPLAT", "raster": {"method": "bucket",
                                                      "bucket_caps": [1, 2, 3, 4],
                                                      "sort_method": "HOST"},
                    "rt": {"kernel_degree": 4}}})
    assert cfg.pipeline == gt.Pipeline.MESH_3DGUT and cfg.camera_type == gt.CameraType.FISHEYE
    assert cfg.stochastic == gt.StochasticMode.SPLAT and cfg.temporal_samples == 4
    assert cfg.raster.method == "bucket" and cfg.raster.bucket_caps == (1, 2, 3, 4)
    assert cfg.raster.sort_method == SortMethod.HOST and cfg.rt.kernel_degree == 4
    assert cfg.background == (0.5, 0.5, 0.5) and (cfg.width, cfg.height) == (64, 48)


# Run in a copy of the benchmark with a cell added: its traffic file sets
# raster options (the bucket method and its caps) and is run at a small size
# on the CPU by the copy's own harness, whose modules the run must load.
RUN_ADDED_CELL = """
import json, time, torch, splatbench
from splatbench import workloads
from splatbench.tests.conftest import small
cell = small("inria_bicycle_6m", "view_bucket")
cell["config"].update(splats=4000, width=64, height=48)
cell["traffic"]["orbit"]["views"], cell["traffic"]["check_first"] = 2, 2
cfg = workloads.render_config(cell["config"], cell["traffic"])
out = workloads.kind(cell["traffic"]).run(cell["config"], cell["traffic"], 2147483720, 0.1,
                                          False, torch.device("cpu"), time.perf_counter())
print(json.dumps(dict(file=splatbench.__file__, method=cfg.raster.method, numbers=out.numbers,
                      caps=list(cfg.raster.bucket_caps), failed=out.failed,
                      attempted=out.attempted)))
"""


def test_a_new_cell_metric_and_mix_need_no_edit(bench, tmp_path):
    """Copy the benchmark, add a traffic file that sets raster options, a
    reader and their entries; find them by name and run the new cell
    without touching a file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "splatbench").rglob("*") if p.is_file()}
    traffic = load_json(spec.traffic_path("view_3dgs"))
    traffic["render"]["raster"].update(method="bucket", bucket_caps=[2048, 2048, 2048, 2048])
    (root / "splatbench/traffic/view_bucket.json").write_text(json.dumps(traffic))
    (root / "splatbench/layer_metrics/splats_per_pair.view.py").write_text(
        "def read(t):\n    return 1.0\n")
    b = json.loads(json.dumps(bench))
    b["workloads"].append(dict(b["workloads"][0], name="inria_bicycle_6m.view_bucket",
                               traffic="view_bucket"))
    b["per_layer"].append(dict(b["per_layer"][0], name="splats_per_pair.view",
                               workloads=["inria_bicycle_6m.view_bucket"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.resolve(spec.load_benchmark(root), "inria_bicycle_6m.view_bucket", root)
    assert cell["traffic"]["render"]["raster"]["method"] == "bucket"
    assert [m["name"] for m in cell["per_layer"]] == ["splats_per_pair.view"]
    assert spec.load_reader("splats_per_pair.view", root)(None) == 1.0
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    res = subprocess.run([sys.executable, "-c", RUN_ADDED_CELL], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(root)) and got["method"] == "bucket"
    # the frames are the reference's: at 64x48 one pixel that lands across a
    # cutoff is a share of 3e-4, over the transmittance and pick limits, so
    # the image's RMS gap stands for them here
    assert got["caps"] == [2048] * 4 and got["attempted"] >= 2 and got["failed"] == 0
    assert got["numbers"]["image_rmse"] < 1e-3, got["numbers"]
    assert all(p.read_bytes() == data for p, data in before.items())
