"""Small versions of the benchmark's cells for the CPU tests: the real
configuration and traffic files, cut to a scene and a frame that the
program's plain CPU path renders in seconds."""

import json
import time

import pytest
import torch

from splatbench import spec

SMALL_SCENE = dict(splats=20000, width=160, height=96,
                   mix=[[0.6, -4.0, -3.0], [0.3, -3.0, -2.5], [0.1, -2.5, -2.0]])


def small(config: str, traffic: str) -> dict:
    """A configuration of BENCHMARK.json under a traffic mix of traffic/,
    cut to the test size."""
    bench = spec.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}[config]
    cell = dict(config=load_json(spec.ROOT / entry["file"]),
                traffic=load_json(spec.traffic_path(traffic)))
    cell["config"].update(SMALL_SCENE)
    t = cell["traffic"]
    t["budget_start"] = 1 << 16
    if t["kind"] == "view":
        t["orbit"]["views"], t["check_first"] = 6, 4
    else:
        t["views"]["views"] = 4
    return cell


# the cells of BENCHMARK.json, and the 3DGUT view mix kept for a later cell
VIEW_CELLS = ("inria_bicycle_6m.view_3dgs", "mipnerf360_1m.view_3dgut")
TRAIN_CELLS = ("inria_bicycle_6m.train_3dgs", "mipnerf360_1m.train_3dgut")


@pytest.fixture(params=VIEW_CELLS)
def view_cell(request):
    return small(*request.param.split("."))


@pytest.fixture(params=TRAIN_CELLS)
def train_cell(request):
    return small(*request.param.split("."))


@pytest.fixture
def cpu():
    return torch.device("cpu")


def run_cell(cell, seed, device, **kw):
    from splatbench import workloads

    return workloads.kind(cell["traffic"]).run(cell["config"], cell["traffic"], seed, 0.5, False,
                                               device, time.perf_counter(), **kw)


def load_json(path):
    with open(path) as f:
        return json.load(f)
