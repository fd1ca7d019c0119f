"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the file its ``configs`` entry names; its traffic
mix is ``traffic/<traffic>.json``, which names its runner
``kinds/<kind>.py``, its reference ``reference/<reference>.py`` and its work
counts ``work/<work>.py``; a per-layer metric's reader is
``layer_metrics/<metric>.py``. Nothing here lists a cell, a mix, a kind, a
reference or a metric: adding one is adding its entry and its files.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / HERE.name / "traffic" / f"{name}.json"


def module_paths(traffic: dict, root: Path = ROOT) -> dict:
    """The files a traffic mix names: {"kind": ..., "reference": ..., "work": ...}."""
    folders = {"kind": "kinds", "reference": "reference", "work": "work"}
    return {key: root / HERE.name / folder / f"{traffic[key]}.py"
            for key, folder in folders.items()}


def reader_path(metric: str, root: Path = ROOT) -> Path:
    return root / HERE.name / "layer_metrics" / f"{metric}.py"


def load_reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``layer_metrics/<metric>.py``."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(f"splatbench.layer_metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _applies(entry: dict, workload: str) -> bool:
    return workload in entry.get("workloads", [workload])


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one cell needs: its workload entry, configuration and
    traffic data, and its end-to-end and per-layer metric entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / config["file"]) as f:
        config_data = json.load(f)
    with open(traffic_path(cell["traffic"], root)) as f:
        traffic = json.load(f)
    for path in module_paths(traffic, root).values():
        if not path.is_file():
            raise KeyError(f"{cell['traffic']}: no {path.relative_to(root)}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(workload=cell, config=config_data, traffic=traffic, end_to_end=e2e,
                per_layer=layer)
