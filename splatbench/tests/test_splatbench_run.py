"""The command's refusals: no card, no program, and the result's form."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from splatbench import run, spec


def test_no_card_no_result(capsys):
    """Without a CUDA device the run fails and prints no result: it never
    falls back to the CPU."""
    code = run.main(["--workload", "inria_bicycle_6m.view_3dgs", "--seed", "3000000000",
                     "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == ""
    assert "CUDA device" in out.err


def test_unknown_workload_no_result(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the command fails and prints nothing; the program it drives is
    not there to import."""
    shutil.copytree(spec.HERE, tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    bench = spec.load_benchmark()
    res = subprocess.run(bench["command"] + ["--workload", bench["workloads"][0]["name"],
                                             "--seed", "2147483659", "--seconds", "1",
                                             "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
    res = subprocess.run([sys.executable, "-c", "import splatbench.workloads"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "vk_gaussian_splatting_tpu_torch" in res.stderr


def summary_of(kind: str):
    from splatbench import counts, trace

    if kind == "view":
        return trace.TraceSummary(
            "view", 4, {"project": 0.02, "bin": 0.04, "blend": 0.008, "assemble": 0.001},
            {"rasterize_fwd_kernel<Gs2d>": 0.006, "warp_mask_kernel": 0.002}, 1200, 0.09, 0.1,
            {"num_pairs": [30, 32, 34, 36]},
            {"blend_fwd": counts.Work(1e9, 1e8), "frame": counts.Work(3e9, 1.5e9)}, [], [])
    return trace.TraceSummary(
        "train", 3, {"prepare": 0.003, "project": 0.01, "bin": 0.004, "rays": 0.003,
                     "blend": 0.006, "assemble": 0.001, "loss": 0.003, "backward": 0.06,
                     "optimizer": 0.006},
        {"rasterize_bwd_kernel<Gut3d>": 0.03}, 4200, 0.1, 0.15, {},
        {"blend_fwd": counts.Work(1e9, 1e8), "blend_bwd": counts.Work(3e9, 1e8),
         "step": counts.Work(5e10, 2e9)}, [], [])


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", ["inria_bicycle_6m.view_3dgs", "mipnerf360_1m.train_3dgut"])
def test_metrics_line_names_and_units(traced, workload):
    from splatbench import workloads

    cell = spec.resolve(spec.load_benchmark(), workload)
    kind = cell["traffic"]["kind"]
    out = workloads.Outcome(100, 0, 20.0, 10.0, [0.03] * 100, 2 ** 33, {}, [], summary_of(kind))
    line = run.metrics_line(cell, out, traced)
    names = [m["name"] for m in (cell["per_layer"] if traced else cell["end_to_end"])]
    assert sorted(line) == sorted(names)
    assert json.loads(json.dumps(line)) == line
    if traced and kind == "view":
        assert line["blend_roofline.view"]["unit"] == "%"
        assert 0 < line["blend_roofline.view"]["value"] < 100
        assert line["idle_share.view"]["value"] == pytest.approx(10.0)
        assert line["pairs_per_frame.view"]["value"] == 33
    elif traced:
        assert line["forward_ms.train_gut"]["value"] == pytest.approx(10.0)
        assert line["backward_ms.train_gut"]["value"] == pytest.approx(20.0)
        assert line["idle_share.train_gut"]["value"] == pytest.approx(100 / 3)
        assert 0 < line["blend_bwd_roofline.train_gut"]["value"] < 100
    elif kind == "view":
        assert line["frames_per_s"]["value"] == 10.0
        assert line["device_mem_peak_gib"]["value"] == 8.0
    else:
        assert line["train_steps_per_s.gut"] == {"value": 10.0, "unit": "steps/s"}
