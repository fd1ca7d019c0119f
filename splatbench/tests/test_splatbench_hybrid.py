"""The hybrid cell (greenhouse_15m.view_hybrid) at a small size on the CPU:
a sound run is correct; each fault of calibrate_hybrid.py and the
bfloat16 reference in the program's place are refused; a short map budget
fails frames; a program older than the cell fails at once; the traced
summary's spans and counter reach the cell's readers."""

import json

import pytest
import torch

from splatbench import calibrate_hybrid, checks, run, spans, spec, trace, workloads
from splatbench.kinds import hybrid
from splatbench.tests.conftest import load_json
from splatbench.tests.test_splatbench_imports import top_level_modules

torch.set_num_threads(2)

CELL = "greenhouse_15m.view_hybrid"
SEED = 2147483801


def small_cell():
    """The cell's configuration and traffic cut to 4,000 splats at 96x64,
    maps of 32x32 (the cube's faces too), an orbit of 4 poses."""
    bench = spec.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}["greenhouse_15m"]
    config = load_json(spec.ROOT / entry["file"])
    config.update(splats=4000, width=96, height=64, shadow_res=32,
                  mix=[[0.6, -4.0, -3.0], [0.3, -3.0, -2.5], [0.1, -2.5, -2.0]])
    traffic = load_json(spec.traffic_path("view_hybrid"))
    traffic["orbit"]["views"], traffic["check_first"] = 4, 4
    traffic["budget_start"], traffic["shadow_budget_start"] = 1 << 16, 1 << 14
    return config, traffic


def run_small(program=hybrid.HybridProgram(), traced=False, seed=SEED, **changes):
    config, traffic = small_cell()
    traffic.update(changes)
    out = hybrid.run(config, traffic, seed, 0.2, traced, torch.device("cpu"), 0.0, program)
    ok, _ = checks.judge(dict(out.numbers, failed=out.failed), traffic["limits"])
    return out, ok


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_modules(("splatbench.reference.hybrid", "splatbench.work.hybrid",
                               "splatbench.spans"))
    assert not names & {"vk_gaussian_splatting_tpu_torch", "vk_gaussian_splatting_tpu", "jax"}


def test_sound_run_is_correct():
    out, ok = run_small()
    assert out.attempted >= 4 and out.failed == 0 and ok, out.numbers


@pytest.mark.parametrize("fault", sorted(calibrate_hybrid.FAULTS))
def test_fault_is_refused(fault):
    out, ok = run_small(hybrid.HybridProgram(render_hybrid=calibrate_hybrid.FAULTS[fault]()))
    assert out.failed == 0 and not ok, out.numbers


def test_control_is_refused():
    config, traffic = small_cell()
    numbers = calibrate_hybrid.control_numbers(config, traffic, SEED, torch.device("cpu"), [0, 1])
    ok, _ = checks.judge(dict(numbers, failed=0), traffic["limits"])
    assert not ok, numbers


def test_short_map_budget_fails_frames(monkeypatch):
    monkeypatch.setattr(hybrid, "BUDGET_ROUND", 64)
    out, ok = run_small(budget_margin=0.5)
    assert out.failed > 0 and not ok


def test_an_older_program_fails_at_once():
    """A render_hybrid that takes no map budget (the program before the
    cell) stops the run before the scene is made."""
    def older(prepared, cam, cfg, max_pairs=0, lights=(), material=None, instance_base=(),
              shadow_res=512):
        raise AssertionError("never called")

    with pytest.raises(SystemExit):
        hybrid.run({}, {}, SEED, 1.0, False, torch.device("cpu"), 0.0,
                   hybrid.HybridProgram(render_hybrid=older))


def test_traced_run_counts_the_maps_pairs():
    out, ok = run_small(traced=True)
    assert ok and out.summary.counters["shadow_pairs"]
    assert all(p > 0 for p in out.summary.counters["shadow_pairs"])
    assert out.summary.work["shadow_blend"].ops > 0
    assert out.summary.work["frame"].ops > out.summary.work["shadow_blend"].ops


def events():
    """A synthetic trace of two hybrid frames: host spans, their launches
    (correlated) and the kernels on the device, in microseconds."""
    ev = [dict(cat="user_annotation", name=trace.WINDOW, ts=0, dur=1000)]
    corr = [0]

    def span(name, ts, dur):
        ev.append(dict(cat="user_annotation", name=name, ts=ts, dur=dur))

    def kernel(name, launch, ts, dur):
        corr[0] += 1
        ev.append(dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=launch, dur=1,
                       args=dict(correlation=corr[0])))
        ev.append(dict(cat="kernel", name=name, ts=ts, dur=dur, args=dict(correlation=corr[0])))

    for f in (0, 500):
        span("blend", f + 10, 20)
        kernel("void rasterize_fwd_kernel<response::Gs2d, false, false>(float const*)",
               f + 12, f + 15, 10)
        span("normals", f + 40, 40)
        kernel("void rasterize_fwd_kernel<response::Gs2d, false, false>(float const*)",
               f + 50, f + 55, 20)
        span("shadow_map", f + 100, 200)
        span("shadow_map.project", f + 110, 30)
        kernel("elementwise", f + 115, f + 120, 30)
        span("shadow_map.blend", f + 200, 50)
        kernel("void warp_mask_kernel<response::Gs2d>(float const*)", f + 205, f + 210, 10)
        kernel("void rasterize_fwd_kernel<response::Gs2d, false, true>(float const*)",
               f + 206, f + 220, 30)
        span("shade", f + 350, 30)
        kernel("elementwise", f + 355, f + 360, 10)
    return ev


def test_spans_and_counter_reach_the_readers():
    ev = events()
    base = trace.summarize(ev, "view", 2, {"num_pairs": [10, 12], "shadow_pairs": [70, 74]},
                           {"shadow_blend": workloads.counts.Work(1e6, 1e5),
                            "frame": workloads.counts.Work(1e8, 1e8)})
    s = spans.with_spans(base, ev, hybrid.SPANS)
    assert s.span_s["normals"] == pytest.approx(40e-6)
    assert s.span_s["shadow_map"] == pytest.approx(140e-6)
    assert s.span_s["shadow_map.blend"] == pytest.approx(80e-6)
    assert s.span_s["shade"] == pytest.approx(20e-6)
    assert s.span_s["blend"] == pytest.approx(20e-6)
    assert s.span_s["host"] == pytest.approx(0.0, abs=1e-12)
    cell = spec.resolve(spec.load_benchmark(), CELL)
    out = workloads.Outcome(64, 0, 90.0, 20.0, [0.3] * 64, 2 ** 34, {}, [], s)
    line = run.metrics_line(cell, out, True)
    assert sorted(line) == sorted(m["name"] for m in cell["per_layer"])
    assert json.loads(json.dumps(line)) == line
    assert line["shadow_map_ms.hybrid"]["value"] == pytest.approx(70e-3)
    assert line["normals_ms.hybrid"]["value"] == pytest.approx(20e-3)
    assert line["shade_ms.hybrid"]["value"] == pytest.approx(10e-3)
    assert line["shadow_pairs_per_frame.hybrid"]["value"] == 72
    # K1i: its cull and its ISO blend inside shadow_map, 40 us a frame
    want = 100 * workloads.counts.Work(1e6, 1e5).bound_s() / 40e-6
    assert line["iso_blend_roofline.hybrid"]["value"] == pytest.approx(want)
    assert 0 < line["idle_share.hybrid"]["value"] < 100
    assert line["mfu.hybrid"]["value"] == pytest.approx(
        100 * workloads.counts.Work(1e8, 1e8).bound_s() / 500e-6)
    e2e = run.metrics_line(cell, out, False)
    assert sorted(e2e) == ["device_mem_peak_gib", "frame_ms_p95", "frames_per_s", "setup_s"]
    assert e2e["frames_per_s"]["value"] == pytest.approx(3.2)
