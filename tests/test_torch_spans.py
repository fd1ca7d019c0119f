"""The port's profiler spans, on the CPU.

- ``timing.span`` opens a ``record_function`` only while a profiler
  records: nothing with the profiler off, nothing in a schedule's warm-up
  step, every span in its active step. The private flag it reads exists.
- A render (Pipeline.MESH, exact expansion) opens project.sh, bin.rows,
  bin.expand, bin.sort and bin.gather, each inside its stage span on its
  own thread; a 3DGUT render opens the same; a train step also opens
  backward.gather and backward.blend inside backward.
- bin_splats sorts the budget rounded up to the chunk (exact) or the
  slots (slots), which a reader of the pairs' fill computes from its inputs.
- ``splatbench.trace.summarize`` reads a trace with these child spans,
  on two threads, exactly as it reads the trace without them.
"""

import contextlib
import json
import os
import tempfile

import pytest
import torch

import vk_gaussian_splatting_tpu_torch.config as tc
from vk_gaussian_splatting_tpu_torch import interop, timing
from vk_gaussian_splatting_tpu_torch import train as tt
from vk_gaussian_splatting_tpu_torch.ops.binning import bin_splats
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats
from vk_gaussian_splatting_tpu_torch.render import render
from vk_gaussian_splatting_tpu_torch.render.pipelines import gs_attr_rows
from vk_gaussian_splatting_tpu_torch.scene import cameras as tcam
from splatbench import trace

torch.set_num_threads(2)

W, H = 64, 48
MAX_PAIRS = 5000  # not a multiple of the chunk: the budget rounds up
RENDER_CHILDREN = ("project.sh", "bin.rows", "bin.expand", "bin.sort", "bin.gather")
BACKWARD_CHILDREN = ("backward.gather", "backward.blend")


def scene(seed=0, n=400):
    d = interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-3.5, -2.0))
    cam = tcam.look_at([0.2, -0.3, -9.0], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9,
                       device="cpu")
    return d, cam


def config(pipeline=tc.Pipeline.MESH, expansion="exact"):
    return tc.RenderConfig(width=W, height=H, sh_degree=1, pipeline=pipeline,
                           raster=tc.RasterConfig(expansion=expansion))


def profiled(fn) -> list:
    """The chrome-trace events of one call of ``fn`` under the profiler."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def spans(events, name) -> list:
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name]


def inside(child, parent) -> bool:
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def assert_nested(events, children, same_thread=True):
    """Each child span opens at least once, and every one lies inside a
    span of its stage (the name before the dot), on its own thread if
    ``same_thread``."""
    for name in children:
        found = spans(events, name)
        assert found, f"no {name} span"
        stages = spans(events, name.split(".")[0])
        for c in found:
            assert any(inside(c, s) and (not same_thread or s["tid"] == c["tid"])
                       for s in stages), f"{name} outside its stage span"


def test_the_profiler_flag_span_reads_exists():
    import torch.autograd.profiler as autograd_profiler
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_span_opens_nothing_with_the_profiler_off():
    assert isinstance(timing.span("bin"), contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(timing.span("bin"), torch.profiler.record_function)
    assert isinstance(timing.span("bin"), contextlib.nullcontext)


def test_span_keeps_the_active_step_of_a_schedule():
    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    schedule=once,
                                    on_trace_ready=lambda p: p.export_chrome_trace(path)) as p:
            with timing.span("warm"):
                torch.ones(4).sum()
            p.step()
            with timing.span("active"):
                torch.ones(4).sum()
            p.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    assert spans(events, "active") and not spans(events, "warm")


@pytest.mark.parametrize("pipeline", [tc.Pipeline.MESH, tc.Pipeline.MESH_3DGUT])
def test_render_child_spans_lie_in_their_stage(pipeline):
    d, cam = scene()
    prepared = interop.splat_set_from_numpy(d, "cpu").prepare()
    cfg = config(pipeline)
    events = profiled(lambda: render(prepared, cam, cfg, MAX_PAIRS))
    assert_nested(events, RENDER_CHILDREN)
    assert not any(spans(events, n) for n in BACKWARD_CHILDREN)


def test_train_step_opens_the_backward_children():
    d, cam = scene(1)
    target = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, config(),
                    MAX_PAIRS).image
    splats = interop.splat_set_from_numpy(scene(2)[0], "cpu")
    train_cfg = tt.TrainConfig()
    opt = tt.make_optimizer(splats, train_cfg)
    events = profiled(lambda: tt.train_step(splats, opt, cam, target, config(), MAX_PAIRS,
                                            train_cfg))
    assert_nested(events, RENDER_CHILDREN)
    # autograd's device thread opens them on a card: inside backward's
    # time, on whichever thread
    assert_nested(events, BACKWARD_CHILDREN, same_thread=False)


def test_a_render_fills_part_of_the_rounded_budget():
    d, cam = scene(3)
    cfg = config()
    out = render(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg, MAX_PAIRS)
    chunk = cfg.raster.chunk
    assert 0 < int(out.num_pairs) <= -(-MAX_PAIRS // chunk) * chunk


@pytest.mark.parametrize("expansion", ["exact", "slots"])
def test_the_sort_orders_the_rounded_budget_or_the_slots(expansion):
    d, cam = scene(4)
    cfg = config(expansion=expansion)
    proj = project_splats(interop.splat_set_from_numpy(d, "cpu").prepare(), cam, cfg)
    rows, ids = gs_attr_rows(proj)
    bins = bin_splats(proj, rows, ids, tile_size=16, tiles_x=tc.tiles_x(cfg),
                      tiles_y=tc.tiles_y(cfg), slots_k=cfg.raster.slots_k,
                      max_pairs=MAX_PAIRS, expansion=expansion)
    chunk = cfg.raster.chunk
    positions = bins.pair_id.shape[0]
    assert positions == bins.attrs.shape[1]
    if expansion == "exact":
        assert positions == -(-MAX_PAIRS // chunk) * chunk
    assert 0 < int(bins.num_pairs) <= positions


# ---------------------------------------------------------------------------
# splatbench.trace.summarize on a synthetic trace with child spans
# ---------------------------------------------------------------------------

MAIN, AUTOGRAD = 1, 2
SUMMARY_FIELDS = ("kind", "calls", "span_s", "kernel_s", "kernels", "busy_s", "window_s",
                  "counters", "work", "gaps", "top_ops")


def annotation(name, ts, dur, tid=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def synthetic_trace():
    """One traced step: main-thread stages with nested children, an
    autograd thread with the backward children, and a device kernel per
    launch. Returns (events, the device seconds launched in each stage)."""
    events = [annotation(trace.WINDOW, 0, 1000)]
    stages = [("project", 10, 100, [("project.sh", 20, 40)]),
              ("bin", 120, 200, [("bin.rows", 125, 20), ("bin.expand", 150, 40),
                                 ("bin.sort", 195, 50), ("bin.gather", 250, 60)]),
              ("blend", 330, 50, []),
              ("backward", 400, 400, [])]
    for name, ts, dur, children in stages:
        events.append(annotation(name, ts, dur))
        events += [annotation(*c) for c in children]
    events += [annotation("backward.blend", 420, 100, AUTOGRAD),
               annotation("backward.gather", 560, 200, AUTOGRAD)]
    # (host launch time, thread, device start, device duration)
    launches = [(15, MAIN, 30, 5), (25, MAIN, 40, 10), (130, MAIN, 140, 8),
                (160, MAIN, 170, 12), (200, MAIN, 210, 30), (210, MAIN, 245, 7),
                (260, MAIN, 262, 20), (305, MAIN, 320, 4), (340, MAIN, 345, 25),
                (430, AUTOGRAD, 440, 60), (570, AUTOGRAD, 580, 150),
                (610, AUTOGRAD, 735, 40), (850, MAIN, 860, 6)]
    for corr, (t, tid, a, dur) in enumerate(launches):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t, "dur": 2,
                       "tid": tid, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": f"k{corr % 4}", "ts": a, "dur": dur,
                       "tid": 7, "args": {"correlation": corr}})
    expected = {"project": 15e-6, "bin": 81e-6, "blend": 25e-6, "backward": 250e-6,
                "host": 6e-6}
    return events, expected


def test_summarize_reads_child_spans_as_it_reads_their_absence():
    events, expected = synthetic_trace()
    bare = [e for e in events if "." not in e["name"] or e["name"] == trace.WINDOW]
    assert len(bare) < len(events)
    args = ("train", 1, {"num_pairs": [7]}, {})
    with_children = trace.summarize(events, *args)
    without = trace.summarize(bare, *args)
    # the fields summarize returns today, by name: a field added later
    # (child-span seconds, say) may read the children
    assert ({f: getattr(with_children, f) for f in SUMMARY_FIELDS}
            == {f: getattr(without, f) for f in SUMMARY_FIELDS})
    assert with_children.span_s == pytest.approx(expected)
    assert with_children.kernels == 13
