"""The traced window: the profiler's trace of a few calls, reduced to what
the per-layer metrics read.

``traced_events`` runs one warm-up call in the profiler's warm-up step and
throws it away (on an H100 a window without that step has lost the records
of its first kernels), then the traced calls inside one
``splatbench.window`` span. ``summarize`` attributes every device
operation to the program's stage span (project, bin, blend, ...) that was
open on the host when the operation was launched: kernels launched by
autograd's thread fall inside the ``backward`` span, which the main thread
holds open meanwhile.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

import torch
from torch.profiler import record_function

WINDOW = "splatbench.window"
STAGES = ("prepare", "project", "bin", "rays", "blend", "assemble", "loss", "backward",
          "optimizer")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BREAKDOWN_ENTRIES = 10


def traced_events(call, calls: int, sync) -> list:
    """The trace events of ``calls`` calls of ``call(i)`` (i from 1), after
    one warm-up call ``call(0)`` that the profiler drops; ``sync()`` waits
    for the device."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts, schedule=once,
                                    on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            call(0)
            sync()
            prof.step()
            with record_function(WINDOW):
                for i in range(1, calls + 1):
                    call(i)
                sync()
            prof.step()
        with open(path) as f:
            return json.load(f)["traceEvents"]


@dataclasses.dataclass
class TraceSummary:
    """What the per-layer readers read (layer_metrics/<metric>.py)."""

    kind: str                 # the traffic's kind: "view" or "train"
    calls: int                # frames or steps in the traced window
    span_s: dict              # stage -> device seconds launched inside it
    kernel_s: dict            # kernel name -> device seconds
    kernels: int              # kernels in the window
    busy_s: float             # seconds some device operation ran
    window_s: float           # the window's length
    counters: dict            # program counters per call, e.g. "num_pairs": [...]
    work: dict                # counts.Work per call: "blend_fwd", "blend_bwd", "frame", "step"
    gaps: list                # the longest idle gaps: [(host span, seconds)]
    top_ops: list             # the device operations that took most time: [(name, seconds)]


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its trailing argument list, at most ``limit`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:limit]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list, kind: str, calls: int, counters: dict, work: dict) -> TraceSummary:
    window = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") in STAGES
                   and w0 <= e["ts"] <= w1)
    starts = [s[0] for s in spans]

    def span_at(t: float) -> str:
        """The stage span open at host time t (stage spans do not nest), or "host"."""
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and t <= spans[i][1] else "host"

    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    span_s: dict = {}
    kernel_s: dict = {}
    kernels = 0
    busy = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if b < w0 or a > w1:
            continue
        secs = e["dur"] * 1e-6
        corr = e.get("args", {}).get("correlation")
        stage = span_at(launch.get(corr, a))
        span_s[stage] = span_s.get(stage, 0.0) + secs
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + secs
        kernels += e["cat"] == "kernel"
        busy.append((max(a, w0), min(b, w1)))
    merged = _merge(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps, t = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > t:
            gaps.append((span_at(t), (a - t) * 1e-6))
        t = max(t, b)
    gaps.sort(key=lambda g: -g[1])
    top_ops = [(short_name(n), v) for n, v in
               sorted(kernel_s.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
    return TraceSummary(kind, calls, span_s, kernel_s, kernels, busy_s, (w1 - w0) * 1e-6,
                        counters, work, gaps[:BREAKDOWN_ENTRIES], top_ops)
