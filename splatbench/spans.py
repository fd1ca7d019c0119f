"""Device time by program spans that ``trace.summarize`` does not
attribute: the spans of a traced window whose names it does not list in
``trace.STAGES``, read from the same events.

``span_seconds`` gives each device operation to every span of ``names``
(and their ``<name>.<part>`` children) that was open on the host when the
operation was launched, so a child's time is also its parent's; and, for
each such span, the device seconds of every kernel launched inside it.
``with_spans`` adds them to a ``trace.TraceSummary``: the spans' seconds
to its ``span_s``, taken out of the "host" share where ``summarize`` put
them, and the kernels by span as ``span_kernel_s``.
"""

from __future__ import annotations

import dataclasses

from splatbench import trace


@dataclasses.dataclass
class SpanSummary(trace.TraceSummary):
    span_kernel_s: dict = dataclasses.field(default_factory=dict)  # span -> {kernel: seconds}


def _named(name: str, names) -> bool:
    return name in names or name.split(".")[0] in names


def span_seconds(events: list, names) -> tuple[dict, dict]:
    """({span: device seconds}, {span: {kernel name: device seconds}}) of
    the spans ``names`` and their children, within the traced window."""
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == trace.WINDOW]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and _named(e.get("name", ""), names)
             and w0 <= e["ts"] <= w1]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    span_s: dict = {}
    kernel_s: dict = {}
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or e["ts"] + e["dur"] < w0 or e["ts"] > w1:
            continue
        t = launch.get(e.get("args", {}).get("correlation"), e["ts"])
        secs = e["dur"] * 1e-6
        for a, b, name in spans:
            if a <= t <= b:
                span_s[name] = span_s.get(name, 0.0) + secs
                if e.get("cat") == "kernel":
                    inside = kernel_s.setdefault(name, {})
                    inside[e["name"]] = inside.get(e["name"], 0.0) + secs
    return span_s, kernel_s


def with_spans(summary: trace.TraceSummary, events: list, names) -> SpanSummary:
    """``summary`` with the device seconds of the spans ``names`` and their
    children (``span_seconds``)."""
    span_s, kernel_s = span_seconds(events, names)
    total = dict(summary.span_s)
    for name, secs in span_s.items():
        total[name] = secs
        if name in names and "host" in total:
            total["host"] = max(total["host"] - secs, 0.0)
    fields = {f.name: getattr(summary, f.name) for f in dataclasses.fields(summary)}
    return SpanSummary(**dict(fields, span_s=total), span_kernel_s=kernel_s)
