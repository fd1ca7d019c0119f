"""Benchmark post-processing: sequencer stdout -> CSV + per-stage charts.

The reference's benchmark.py (:19-78) regex-parses the app's stdout (Timer
lines + BENCHMARK_ADV memory blocks per ParameterSequence) into a CSV and
renders per-scene histogram charts (:486-615). This module closes the same
loop for the sequencer's stdout — which deliberately speaks the identical
grammar (utils/profiling.py, utils/memstats.py) so either parser works on
either tool's output. The JAX package's ``bench/report.py`` word for word:
this package keeps its own copy and imports nothing of that one. The chart
needs matplotlib and is skipped without it.
"""

from __future__ import annotations

import csv
import io
import re

TIMER_RE = re.compile(r'Timer "([^"]+)"; GPU; avg ([0-9.eE+-]+);')
SEQ_RE = re.compile(r'ParameterSequence (\d+) "([^"]*)" =')
MEM_RE = re.compile(
    r"Memory (\w+); Host used \t(\d+); Device Used \t(\d+); "
    r"Device Allocated \t(\d+);")
ADV_RE = re.compile(r"BENCHMARK_ADV (\d+) \{")


def parse_benchmark_output(text: str) -> list[dict]:
    """stdout -> per-sequence records: {id, name, timers{stage: us},
    memory{category: (host, dev_used, dev_alloc)}} (benchmark.py:19-75)."""
    records: list[dict] = []
    current: dict | None = None
    for line in text.splitlines():
        m = SEQ_RE.match(line.strip())
        if m:
            if current is not None:
                records.append(current)
            current = {"id": int(m.group(1)), "name": m.group(2),
                       "timers": {}, "memory": {}}
            continue
        if current is None:
            continue
        m = TIMER_RE.search(line)
        if m:
            current["timers"][m.group(1)] = float(m.group(2))
            continue
        m = MEM_RE.search(line)
        if m:
            current["memory"][m.group(1)] = (
                int(m.group(2)), int(m.group(3)), int(m.group(4)))
    if current is not None:
        records.append(current)
    return records


def records_to_csv(records: list[dict], scene: str = "") -> str:
    """CSV with one row per sequence and one column per timer stage / memory
    category (the per-scene CSV layout of benchmark.py:78)."""
    stages: list[str] = []
    mems: list[str] = []
    for r in records:
        for s in r["timers"]:
            if s not in stages:
                stages.append(s)
        for mname in r["memory"]:
            if mname not in mems:
                mems.append(mname)
    buf = io.StringIO()
    w = csv.writer(buf)
    header = ["scene", "sequence_id", "sequence"]
    header += [f"{s} avg us" for s in stages]
    for mname in mems:
        header += [f"Mem {mname} host", f"Mem {mname} device used",
                   f"Mem {mname} device alloc"]
    w.writerow(header)
    for r in records:
        row = [scene, r["id"], r["name"]]
        row += [r["timers"].get(s, "") for s in stages]
        for mname in mems:
            hm = r["memory"].get(mname, ("", "", ""))
            row += list(hm)
        w.writerow(row)
    return buf.getvalue()


def write_report(text: str, csv_path: str, scene: str = "",
                 chart_path: str | None = None) -> list[dict]:
    """Parse sequencer stdout, write the CSV, optionally render the
    per-stage bar chart (benchmark.py:486-615's histogram step)."""
    records = parse_benchmark_output(text)
    with open(csv_path, "w") as f:
        f.write(records_to_csv(records, scene))
    if chart_path and records:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return records
        stages = sorted({s for r in records for s in r["timers"]})
        names = [r["name"] or str(r["id"]) for r in records]
        fig, ax = plt.subplots(figsize=(max(6, len(names) * 0.9), 4.5))
        bottom = [0.0] * len(records)
        for s in stages:
            vals = [r["timers"].get(s, 0.0) / 1000.0 for r in records]
            ax.bar(names, vals, bottom=bottom, label=s)
            bottom = [b + v for b, v in zip(bottom, vals)]
        ax.set_ylabel("ms")
        ax.set_title(scene or "benchmark")
        ax.legend(fontsize=7)
        plt.xticks(rotation=45, ha="right", fontsize=7)
        fig.tight_layout()
        fig.savefig(chart_path, dpi=110)
        plt.close(fig)
    return records
