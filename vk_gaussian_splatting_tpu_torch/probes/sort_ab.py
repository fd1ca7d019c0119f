"""The probes P1 and P3 of several builds, side by side on one card.

    python -m vk_gaussian_splatting_tpu_torch.probes.sort_ab \
        [--build LABEL=DIR ...] [--rows 2,16] [--turns 2] [--out FILE]

Times the kernels of csrc/bench_roll.cu (P1) and csrc/bench_sort_stage.cu
(P3, each variant) of this tree and of each other build given: a directory
holding another ``bench_roll.cu``, ``bench_sort_stage.cu`` and the headers
they include (for example a parent commit's, from ``git archive``). Each
is compiled with ``_build.NVCC_FLAGS`` under ``build/ab/`` and called
through the same C entry points, whose signatures every build shares, on
the probes' default inputs: P1 at 8160 x (rows, 2048) sorted once, P3 at
4096 blocks x 2 x (rows, 1024), 55 stages, for each ``--rows``. The builds
take turns (the others, this tree, this tree, the others, ... for
``--turns`` pairs); each turn gives the kernel alone (torch.profiler,
median of the last 7 records of 20 launches traced) and the call (CUDA events,
median of 7). Every
build's output must equal the plain twin's bit for bit. The library call
torch.sort + torch.take_along_dim of the key rows is timed in the same run.

Prints one line per measurement beside the card's name and power limit,
and writes them all as JSON to ``--out`` (default build/sort_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import tempfile
from pathlib import Path

import torch

from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.probes import bench_roll as pr
from vk_gaussian_splatting_tpu_torch.probes import bench_sort_stage as ps
from vk_gaussian_splatting_tpu_torch.timing import call_ms, device_label

NAMES = ("bench_roll", "bench_sort_stage")
CALLS = 7
SPARE = 13  # traced calls beyond CALLS, for the records a trace loses
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_other(src: Path, name: str) -> ctypes.CDLL:
    """csrc-like directory ``src``'s ``<name>.cu``, built with the port's
    flags under build/ab/ (keyed by its sources' hash) and loaded."""
    h = hashlib.sha256()
    for f in sorted(src.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    out = _build.BUILD_DIR.parent / "ab" / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.compile_source(src / f"{name}.cu", out)
        print(f"built {out.name} from {src}:\n{Path(str(out) + '.log').read_text().strip()}",
              flush=True)
    return ctypes.CDLL(str(out))


def entry(lib: ctypes.CDLL, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = ([_P, _I, _I, _I, _I, _P, _P] if symbol == "bench_roll"
                   else [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P])
    fn.restype = ctypes.c_int
    return fn


def kernel_alone_ms(call) -> float:
    """Median device ms of the kernel one call launches over its last CALLS
    records in a torch.profiler trace of CALLS + SPARE calls after a
    thrown-away warm-up step: on the card a window loses up to a few of
    its first records, warm-up step or not."""
    durs = _traced_kernel_ms(call)
    if len(durs) < CALLS:
        raise RuntimeError(f"{len(durs)} kernel records in {CALLS + SPARE} calls")
    return statistics.median(durs[-CALLS:])


def _traced_kernel_ms(call) -> list[float]:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=acts, schedule=once,
                                    on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            call()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(CALLS + SPARE):
                call()
            torch.cuda.synchronize()
            prof.step()
        events = json.load(open(path))["traceEvents"]
    return [e["dur"] / 1e3 for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "kernel"]


def cases(rows_list, dev):
    """(case name, inputs, twin's output, library call, launcher(lib))."""
    out = []
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows in rows_list:
        x = pr.tiles_of(pr.FRAME_TILES, rows, 2048, dev, seed=1)
        want = pr.bitonic_sort_ref(x, 1)

        def roll(lib, x=x):
            y = torch.empty_like(x)
            err = entry(lib, "bench_roll")(x.data_ptr(), x.shape[0], x.shape[1], x.shape[2], 1,
                                           y.data_ptr(), stream)
            if err:
                raise RuntimeError(f"bench_roll: cudaError {err}")
            return y

        def lib_roll(x=x):
            return torch.take_along_dim(x, torch.sort(x[:, 0], dim=-1).indices[:, None], dim=-1)

        out.append((f"P1 {pr.FRAME_TILES} x ({rows}, 2048)", want, lib_roll, roll))
        for variant in ps.VARIANTS:
            if variant == "sub8" and rows not in ps.SUB8_ROWS:
                continue
            x, m, sched = ps.inputs(variant, rows, 55, 2, dev)
            want = ps.sort_stages_ref(x, m, variant, sched, rows - 1)
            table = torch.tensor(sched, dtype=torch.int32, device=dev)

            def stage(lib, x=x, m=m, variant=variant, table=table, rows=rows):
                y = torch.empty_like(x)
                err = entry(lib, "bench_sort_stage_" + variant.replace("-", "_"))(
                    x.data_ptr(), 0 if m is None else m.data_ptr(), table.data_ptr(), 55,
                    x.shape[0], rows, rows - 1, ps.STEPS, y.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"bench_sort_stage {variant}: cudaError {err}")
                return y

            flat = x.reshape(2, rows, -1).repeat(ps.STEPS, 1, 1)

            def lib_stage(flat=flat, rows=rows):
                order = torch.sort(flat[:, rows - 1], dim=-1).indices
                return torch.take_along_dim(flat, order[:, None], dim=-1)

            out.append((f"P3 {variant} {ps.STEPS} x 2 x ({rows}, 1024)", want, lib_stage, stage))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--rows", default="2,16")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default="build/sort_ab.json")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = device_label(dev)
    builds = {"tree": {n: _build.load(n) for n in NAMES}}
    for spec in args.build:
        label, src = spec.split("=", 1)
        builds[label] = {n: build_other(Path(src), n) for n in NAMES}
    others = [b for b in builds if b != "tree"]
    order = []
    for _ in range(args.turns):
        order += others + ["tree", "tree"] + others
    if not others:
        order = ["tree"] * args.turns
    rows_list = [int(r) for r in args.rows.split(",")]
    results = []
    for case, want, library, launch in cases(rows_list, dev):
        lib_ms = statistics.median(call_ms(library, dev, CALLS))
        print(f"{case} ({card}): library_ms (torch.sort + take_along_dim)={lib_ms:.4f}",
              flush=True)
        results.append(dict(case=case, build="library", events_ms=lib_ms))
        for label in order:
            lib = builds[label]["bench_roll" if case.startswith("P1") else "bench_sort_stage"]
            got = launch(lib)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{case}: build {label} differs from the twin")
            alone = kernel_alone_ms(lambda: launch(lib))
            events = statistics.median(call_ms(lambda: launch(lib), dev, CALLS))
            print(f"{case} ({card}) build {label}: kernel_alone_ms={alone:.4f} "
                  f"events_ms={events:.4f} (bit-equal to the twin)", flush=True)
            results.append(dict(case=case, build=label, kernel_alone_ms=alone,
                                events_ms=events))
        del want
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
