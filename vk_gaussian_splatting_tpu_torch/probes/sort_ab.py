"""The probes P1-P3 of several builds, side by side on one card.

    python -m vk_gaussian_splatting_tpu_torch.probes.sort_ab \
        [--build LABEL=DIR ...] [--probes P1,P2,P3] [--rows 2,16] \
        [--widths 1,4,16,64] [--turns 2] [--out FILE]

Times the kernels of csrc/bench_roll.cu (P1), csrc/bench_sort_stage.cu
(P3, each variant) and csrc/bench_radix_ab.cu (P2) of this tree and of
each other build given: a directory holding another ``bench_roll.cu``,
``bench_sort_stage.cu``, ``bench_radix_ab.cu`` and the headers they
include (for example a parent commit's ``csrc/``, from ``git archive``).
Each is compiled with ``_build.NVCC_FLAGS`` under ``build/ab/`` and called
through the same C entry points, whose signatures every build shares, on
the probes' default inputs: P1 at 8160 x (rows, 2048) sorted once, P3 at
4096 blocks x 2 x (rows, 1024), 55 stages, for each ``--rows``; P2 at 256
steps x 64 copies of each ``--widths`` W, in one block and in 256 blocks,
each build's pieces planned by the ``ring_of`` of its own package (the
``probes/bench_radix_ab.py`` beside its ``csrc/``). The builds take turns
(the others, this tree, this tree, the others, ... for ``--turns`` pairs);
each turn gives the kernel alone (torch.profiler, median of the last 7
records of 20 launches traced) and the call (CUDA events, median of 7).
Every build's output must equal the plain twin's bit for bit (P2: also
every copied block of a 4-step run). The library call is timed in the
same run: torch.sort + torch.take_along_dim of the key rows (P1, P3),
torch.index_select of the copied blocks (P2).

Prints one line per measurement beside the card's name and power limit,
and writes them all as JSON to ``--out`` (default build/sort_ab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import statistics
import tempfile
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.probes import bench_radix_ab as pa
from vk_gaussian_splatting_tpu_torch.probes import bench_roll as pr
from vk_gaussian_splatting_tpu_torch.probes import bench_sort_stage as ps
from vk_gaussian_splatting_tpu_torch.timing import call_ms, device_label

NAMES = ("bench_roll", "bench_sort_stage", "bench_radix_ab")
SOURCE_OF = {"P1": "bench_roll", "P2": "bench_radix_ab", "P3": "bench_sort_stage"}
CALLS = 7
SPARE = 13  # traced calls beyond CALLS, for the records a trace loses
SPIN_CYCLES = 50_000_000  # about 25 ms of the card's clock ahead of the traced calls
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"bench_roll": [_P, _I, _I, _I, _I, _P, _P],
             "bench_radix_ab": [_P, _I, _I, _I, _I, _I, _P, _P, _P]}


class Build(NamedTuple):
    libs: dict           # source name -> ctypes.CDLL
    plan: Callable       # P2's piece size (w, n_steps, steps_per_block) of its own package


class Case(NamedTuple):
    name: str
    probe: str                       # "P1", "P2" or "P3"
    check: Callable[[Build], None]   # raises unless the build equals the twin
    library: Callable[[], object]
    launch: Callable[[Build], object]
    copied: tuple | None             # P2: (copies, bytes) a launch moves


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


def piece_planner(module) -> Callable[[int, int, int], int]:
    """(w, n_steps, steps_per_block) -> the piece size that ``module``'s
    ``ring_of`` gives that launch (a module without ``per_sm_of`` plans
    one ring for every launch)."""
    if hasattr(module, "per_sm_of"):
        return lambda w, n, spb: module.ring_of(w, module.per_sm_of(n, spb))[0]
    return lambda w, n, spb: module.ring_of(w)[0]


def planner_beside(src: Path) -> Callable[[int, int, int], int]:
    """The piece planner of the package whose ``csrc/`` is ``src``: the
    ``probes/bench_radix_ab.py`` beside it, loaded under a name of its own."""
    path = src.resolve().parent / "probes" / "bench_radix_ab.py"
    spec = importlib.util.spec_from_file_location(
        f"_ab_radix_{hashlib.sha256(str(path).encode()).hexdigest()[:12]}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return piece_planner(module)


def entry(lib: ctypes.CDLL, symbol: str):
    fn = getattr(lib, symbol)
    fn.argtypes = _ARGTYPES.get(symbol, [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P])
    fn.restype = ctypes.c_int
    return fn


def kernel_alone_ms(call) -> float:
    """Median device ms of the kernel one call launches over its last CALLS
    records in a torch.profiler trace of a spin of SPIN_CYCLES clocks and
    then CALLS + SPARE calls, after a thrown-away warm-up step: on the card
    a window loses the records of its first milliseconds, warm-up step or
    not, and calls of a few microseconds all fall into them."""
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
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(CALLS + SPARE):
                call()
            torch.cuda.synchronize()
            prof.step()
        events = json.load(open(path))["traceEvents"]
    return [e["dur"] / 1e3 for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "kernel" and "spin_kernel" not in e.get("name", "")]


def _equal(want, launch):
    def check(build):
        if not torch.equal(launch(build), want):
            raise AssertionError("differs from the twin")
    return check


def sort_cases(rows_list, dev) -> list[Case]:
    """P1 and P3 at each row count."""
    out = []
    stream = torch.cuda.current_stream(dev).cuda_stream
    for rows in rows_list:
        x = pr.tiles_of(pr.FRAME_TILES, rows, 2048, dev, seed=1)

        def roll(build, x=x):
            y = torch.empty_like(x)
            err = entry(build.libs["bench_roll"], "bench_roll")(
                x.data_ptr(), x.shape[0], x.shape[1], x.shape[2], 1, y.data_ptr(), stream)
            if err:
                raise RuntimeError(f"bench_roll: cudaError {err}")
            return y

        def lib_roll(x=x):
            return torch.take_along_dim(x, torch.sort(x[:, 0], dim=-1).indices[:, None], dim=-1)

        out.append(Case(f"P1 {pr.FRAME_TILES} x ({rows}, 2048)", "P1",
                        _equal(pr.bitonic_sort_ref(x, 1), roll), lib_roll, roll, None))
        for variant in ps.VARIANTS:
            if variant == "sub8" and rows not in ps.SUB8_ROWS:
                continue
            x, m, sched = ps.inputs(variant, rows, 55, 2, dev)
            want = ps.sort_stages_ref(x, m, variant, sched, rows - 1)
            table = torch.tensor(sched, dtype=torch.int32, device=dev)

            def stage(build, x=x, m=m, variant=variant, table=table, rows=rows):
                y = torch.empty_like(x)
                err = entry(build.libs["bench_sort_stage"],
                            "bench_sort_stage_" + variant.replace("-", "_"))(
                    x.data_ptr(), 0 if m is None else m.data_ptr(), table.data_ptr(), 55,
                    x.shape[0], rows, rows - 1, ps.STEPS, y.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"bench_sort_stage {variant}: cudaError {err}")
                return y

            flat = x.reshape(2, rows, -1).repeat(ps.STEPS, 1, 1)

            def lib_stage(flat=flat, rows=rows):
                order = torch.sort(flat[:, rows - 1], dim=-1).indices
                return torch.take_along_dim(flat, order[:, None], dim=-1)

            out.append(Case(f"P3 {variant} {ps.STEPS} x 2 x ({rows}, 1024)", "P3",
                            _equal(want, stage), lib_stage, stage, None))
    return out


def copy_cases(widths, dev) -> list[Case]:
    """P2 at each W, in one block and across the card (one step a block)."""
    out = []
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.randn((pa.SRC_BLOCKS, *pa.BLOCK), generator=g, device=dev)
    n_steps, n_copies = pa.N_STEPS, pa.N_COPIES

    def copies(build, w, steps, spb, trace=None):
        res = torch.empty((1, *pa.BLOCK), dtype=torch.float32, device=dev)
        err = entry(build.libs["bench_radix_ab"], "bench_radix_ab")(
            src.data_ptr(), steps, spb, n_copies, w, build.plan(w, steps, spb), res.data_ptr(),
            0 if trace is None else trace.data_ptr(), stream)
        if err:
            raise RuntimeError(f"bench_radix_ab W={w}: cudaError {err}")
        return res

    for w in widths:
        want = pa.dma_copies_ref(src, n_steps, n_copies, w)
        few_out, few = pa.dma_copies_ref(src, 4, n_copies, w, trace=True)
        idx = torch.tensor([o + b for o in pa.copy_offsets(n_steps, n_copies)
                            for b in range(w)], device=dev)

        def library(idx=idx):
            return torch.index_select(src, 0, idx)

        for spb, mode in ((n_steps, "one block"), (1, f"{n_steps} blocks")):
            def launch(build, w=w, spb=spb):
                return copies(build, w, n_steps, spb)

            def check(build, w=w, spb=spb, want=want, few_out=few_out, few=few):
                trace = torch.empty_like(few)
                small = copies(build, w, 4, min(spb, 4), trace)
                if not (torch.equal(launch(build), want) and torch.equal(small, few_out)
                        and torch.equal(trace, few)):
                    raise AssertionError("differs from the twin")

            out.append(Case(f"P2 W={w} {mode}, {n_steps} x {n_copies} copies", "P2", check,
                            library, launch,
                            (n_steps * n_copies, n_steps * n_copies * w * pa.BLOCK_BYTES)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--probes", default="P1,P2,P3")
    ap.add_argument("--rows", default="2,16")
    ap.add_argument("--widths", default=",".join(map(str, pa.WIDTHS)))
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default="build/sort_ab.json")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = device_label(dev)
    probes = args.probes.split(",")
    names = sorted({SOURCE_OF[p] for p in probes})
    builds = {"tree": Build({n: _build.load(n) for n in names}, piece_planner(pa))}
    for spec in args.build:
        label, src = spec.split("=", 1)
        builds[label] = Build({n: build_other(Path(src), n) for n in names},
                              planner_beside(Path(src)) if "P2" in probes else None)
    others = [b for b in builds if b != "tree"]
    order = []
    for _ in range(args.turns):
        order += others + ["tree", "tree"] + others
    if not others:
        order = ["tree"] * args.turns
    all_cases = []
    if "P1" in probes or "P3" in probes:
        all_cases += [c for c in sort_cases([int(r) for r in args.rows.split(",")], dev)
                      if c.probe in probes]
    if "P2" in probes:
        all_cases += copy_cases([int(w) for w in args.widths.split(",")], dev)
    results = []
    for case in all_cases:
        lib_ms = statistics.median(call_ms(case.library, dev, CALLS))
        what = "torch.index_select" if case.probe == "P2" else "torch.sort + take_along_dim"
        print(f"{case.name} ({card}): library_ms ({what})={lib_ms:.4f}", flush=True)
        results.append(dict(case=case.name, build="library", events_ms=lib_ms))
        for label in order:
            build = builds[label]
            try:
                case.check(build)
            except AssertionError as e:
                raise AssertionError(f"{case.name}: build {label} {e}") from None
            torch.cuda.synchronize()
            alone = kernel_alone_ms(lambda: case.launch(build))
            events = statistics.median(call_ms(lambda: case.launch(build), dev, CALLS))
            rate = ""
            if case.copied:
                n, nbytes = case.copied
                rate = (f" ns_per_copy={alone * 1e6 / n:.2f} GB/s={nbytes / alone / 1e6:.1f} "
                        "(alone)")
            print(f"{case.name} ({card}) build {label}: kernel_alone_ms={alone:.4f} "
                  f"events_ms={events:.4f}{rate} (bit-equal to the twin)", flush=True)
            results.append(dict(case=case.name, build=label, kernel_alone_ms=alone,
                                events_ms=events))
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
