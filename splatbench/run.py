"""Run one cell of the benchmark once.

    python3 -m splatbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the fitted pair budget on an earlier
line, the numbers compared (each beside its limit) as the last lines on
standard error, and the result as the last line of standard output: one
JSON object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Exits non-zero, printing no result, without enough CUDA
devices, when the program or BENCHMARK.json is missing, or when a JAX
module is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vk_gaussian_splatting_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is a JAX
    one or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_label() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")


def metrics_line(cell: dict, out, traced: bool) -> dict:
    """The cell's metrics by name: its end-to-end ones from the timed
    window, or its per-layer ones from the traced window (a reader that
    finds nothing is left out). An end-to-end metric's quantity is its name
    before the first dot: ``train_steps_per_s.gut`` is the steps per second
    of the cells it lists, held to a bound of its own."""
    from splatbench import spec, workloads

    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    values = {}
    if traced:
        for m in cell["per_layer"]:
            v = spec.load_reader(m["name"])(out.summary)
            if v is not None:
                values[m["name"]] = v
    else:
        done = out.attempted - out.failed
        e2e = dict(setup_s=out.setup_s, device_mem_peak_gib=out.memory_peak_bytes / 2 ** 30,
                   frames_per_s=done / out.window_s,
                   frame_ms_p95=1e3 * workloads.percentile(out.times_s, 95),
                   train_steps_per_s=done / out.window_s)
        values = {m["name"]: e2e[m["name"].split(".")[0]] for m in cell["end_to_end"]}
    return {k: {"value": v, "unit": units[k]} for k, v in values.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from splatbench import spec

    try:
        bench = spec.load_benchmark()
        cell = spec.resolve(bench, args.workload)
    except (OSError, KeyError) as e:
        print(f"splatbench: {e}", file=sys.stderr)
        return 2
    chips = cell["workload"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"splatbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cache_dirs(spec.ROOT)
    torch.set_num_threads(4)
    try:
        from splatbench import workloads
    except ImportError as e:
        print(f"splatbench: the program is not importable: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    out = workloads.kind(cell["traffic"]).run(cell["config"], cell["traffic"], args.seed,
                                              args.seconds, bool(args.trace), dev, T_START)
    found = forbidden_modules()
    if found:
        print(f"splatbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3

    from splatbench.checks import judge

    ok, checks = judge(dict(out.numbers, failed=out.failed), cell["traffic"]["limits"])
    result = {"correct": ok, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics_line(cell, out, bool(args.trace)),
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                         "count": chips, "memory_peak_bytes": out.memory_peak_bytes,
                         "label": device_label()}}
    if args.trace:
        s = out.summary
        result["device"].update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": [[n, v] for n, v in s.top_ops],
                               "idle_gaps": [[n, v] for n, v in s.gaps]}
    result["checks"] = checks
    for note in out.notes:
        print(f"note: {note}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
