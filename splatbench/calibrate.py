"""The readings that the limits of ``correct`` are set from, at a cell's
own size, several seeds in one process (set-up is long):

    python3 -m splatbench.calibrate --workload <name> --seeds 1 2 3

For each seed it runs the cell's own runner (``kinds/<kind>.py``) once per
variant, each with a window of one pass over the camera path (seconds 0),
and prints one JSON line with what ``checks.judge`` compares, each number
beside its limit:

- ``program``: the program as the cell runs it;
- ``control``: in a view cell the program with its own bfloat16 tier
  switched on (``pair_format="packed"``); in a training cell, which has no
  such tier, the reference computed with bfloat16 storage in the
  program's place (faults.reference_step);
- the faults: in a view cell ``altered`` (faults.altered_render); in a
  training cell ``unchanged`` (faults.unchanged_step) and ``half_batch``
  (faults.half_batch_step).

The benchmark's own runs never run these.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from splatbench import checks, faults, spec, workloads


def variants(traffic: dict) -> list:
    """(name, traffic, Program) of every variant a cell of ``traffic`` reads."""
    program = workloads.Program()
    if traffic["kind"] == "view":
        return [("program", traffic, program),
                ("control", workloads.with_raster(traffic, pair_format="packed"), program),
                ("altered", traffic, workloads.Program(render=faults.altered_render))]
    control = faults.reference_step(workloads.reference(traffic))
    return [("program", traffic, program),
            ("control", traffic, workloads.Program(train_step=control)),
            ("unchanged", traffic, workloads.Program(train_step=faults.unchanged_step)),
            ("half_batch", traffic, workloads.Program(train_step=faults.half_batch_step))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device")
    dev = torch.device("cuda", 0)
    runner = workloads.kind(cell["traffic"])
    for seed in args.seeds:
        for name, traffic, program in variants(cell["traffic"]):
            t0 = time.perf_counter()
            out = runner.run(cell["config"], traffic, seed, 0.0, False, dev, t0, program)
            ok, compared = checks.judge(dict(out.numbers, failed=out.failed), traffic["limits"])
            print(json.dumps(dict(workload=args.workload, seed=seed, variant=name, correct=ok,
                                  checks=compared, attempted=out.attempted, notes=out.notes,
                                  seconds=time.perf_counter() - t0)), flush=True)
            del out
            workloads.free(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
