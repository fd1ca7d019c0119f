"""CLI entry matching the reference app's benchmark invocation (benchmark.py:15):

    python -m vk_gaussian_splatting_tpu_torch.bench \\
        --size 1920 1080 --benchmark 1 --sequencefile benchmark_3dgs.cfg scene.ply

Loads the scene onto the card (``--device`` another one), replays the
SEQUENCE blocks, and prints the Timer / BENCHMARK_ADV grammar the
reference's benchmark.py parses.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", nargs=2, type=int, default=[1920, 1080])
    ap.add_argument("--benchmark", type=int, default=1)
    ap.add_argument("--sequencefile", type=str, required=True)
    ap.add_argument("--maxSplats", type=int, default=0,
                    help="optionally truncate the scene for quick runs")
    ap.add_argument("--camera", type=str, default="",
                    help="INRIA cameras.json; uses the first preset")
    ap.add_argument("--csv", type=str, default="",
                    help="write the per-sequence CSV report here")
    ap.add_argument("--chart", type=str, default="",
                    help="write the stacked per-stage chart (PNG) here")
    ap.add_argument("--method", type=str, default="",
                    help="override raster.method (bucket | pairs)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card)")
    ap.add_argument("scene", type=str)
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    from vk_gaussian_splatting_tpu_torch.bench.sequencer import (
        BenchmarkSequencer,
        parse_sequence_file,
    )
    from vk_gaussian_splatting_tpu_torch.devices import resolve_device
    from vk_gaussian_splatting_tpu_torch.io import import_cameras_inria, load_scene
    from vk_gaussian_splatting_tpu_torch.scene.cameras import look_at
    from vk_gaussian_splatting_tpu_torch.timing import device_label

    dev = resolve_device(args.device)
    splats = load_scene(args.scene, device=dev)
    if args.maxSplats:
        splats = dataclasses.replace(splats, **{
            f.name: getattr(splats, f.name)[:args.maxSplats]
            for f in dataclasses.fields(splats)})
    n = splats.num_splats
    print(f"Loaded {n} splats from {args.scene}")
    print(f"Device: {device_label(dev)}")

    w, h = args.size
    if args.camera:
        _, cam = import_cameras_inria(args.camera, device=dev)[0]
    else:
        means = splats.means.cpu().numpy()
        center = means.mean(axis=0)
        spread = float(np.abs(means - center).mean()) or 1.0
        eye = center + np.asarray([0.0, 0.0, -4.0 * spread])
        cam = look_at(eye, center, [0, 1, 0], w, h, fov_y_rad=0.9, device=dev)

    lines: list[str] = []

    def tee(msg=""):
        lines.append(str(msg))
        print(msg, flush=True)

    seq = BenchmarkSequencer(splats, w, h, cam, out=tee, device=dev)
    if args.method:
        seq.cfg = seq.cfg.replace(raster=dataclasses.replace(
            seq.cfg.raster, method=args.method))
    seq.run(parse_sequence_file(args.sequencefile))

    if args.csv:
        from vk_gaussian_splatting_tpu_torch.bench.report import write_report
        write_report("\n".join(lines), args.csv, scene=args.scene,
                     chart_path=args.chart or None)
        print(f"CSV report written to {args.csv}")


if __name__ == "__main__":
    sys.exit(main())
