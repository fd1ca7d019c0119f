"""What L2 can deliver into shared memory: the measured ceiling of the copy
probe P2.

    python -m vk_gaussian_splatting_tpu_torch.probes.l2_fill [--out FILE]

P2 (``bench_radix_ab``) copies 256 x 64 copies of W (16, 128) f32 blocks at
block offsets that reach only the first 8 MB of its source, so after the
first pass L2 serves every copy, and ``chip_smoke.copy_bound`` prices them
at the SMs' fill rate, 128 B a clock each. How close the card comes to that
is not a published figure, so this sweep measures it with
csrc/l2_fill.cu: P2's 2.15 GB at W = 16 landing in shared memory by bulk
copies (at 1-4 blocks an SM, ring depths 2-8 and pieces of 8-64 KB, over
P2's 256 blocks and over a grid of blocks an SM x SMs), by 16-byte vector
loads and by cp.async, and one block alone at W = 1 and 16 (bulk copies
issued by 1 or 8 lanes). The source holds P2's data, normal floats from
a seed. Times are CUDA events around 10 launches back to back, the least
of 5; the best card-wide rate is the measured ceiling (a measurement, not
a bound), and that configuration is timed again by the kernel alone
(``sort_ab.kernel_alone_ms``), as P2's kernel is beside its parent. The
same configuration can run at different rates on another
allocation of the same bytes or on another card, so the best one is timed
again on AGAIN more copies of the source, each at an address of its own,
and their rates are reported beside the ceiling. Prints one line per
configuration beside the card's name, power limit and serial number, and
writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.probes.bench_radix_ab import (
    BLOCK,
    BLOCK_BYTES,
    N_COPIES,
    N_STEPS,
    SRC_BLOCKS,
)
from vk_gaussian_splatting_tpu_torch.probes.sort_ab import kernel_alone_ms
from vk_gaussian_splatting_tpu_torch.timing import call_ms, device_label

_P, _I = ctypes.c_void_p, ctypes.c_int
BACK_TO_BACK, TIMES, AGAIN = 10, 5, 3


def configs(sms: int) -> list[dict]:
    """The sweep: keyword arguments of ``fill`` for each configuration."""
    copies = N_STEPS * N_COPIES
    out = []
    for per_sm in (1, 2, 3, 4):
        for grid in (N_STEPS, per_sm * sms):
            for piece in (1, 2, 4, 8):
                for depth in (2, 3, 4, 6, 8):
                    if depth * piece * BLOCK_BYTES * per_sm <= 227 * 1024:
                        out.append(dict(method="bulk", grid=grid, per_sm=per_sm, copies=copies,
                                        w=16, piece=piece, depth=depth, lanes=1))
    for per_sm in (2, 3, 4):
        for grid in (N_STEPS, per_sm * sms):
            for u in (4, 8):
                out.append(dict(method="vector", grid=grid, per_sm=per_sm, copies=copies, w=16,
                                threads=256, u=u))
            for u, stages in ((2, 2), (4, 2), (2, 4)):
                out.append(dict(method="cpasync", grid=grid, per_sm=per_sm, copies=copies, w=16,
                                threads=256, u=u, stages=stages))
    for w, piece, depth in ((1, 1, 8), (1, 1, 16), (16, 1, 16), (16, 8, 3)):
        for lanes in (1, min(8, depth)):
            out.append(dict(method="bulk", grid=1, per_sm=1, copies=4096 // w, w=w, piece=piece,
                            depth=depth, lanes=lanes))
    return out


def fill(src: torch.Tensor, method: str, grid: int, per_sm: int, copies: int, w: int,
         piece: int = 1, depth: int = 1, lanes: int = 1, threads: int = 256, u: int = 4,
         stages: int = 2) -> None:
    """One launch of csrc/l2_fill.cu's ``method`` on src (N, 16, 128) f32."""
    stream = torch.cuda.current_stream(src.device).cuda_stream
    if method == "bulk":
        err = _build.entry("l2_fill", "l2_fill_bulk", [_P] + [_I] * 7 + [_P])(
            src.data_ptr(), grid, per_sm, copies, w, piece, depth, lanes, stream)
    elif method == "vector":
        err = _build.entry("l2_fill", "l2_fill_vector", [_P] + [_I] * 6 + [_P])(
            src.data_ptr(), grid, per_sm, copies, w, threads, u, stream)
    else:
        err = _build.entry("l2_fill", "l2_fill_cpasync", [_P] + [_I] * 7 + [_P])(
            src.data_ptr(), grid, per_sm, copies, w, threads, u, stages, stream)
    if err:
        raise RuntimeError(f"l2_fill {method}: cudaError {err}")


def card_serial() -> str:
    """The card's serial number, as nvidia-smi reports it."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=serial", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def run(device=None, out: str | None = None) -> dict:
    """The sweep; returns {"card", "serial", "results", "ceiling_gbs", "best",
    "alone_ms", "alone_gbs", "again_gbs"}."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("l2_fill measures the card: it has no CPU form")
    card, serial = device_label(dev), card_serial()
    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.randn((SRC_BLOCKS, *BLOCK), generator=g, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def timed(cfg: dict, source: torch.Tensor) -> dict:
        def burst():
            for _ in range(BACK_TO_BACK):
                fill(source, **cfg)

        ms = min(call_ms(burst, dev, TIMES, warmup=1)) / BACK_TO_BACK
        nbytes = cfg["copies"] * cfg["w"] * BLOCK_BYTES
        res = dict(cfg, ms=ms, gbs=nbytes / ms / 1e6, ns_per_copy=ms * 1e6 / cfg["copies"])
        print(f"l2_fill ({card}) {json.dumps(cfg)}: {ms:.4f} ms, {res['gbs']:.1f} GB/s, "
              f"{res['ns_per_copy']:.2f} ns/copy", flush=True)
        return res

    results = [timed(cfg, src) for cfg in configs(sms)]
    card_wide = [r for r in results if r["grid"] > 1]
    best = max(card_wide, key=lambda r: r["gbs"])
    print(f"measured ceiling ({card}, serial {serial}): {best['gbs']:.1f} GB/s "
          f"({best['ms']:.4f} ms for {best['copies'] * best['w'] * BLOCK_BYTES} B), "
          f"{json.dumps(best)}", flush=True)
    cfg = {k: best[k] for k in best if k not in ("ms", "gbs", "ns_per_copy")}
    alone = kernel_alone_ms(lambda: fill(src, **cfg))
    alone_gbs = best["copies"] * best["w"] * BLOCK_BYTES / alone / 1e6
    print(f"the same, kernel alone ({card}): {alone:.4f} ms, {alone_gbs:.1f} GB/s", flush=True)
    copies = [src.clone() for _ in range(AGAIN)]
    again = [timed(cfg, c)["gbs"] for c in copies]
    print(f"the same on {AGAIN} more allocations of the source ({card}): "
          + ", ".join(f"{g:.1f}" for g in again) + " GB/s", flush=True)
    report = {"card": card, "serial": serial, "results": results, "ceiling_gbs": best["gbs"],
              "best": best, "alone_ms": alone, "alone_gbs": alone_gbs, "again_gbs": again}
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(report, indent=1))
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/l2_fill.json")
    run(out=ap.parse_args().out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
