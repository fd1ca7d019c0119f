"""Timing on the card, and the card's label beside every number.

``chip_smoke.py`` and the probes time with ``call_ms`` and print
``device_label`` beside what they measured."""

from __future__ import annotations

import subprocess
import time
from typing import Callable

import torch


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    CPU's label (whose times are the host's clock, not a device's)."""
    if dev.type != "cuda":
        return f"{dev.type} (plain PyTorch twins; times on the host clock)"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def call_ms(fn: Callable[[], object], dev: torch.device, iters: int,
            warmup: int = 1) -> list[float]:
    """Milliseconds of each of ``iters`` calls of ``fn`` after ``warmup``
    calls: CUDA events around each call on the card, the host clock
    around each call on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times

