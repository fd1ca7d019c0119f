"""Profiling: named frame-section timers speaking the reference's stdout
Timer grammar so benchmark.py-style parsers work unchanged.

The reference prints (nvutils::Profiler benchmark mode, parsed by
benchmark.py:21):

    Timer "GPU Dist"; GPU; avg 1234; min 1200; max 1300; CPU; avg 1300; ...

with averages, minima and maxima in microseconds. On a CUDA device the GPU
column is the time between two CUDA events recorded around the section on
the current stream, and the CPU column is the host clock around the section
after the end event has been synchronised (so it includes the host's
dispatch and the wait). On the CPU both columns are the host clock.
"""

from __future__ import annotations

import contextlib
import time

import torch


class FrameTimers:
    """Accumulates per-stage times across frames; prints Timer lines.

    device: where the sections run (a ``torch.device``); CUDA events time
    the GPU column only there."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.gpu: dict[str, list[float]] = {}
        self.cpu: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield
        if cuda:
            end.record()
            end.synchronize()
        host = time.perf_counter() - t0
        self._add(name, start.elapsed_time(end) * 1e-3 if cuda else host, host)

    def add(self, name: str, seconds: float):
        """One sample of ``seconds`` in both columns (a time the caller took)."""
        self._add(name, seconds, seconds)

    def _add(self, name: str, gpu_s: float, cpu_s: float):
        self.gpu.setdefault(name, []).append(gpu_s)
        self.cpu.setdefault(name, []).append(cpu_s)

    def reset(self):
        self.gpu.clear()
        self.cpu.clear()

    def avg_us(self, name: str) -> int:
        """The GPU column's average of ``name`` in whole microseconds."""
        xs = self.gpu.get(name, [])
        return int(sum(xs) / max(len(xs), 1) * 1e6)

    def print_timers(self, out=print):
        """Reference Timer grammar (benchmark.py:21 regex)."""

        def cols(xs):
            return (int(sum(xs) / len(xs) * 1e6), int(min(xs) * 1e6), int(max(xs) * 1e6))

        for name in self.gpu:
            g, c = cols(self.gpu[name]), cols(self.cpu[name])
            out(f'Timer "{name}"; GPU; avg {g[0]}; min {g[1]}; max {g[2]}; '
                f'CPU; avg {c[0]}; min {c[1]}; max {c[2]};')
