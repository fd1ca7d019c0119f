"""Each bandwidth kernel alone on the card, beside the bound its bytes set.

    python -m vk_gaussian_splatting_tpu_torch.kernel_time

The benchmark (``python3 -m splatbench.run``) measures the cells end to end
and per layer, and its traced breakdowns name each kernel's device time;
no reader there yet sets a kernel beside its bound. This does, for the
kernels whose bound is their bytes: the SH radiance pair
(csrc/sh_radiance.cu) and the EWA projection pair (csrc/ewa_project.cu), at
the splat counts of the cells that run them. Each wrapper makes one launch
a call; ``CALLS`` calls run back to back between two CUDA events, so the
card's queue hides the host's launch cost wherever the kernel takes longer
than its launch, and the median over ``REPS`` such runs, per call, is the
kernel's time. Its bytes are counted from the tensors it reads and the
tensors it returns, each once (not from the program's counters); the bound
is those bytes at ``HBM_BYTES_PER_S``. Prints the card's name and power
limit, then one JSON line a kernel and size. Correctness is not checked
here: chip_smoke.py holds these kernels against their plain versions at
the same sizes.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from .timing import device_label

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3 (NVIDIA's data sheet)
CALLS, REPS = 20, 5
SH_SPLATS = (6_130_000, 1_000_000)     # the 3DGS cells' scene; the 3DGUT trainer's
EWA_SPLATS = (6_130_000, 15_300_000)   # the 3DGS cells' scene; the hybrid cell's
# the view cells' share and log-scale range of small, mid and large splats
# (splatbench/configs/inria_bicycle_6m.json's mix), in a cube of half-size 4
MIX = ((0.969, (-7.0, -5.0)), (0.025, (-5.0, -3.5)), (0.006, (-3.5, -2.0)))
EXTENT = 4.0


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(read, written) -> float:
    """The time ``read`` and ``written`` take at the card's HBM rate, each
    moved once."""
    return (nbytes(read) + nbytes(written)) / HBM_BYTES_PER_S * 1e3


def kernel_ms(fn, calls: int = CALLS, reps: int = REPS) -> float:
    """Median over ``reps`` runs of ``calls`` back-to-back calls of ``fn``
    between two CUDA events, per call."""
    fn()
    runs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / calls)
    return statistics.median(runs)


def reading(kernel: str, n: int, fn, read) -> dict:
    """One kernel's line: its time, its bytes (``read`` and what ``fn``
    returns), its bound and the share of the bound it reaches."""
    out = fn()
    written = out if isinstance(out, (tuple, list)) else (out,)
    ms, bound = kernel_ms(fn), bound_ms(read, written)
    return dict(kernel=kernel, splats=n, ms=ms, bytes=nbytes(read) + nbytes(written),
                bound_ms=bound, share_of_bound=bound / ms)


def sh_readings(dev, n: int) -> list[dict]:
    """The SH radiance pair at SH 3 in f32 over ``n`` splats."""
    from .ops import sh as tsh

    g = torch.Generator(device=dev).manual_seed(n)
    sh = torch.randn((n, 15, 3), generator=g, device=dev) * 0.3
    means = torch.rand((n, 3), generator=g, device=dev) * 6.0 - 3.0
    color = torch.rand((n, 4), generator=g, device=dev) * 1.3 - 0.3
    pos = torch.tensor([0.3, -0.2, -7.0], device=dev)
    d_rgb = torch.randn((n, 3), generator=g, device=dev)
    args = (sh, means, color, pos, 15, False)
    return [reading("sh_radiance_fwd", n, lambda: tsh.sh_radiance_fwd(*args),
                    (sh, means, color)),
            reading("sh_radiance_bwd", n, lambda: tsh.sh_radiance_bwd(*args, d_rgb),
                    (sh, means, color, d_rgb))]


def ewa_readings(dev, n: int) -> list[dict]:
    """The EWA projection pair over ``n`` splats of the view cells' mix, SH
    0, seen by the headline 1080p camera."""
    import vk_gaussian_splatting_tpu_torch as gt
    from .ops import projection as tproj
    from .scene.splat_set import SplatSet, random_splats

    parts, left = [], n
    for i, (share, scales) in enumerate(MIX):
        count = int(n * share) if i < len(MIX) - 1 else left
        left -= count
        parts.append(random_splats(torch.Generator(device=dev).manual_seed(3 * n + i), count,
                                   sh_degree=0, extent=EXTENT, scale_range=scales))
    prep = SplatSet(**{f: torch.cat([getattr(p, f) for p in parts])
                       for f in ("means", "scales", "quats", "opacities", "sh_dc",
                                 "sh_rest")}).prepare()
    del parts
    cfg = gt.RenderConfig(width=1920, height=1080, sh_degree=0)
    cam = gt.look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height, fov_y_rad=0.9,
                     device=dev)
    g = torch.Generator(device=dev).manual_seed(n)
    cots = [torch.randn(shape, generator=g, device=dev) for shape in ((n, 2), (n, 3), (n,), (n,))]
    inputs = (prep.means, prep.cov3d, prep.color)
    return [reading("ewa_project_fwd", n,
                    lambda: tproj.ewa_project(*inputs, prep.scales_log, cam, cfg), inputs),
            reading("ewa_project_bwd", n,
                    lambda: tproj.ewa_project_bwd(*inputs, cam, cfg, *cots), (*inputs, *cots))]


def main(device: str = "cuda") -> int:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"kernel_time runs only on a CUDA card, not on {device}")
    print(device_label(dev), flush=True)
    for readings, sizes in ((sh_readings, SH_SPLATS), (ewa_readings, EWA_SPLATS)):
        for n in sizes:
            for line in readings(dev, n):
                print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
