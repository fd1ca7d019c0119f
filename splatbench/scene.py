"""The benchmark's scenes, made on the device from the seed.

``random_splats`` draws the distributions of the repository's synthetic
splat sets; ``bench_scene`` mixes small, mid and large splats in the
96.9 / 2.5 / 0.6 % proportions of the repository's trained-statistics
headline scene (SH degree 3); ``jittered_start`` is where training starts:
the scene with seeded noise on the means and the base colours. Every field
is a plain float32 tensor; the program and the reference are handed the
same tensors (or copies of them).
"""

from __future__ import annotations

import torch

FIELDS = ("means", "scales", "quats", "opacities", "sh_dc", "sh_rest")
SH_REST = {0: 0, 1: 3, 2: 8, 3: 15}


def random_splats(generator: torch.Generator, n: int, sh_degree: int, extent: float,
                  scale_range) -> dict:
    """{field: tensor} of ``n`` splats on the generator's device: means
    uniform in the cube of half-size ``extent``, log-scales uniform in
    ``scale_range``, normal quaternions, logit opacities uniform in [-2, 4),
    base SH normal (0.8), higher SH normal (0.1)."""
    m = SH_REST[sh_degree]
    kw = dict(generator=generator, device=generator.device, dtype=torch.float32)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **kw) * (hi - lo) + lo

    return dict(
        means=uniform((n, 3), -extent, extent),
        scales=uniform((n, 3), *scale_range),
        quats=torch.randn((n, 4), **kw),
        opacities=uniform((n,), -2.0, 4.0),
        sh_dc=torch.randn((n, 3), **kw) * 0.8,
        sh_rest=torch.randn((n, m, 3), **kw) * 0.1,
    )


def bench_scene(device, n: int, seed: int, sh_degree: int, extent: float, mix) -> dict:
    """{field: tensor} of ``n`` splats in ``mix``: a list of (share, log-scale
    low, log-scale high); the last part takes the remainder. Part ``i`` is
    drawn from the generator seeded ``3 * seed + i``."""
    counts = [int(n * share) for share, _, _ in mix[:-1]]
    counts.append(n - sum(counts))
    parts = []
    for i, (count, (_, lo, hi)) in enumerate(zip(counts, mix)):
        g = torch.Generator(device=device).manual_seed(seed * 3 + i)
        parts.append(random_splats(g, count, sh_degree, extent, (lo, hi)))
    return {f: torch.cat([p[f] for p in parts]) for f in FIELDS}


def jittered_start(truth: dict, device, seed: int, means_sigma: float, sh_dc_sigma: float) -> dict:
    """A copy of ``truth`` with seeded normal noise on the means and the
    base colours (generator seeded ``seed + 100``)."""
    g = torch.Generator(device=device).manual_seed(seed + 100)
    out = {f: truth[f].detach().clone() for f in FIELDS}
    out["means"] += means_sigma * torch.randn(out["means"].shape, generator=g, device=device)
    out["sh_dc"] += sh_dc_sigma * torch.randn(out["sh_dc"].shape, generator=g, device=device)
    return out
