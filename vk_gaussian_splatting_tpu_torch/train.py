"""Differentiable splat optimization (counterpart of
``vk_gaussian_splatting_tpu/train.py:36-260``).

The standard 3DGS recipe on the port:

- loss = (1-λ) L1 + λ D-SSIM (INRIA defaults, λ=0.2), the JAX package's
  window, edge padding and separable-blur order;
- ``torch.optim.Adam`` with one parameter group per SplatSet field and the
  JAX learning rates (positions scaled by the scene extent), eps 1e-15;
- ``train_step``: render, loss, backward (through the blend's backward
  kernel on a card), Adam. It updates the splats' leaf tensors in place,
  the PyTorch idiom, where the JAX step returns new arrays.

Densification and pruning change N and return a new SplatSet; the caller
rebuilds the optimizer then, as in JAX. Checkpoints are ``torch.save`` of
the splats, the optimizer state and the step, written atomically. Nothing
here needs optax or orbax.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.config import RenderConfig
from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.render.pipelines import render
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera
from vk_gaussian_splatting_tpu_torch.scene.splat_set import SplatSet, prepare_splats

FIELDS = ("means", "scales", "quats", "opacities", "sh_dc", "sh_rest")


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 11, sigma: float = 1.5,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM with the standard 11x11 Gaussian window (sigma 1.5) over
    channels-last (H, W, C) images. The blur is separable — rows first, then
    columns — over edge-padded images, as shifted weighted sums in the JAX
    package's order; no convolution, so no TF32 path can reach it. The five
    blurred images go through one stacked blur. The edge padding repeats
    the border by ``expand`` and ``cat``, whose backward sums with plain
    reductions: a gather of repeated indices (or F.pad's replicate mode)
    would add its gradient back with atomics, which do not repeat bit for
    bit on a card."""
    r = torch.arange(window, dtype=torch.float32, device=a.device) - (window - 1) / 2.0
    k = torch.exp(-0.5 * (r / sigma) ** 2)
    k = k / torch.sum(k)
    pad = window // 2

    def blur(x):                                   # (S, H, W, C)
        for axis in (1, 2):
            size = x.shape[axis]
            reps = [-1] * x.dim()
            reps[axis] = pad
            xp = torch.cat([x.narrow(axis, 0, 1).expand(reps), x,
                            x.narrow(axis, size - 1, 1).expand(reps)], dim=axis)
            out = torch.zeros_like(x)
            for i in range(window):
                out = out + k[i] * xp.narrow(axis, i, size)
            x = out
        return x

    mu_a, mu_b, aa, bb, ab = blur(torch.stack([a, b, a * a, b * b, a * b]))
    var_a = aa - mu_a * mu_a
    var_b = bb - mu_b * mu_b
    cov = ab - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return torch.mean(s)


def rgb_loss(pred: torch.Tensor, target: torch.Tensor,
             ssim_lambda: float = 0.2) -> torch.Tensor:
    """(1-λ) L1 + λ (1 - SSIM) — the 3DGS training loss."""
    return ((1.0 - ssim_lambda) * l1_loss(pred, target)
            + ssim_lambda * (1.0 - ssim(pred, target)))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_means: float = 1.6e-4      # x scene extent
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacities: float = 5e-2
    lr_sh_dc: float = 2.5e-3
    lr_sh_rest: float = 2.5e-3 / 20
    ssim_lambda: float = 0.2
    scene_extent: float = 1.0


def make_optimizer(splats: SplatSet, tc: TrainConfig) -> torch.optim.Adam:
    """Adam over the splats' six fields, one parameter group each, with the
    JAX package's learning rates, betas (0.9, 0.999) and eps 1e-15. The
    fields must be leaf tensors; they are set to require grad."""
    lrs = dict(means=tc.lr_means * tc.scene_extent, scales=tc.lr_scales,
               quats=tc.lr_quats, opacities=tc.lr_opacities, sh_dc=tc.lr_sh_dc,
               sh_rest=tc.lr_sh_rest)
    groups = []
    for f in FIELDS:
        p = getattr(splats, f)
        if not p.is_leaf:
            raise ValueError(f"splats.{f} is not a leaf tensor: detach it first")
        groups.append({"params": [p.requires_grad_()], "lr": lrs[f], "name": f})
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)


def train_step(splats: SplatSet, optimizer: torch.optim.Optimizer, cam: Camera,
               target: torch.Tensor, cfg: RenderConfig, max_pairs: int,
               tc: TrainConfig):
    """One optimization step; returns (loss, overflow) as 0-d tensors.

    Updates ``splats``' tensors in place through ``optimizer``
    (``make_optimizer(splats, tc)``). overflow is the binning truncation
    flag of the rendered frame — when it fires, part of the image trained
    against truncated splat coverage; the caller should re-render with
    expansion="exact" / a larger slots_k or treat the step as suspect.
    Its stages run under ``torch.profiler`` spans (``timing.span``):
    prepare, render's own (project, bin, rays for 3DGUT, blend, assemble,
    and their children), loss, backward and optimizer. Inside backward
    (on a card, on autograd's device thread): backward.gather (the
    binning's sort-based gather backward) and backward.blend (the blend's
    backward kernel, K2 / K2g / K4 / K4g, with its context). A packed
    config (``pair_format="packed"``, forward only) raises
    NotImplementedError at the backward, before the optimizer moves."""
    with timing.span("prepare"):
        optimizer.zero_grad(set_to_none=True)
        prepared = prepare_splats(splats, cfg.sh_format)
    out = render(prepared, cam, cfg, max_pairs)
    with timing.span("loss"):
        loss = rgb_loss(out.image, target, tc.ssim_lambda)
    with timing.span("backward"):
        loss.backward()
    with timing.span("optimizer"):
        optimizer.step()
    return loss.detach(), out.overflow


def prune_splats(splats: SplatSet, min_opacity: float = 0.005) -> SplatSet:
    """Drop splats whose activated opacity fell below threshold. Changes N:
    rebuild the optimizer afterwards."""
    with torch.no_grad():
        keep = torch.nonzero(torch.sigmoid(splats.opacities) > min_opacity).flatten()
        return SplatSet(**{f: getattr(splats, f).detach()[keep].contiguous()
                           for f in FIELDS})


def densify_split(splats: SplatSet, grad_means: torch.Tensor,
                  grad_threshold: float = 2e-4,
                  scale_threshold: float = 0.01,
                  n_split: int = 2,
                  seed: int = 0) -> SplatSet:
    """Clone-or-split densification (the 3DGS adaptive-density heuristic;
    host-side numpy, the JAX package's arithmetic and its
    ``numpy.random.RandomState(seed)`` children, so both packages grow the
    same splats). Changes N: rebuild the optimizer afterwards.

    - **clone** (under-reconstruction: high positional gradient, small
      splat): duplicate the splat as-is.
    - **split** (over-reconstruction: high gradient, large splat): REPLACE
      the splat by n_split children sampled from its own Gaussian, scales
      divided by 1.6, with opacity renormalized so the composite alpha of
      the stack matches the parent: o' = 1 - (1 - o)^(1/n).
    """
    src = {f: getattr(splats, f).detach().cpu().numpy() for f in FIELDS}
    g = np.linalg.norm(grad_means.detach().cpu().numpy(), axis=1)
    lin_scales = np.exp(src["scales"])
    big = lin_scales.max(axis=1) > scale_threshold
    select = g > grad_threshold
    if not select.any():
        return splats
    clone_idx = np.nonzero(select & ~big)[0]
    split_idx = np.nonzero(select & big)[0]
    keep_idx = np.nonzero(~(select & big))[0]  # split parents are removed

    parts = {f: [src[f][keep_idx], src[f][clone_idx]] for f in FIELDS}
    if len(split_idx):
        rng = np.random.RandomState(seed)
        k = len(split_idx)
        q = src["quats"].astype(np.float64)[split_idx]
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        rot = np.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ], axis=1).reshape(k, 3, 3).astype(np.float32)
        o_act = 1.0 / (1.0 + np.exp(-src["opacities"][split_idx]))
        o_new = np.clip(1.0 - (1.0 - o_act) ** (1.0 / n_split), 1e-4, 1.0 - 1e-4)
        sig_new = np.log(o_new / (1.0 - o_new)).astype(np.float32)
        for _ in range(n_split):
            canon = rng.normal(size=(k, 3)).astype(np.float32) * lin_scales[split_idx]
            parts["means"].append(src["means"][split_idx]
                                  + np.einsum("nij,nj->ni", rot, canon))
            parts["scales"].append(src["scales"][split_idx] - np.float32(np.log(1.6)))
            parts["quats"].append(src["quats"][split_idx])
            parts["opacities"].append(sig_new)
            parts["sh_dc"].append(src["sh_dc"][split_idx])
            parts["sh_rest"].append(src["sh_rest"][split_idx])
    return SplatSet(**{f: torch.from_numpy(np.concatenate(parts[f])).to(splats.means.device)
                       for f in FIELDS})


def reset_opacities(splats: SplatSet, ceiling: float = 0.01) -> SplatSet:
    """Clamp activated opacities to <= ceiling (the periodic opacity reset of
    3DGS training). A new SplatSet: rebuild the optimizer afterwards."""
    sig_ceiling = torch.log(torch.tensor(ceiling / (1.0 - ceiling), dtype=torch.float32))
    fields = {f: getattr(splats, f).detach().clone() for f in FIELDS}
    fields["opacities"] = torch.minimum(fields["opacities"],
                                        sig_ceiling.to(fields["opacities"].device))
    return SplatSet(**fields)


# ---------------------------------------------------------------------------
# Checkpoint / resume: splat parameters + optimizer state + step
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, splats: SplatSet, optimizer: torch.optim.Optimizer,
                    step: int) -> None:
    """Write a training checkpoint to ``path`` atomically: a temporary file
    in the same directory, then ``os.replace``."""
    state = {"splats": {f: getattr(splats, f).detach().cpu() for f in FIELDS},
             "optimizer": optimizer.state_dict(), "step": int(step)}
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, tc: TrainConfig, device: torch.device | str | None = None):
    """Restore (splats, optimizer, step) saved by save_checkpoint, on
    ``device`` (default: the card). The optimizer is rebuilt for the loaded
    splats with ``make_optimizer`` and then takes the saved state."""
    device = resolve_device(device)
    state = torch.load(path, map_location=device, weights_only=True)
    splats = SplatSet(**{f: state["splats"][f].contiguous() for f in FIELDS})
    optimizer = make_optimizer(splats, tc)
    optimizer.load_state_dict(state["optimizer"])
    return splats, optimizer, int(state["step"])


__all__ = [
    "TrainConfig", "densify_split", "l1_loss", "load_checkpoint", "make_optimizer",
    "prune_splats", "reset_opacities", "rgb_loss", "save_checkpoint", "ssim",
    "train_step",
]
