"""The training step in plain PyTorch float32: the loss, its gradients by
autograd through a reference frame (``gs3d``, ``gut3d``), and Adam.

- loss: (1 - lambda) L1 + lambda (1 - SSIM), lambda 0.2 (Kerbl et al.
  2023); SSIM with an 11 x 11 Gaussian window of sigma 1.5, applied as
  two 1-D passes over edge-replicated images, C1 = 0.01^2, C2 = 0.03^2,
  the mean over pixels and channels;
- Adam (Kingma and Ba 2015) with betas (0.9, 0.999), eps 1e-15 and a
  learning rate per field, bias-corrected as ``torch.optim.Adam`` states
  it: p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from splatbench.reference import gs3d

BETAS = (0.9, 0.999)
EPS = 1e-15


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 11, sigma: float = 1.5,
         c1: float = 0.01 ** 2, c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images."""
    r = torch.arange(window, dtype=torch.float32, device=a.device) - (window - 1) / 2.0
    k = torch.exp(-0.5 * (r / sigma) ** 2)
    k = k / k.sum()
    pad = window // 2
    x = torch.stack([a, b, a * a, b * b, a * b])              # (5, H, W, C)
    x = x.permute(0, 3, 1, 2).reshape(-1, 1, a.shape[0], a.shape[1])
    x = F.conv2d(F.pad(x, (0, 0, pad, pad), mode="replicate"), k.view(1, 1, window, 1))
    x = F.conv2d(F.pad(x, (pad, pad, 0, 0), mode="replicate"), k.view(1, 1, 1, window))
    mu_a, mu_b, aa, bb, ab = x.reshape(5, -1, a.shape[0], a.shape[1])
    var_a, var_b, cov = aa - mu_a * mu_a, bb - mu_b * mu_b, ab - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return s.mean()


def rgb_loss(pred: torch.Tensor, target: torch.Tensor, ssim_lambda: float) -> torch.Tensor:
    return ((1.0 - ssim_lambda) * torch.mean(torch.abs(pred - target))
            + ssim_lambda * (1.0 - ssim(pred, target)))


def train(start: dict, poses, targets, lrs: dict, ssim_lambda: float, model=gs3d,
          precision: str = "f32", background=(0.0, 0.0, 0.0)) -> dict:
    """``len(poses)`` Adam steps from ``start`` (raw splat fields), step i
    against ``targets[i]`` through ``poses[i]``, each frame ``model.render``.
    Returns the loss of each
    step, each field's first gradient and each field's change after the
    last step, the last two as norms, and how many of each field's
    elements the first step moved."""
    params = {f: v.detach().clone().requires_grad_() for f, v in start.items()}
    m = {f: torch.zeros_like(v) for f, v in start.items()}
    v2 = {f: torch.zeros_like(v) for f, v in start.items()}
    losses, grad1, moved1 = [], {}, {}
    for t, (pose, target) in enumerate(zip(poses, targets), start=1):
        frame = model.render(params, pose, precision, grad=True, background=background)
        loss = rgb_loss(frame.image, target, ssim_lambda)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        del frame, loss
        if t == 1:
            grad1 = {f: float(torch.linalg.vector_norm(g)) for f, g in grads.items()}
        with torch.no_grad():
            bc1, bc2 = 1.0 - BETAS[0] ** t, 1.0 - BETAS[1] ** t
            for f, g in grads.items():
                m[f].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v2[f].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                denom = v2[f].sqrt() / bc2 ** 0.5 + EPS
                params[f].addcdiv_(m[f], denom, value=-lrs[f] / bc1)
                if t == 1:
                    moved1[f] = int((params[f] != start[f]).sum())
        del grads
    change = {f: float(torch.linalg.vector_norm(params[f].detach() - start[f])) for f in params}
    return dict(losses=losses, grad1=grad1, change=change, moved1=moved1)
