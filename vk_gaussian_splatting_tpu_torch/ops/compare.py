"""Image comparison tool (counterpart of ``vk_gaussian_splatting_tpu/ops/compare.py``;
the reference's image_compare.{h,cpp} and image_compare_composite.comp.slang).

Capture a reference frame, composite split views in the reference's six
display modes, and track metric history for convergence charts (the
ImageCompare ring buffer)."""

from __future__ import annotations

import dataclasses
import enum

import torch

from vk_gaussian_splatting_tpu_torch.ops.metrics import flip, mse, psnr


class CompareMode(enum.IntEnum):
    """Split-view display modes (image_compare.h Parameters)."""

    CAPTURE = 0
    CURRENT = 1
    DIFF_RAW = 2
    DIFF_RED_ON_GRAY = 3
    DIFF_RED_ONLY = 4
    FLIP_HEATMAP = 5


def _viridis(t: torch.Tensor) -> torch.Tensor:
    """Small viridis-like colormap for the FLIP heatmap."""
    t = torch.clamp(t, 0.0, 1.0)[..., None]

    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=t.device)

    c0, c1, c2 = c([0.267, 0.005, 0.329]), c([0.128, 0.565, 0.551]), c([0.993, 0.906, 0.144])
    lo = c0 + (c1 - c0) * (t * 2.0)
    hi = c1 + (c2 - c1) * (t * 2.0 - 1.0)
    return torch.where(t < 0.5, lo, hi)


def composite(capture: torch.Tensor, current: torch.Tensor, mode: CompareMode,
              split_x: float = 0.5, amplify: float = 1.0) -> torch.Tensor:
    """Split-view composite: left of column ``int(split_x * w)`` shows the
    capture, right of it the selected comparison."""
    h, w = capture.shape[:2]
    if mode == CompareMode.CAPTURE:
        right = capture
    elif mode == CompareMode.CURRENT:
        right = current
    elif mode == CompareMode.DIFF_RAW:
        right = torch.clamp(torch.abs(current - capture) * amplify, 0, 1)
    elif mode == CompareMode.DIFF_RED_ON_GRAY:
        gray = torch.mean(capture, dim=-1, keepdim=True) * capture.new_ones((1, 1, 3))
        err = torch.clamp(torch.abs(current - capture).amax(dim=-1, keepdim=True) * amplify,
                          0, 1)
        red = torch.cat([torch.ones_like(err), torch.zeros_like(err), torch.zeros_like(err)], -1)
        right = gray * (1 - err) + red * err
    elif mode == CompareMode.DIFF_RED_ONLY:
        err = torch.clamp(torch.abs(current - capture).amax(dim=-1, keepdim=True) * amplify,
                          0, 1)
        right = torch.cat([err, torch.zeros_like(err), torch.zeros_like(err)], -1)
    elif mode == CompareMode.FLIP_HEATMAP:
        right = _viridis(flip(capture, current) * amplify)
    else:
        raise ValueError(mode)
    xs = torch.arange(w, device=capture.device)[None, :, None]
    return torch.where(xs < int(split_x * w), capture, right)


@dataclasses.dataclass
class MetricsSample:
    frame: int
    mse: float
    psnr: float
    flip_mean: float


class ImageCompare:
    """Capture + metrics-history tool (ImageCompare, image_compare.h:83-125);
    the history keeps the newest ``history`` samples."""

    def __init__(self, history: int = 256):
        self.captured: torch.Tensor | None = None
        self.history_len = history
        self.history: list[MetricsSample] = []
        self._frame = 0

    def capture(self, image: torch.Tensor) -> None:
        self.captured = image.detach().clone()
        self.history.clear()
        self._frame = 0

    def compute_metrics(self, current: torch.Tensor) -> MetricsSample:
        """MSE, PSNR and the plain mean of the FLIP map (not the Minkowski
        pool of ``flip_mean``, as the JAX tool records it) against the
        capture; appended to the history."""
        assert self.captured is not None, "capture a reference frame first"
        sample = MetricsSample(
            frame=self._frame,
            mse=float(mse(self.captured, current)),
            psnr=float(psnr(self.captured, current)),
            flip_mean=float(torch.mean(flip(self.captured, current))),
        )
        self.history.append(sample)
        if len(self.history) > self.history_len:
            self.history.pop(0)
        self._frame += 1
        return sample

    def render(self, current: torch.Tensor, mode: CompareMode,
               split_x: float = 0.5, amplify: float = 1.0) -> torch.Tensor:
        assert self.captured is not None, "capture a reference frame first"
        return composite(self.captured, current, mode, split_x, amplify)
