"""The card's peaks and the arithmetic of every ``*_roofline`` and ``mfu``
metric. What a frame or a step of one response model needs is counted in
``work/<model>.py``.

Counts come from the cell's inputs and the plain reference, never from the
program's counters, so a change to the program's culls or layouts cannot
change them. A kernel's bound is the larger of its operations over the
float32 peak and its bytes over the memory bandwidth; every input byte is
counted read once and every output byte written once.

Peaks (NVIDIA H100 SXM data sheet, dense, without sparsity, at the full
700 W): 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

import dataclasses

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Adam per parameter: the two moments 7, the bias corrections 2, the
# square root 1, the quotient and step 4
OPS_ADAM = 14
# the 3DGS loss per pixel and channel, forward and backward: L1 3 + 3, SSIM's
# five blurred maps of two 11-tap passes (5 * 2 * 22 = 220) and the ratio
# 20, its backward twice that
OPS_LOSS = 6 + 3 * 240
FLOATS_PER_SPLAT = 3 + 3 + 4 + 1 + 3 + 45    # raw fields at SH degree 3: 59


@dataclasses.dataclass(frozen=True)
class Work:
    ops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.bytes + other.bytes)

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the two bounds."""
        return max(self.ops / PEAK_F32_FLOPS, self.bytes / PEAK_BYTES_PER_S)


def optimizer_and_loss(splats: int, pixels: int) -> Work:
    """Adam over every parameter and the loss over every pixel: the step
    reads the parameters, Adam's two moments and the target, and writes
    the three back; the gradients are its own intermediates."""
    return Work(splats * OPS_ADAM * FLOATS_PER_SPLAT + pixels * 3 * OPS_LOSS,
                splats * FLOATS_PER_SPLAT * 4 * 6 + pixels * 3 * 4)


def share_percent(work: Work, seconds: float) -> float | None:
    """100 * bound / measured, or None where nothing was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * work.bound_s() / seconds
