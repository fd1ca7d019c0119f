"""Which device an entry point works on.

The port runs on the card: an entry point that makes tensors (a camera, a
loaded scene, arrays handed over from numpy) uses the CUDA device unless
the caller names another one. Without a card it raises; it never quietly
falls back to the CPU. Tests and CPU users pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` when given, else the current CUDA device; raises when
    neither is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "asked for another device (pass device='cpu')")
    return torch.device("cuda", torch.cuda.current_device())
