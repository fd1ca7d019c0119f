"""Depth-key encoding (counterpart of ``vk_gaussian_splatting_tpu/ops/sort.py:21-44``).

The reference encodes view depth into an order-preserving uint32
(dist.comp.slang:33-38 ``encodeMinMaxFp32``: flip the sign bit for
positives, flip all bits for negatives). torch has no general uint32, so
the key comes back as int64 in [0, 2^32), ready to sit under a tile index in
one int64 sort key (ops/binning.py).
"""

from __future__ import annotations

import torch


def encode_minmax_f32(val: torch.Tensor) -> torch.Tensor:
    """fp32 -> order-preserving unsigned 32-bit key, held in int64."""
    bits = val.to(torch.float32).contiguous().view(torch.int32)
    flipped = bits ^ ((bits >> 31) | -2147483648)  # 0x80000000
    return flipped.to(torch.int64) & 0xFFFFFFFF
