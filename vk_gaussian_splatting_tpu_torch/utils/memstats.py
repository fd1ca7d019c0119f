"""Memory statistics (H14, memory_statistics.{h,cpp} + memory_monitor_vk).

Byte accounting per category (Scene / Rasterization / Raytracing) printed in
the reference's BENCHMARK_ADV grammar (gaussian_splatting.cpp:2601-2617),
plus live device-memory queries through torch's CUDA caching allocator and
``cudaMemGetInfo`` (the VK_EXT_memory_budget analog, memory_monitor_vk.h:29-43).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def nbytes_of(tree) -> int:
    """Bytes of the tensors and numpy arrays in a dataclass / tuple / list /
    dict tree (other leaves count 0)."""
    return sum(x.element_size() * x.numel() if isinstance(x, torch.Tensor) else x.nbytes
               for x in _leaves(tree))


@dataclasses.dataclass
class MemoryCategory:
    host_used: int = 0
    device_used: int = 0
    device_alloc: int = 0


class MemoryStatistics:
    """Per-category byte accounting; benchmarkAdvance printing."""

    def __init__(self):
        self.categories: dict[str, MemoryCategory] = {
            "Scene": MemoryCategory(),
            "Rasterization": MemoryCategory(),
            "Raytracing": MemoryCategory(),
        }

    def set(self, category: str, host_used=0, device_used=0, device_alloc=None):
        c = self.categories.setdefault(category, MemoryCategory())
        c.host_used = int(host_used)
        c.device_used = int(device_used)
        c.device_alloc = int(device_alloc if device_alloc is not None
                             else device_used)

    def account_scene(self, splats, prepared):
        """Host = raw parameter arrays; device = prepared render arrays."""
        self.set("Scene", host_used=nbytes_of(splats),
                 device_used=nbytes_of(prepared))

    def account_raster(self, proj, bins, blend_out):
        """The frame's own buffers (the reference's sorting and indirect
        buffers, splat_set_manager_vk.cpp:2426-2517), counted from the
        tensors themselves: the projected fields (``proj``), the bin
        stage's result (``bins``: a TileBins' pair rows, ids, validity and
        tile ranges, or a BucketBins' slot rows, ids and bucket spans) and
        the blend's outputs (``blend_out``: its per-tile rows and ids)."""
        self.set("Rasterization",
                 device_used=nbytes_of(proj) + nbytes_of(bins) + nbytes_of(blend_out))

    def account_raytracing(self, device_used: int = 0):
        self.set("Raytracing", device_used=device_used)

    def print_benchmark_adv(self, benchmark_id: int, out=print):
        """BENCHMARK_ADV grammar (gaussian_splatting.cpp:2601-2617)."""
        out(f"BENCHMARK_ADV {benchmark_id} {{")
        for name in ("Scene", "Rasterization", "Raytracing"):
            c = self.categories[name]
            out(f" Memory {name}; Host used \t{c.host_used}; Device Used "
                f"\t{c.device_used}; Device Allocated \t{c.device_alloc}; (bytes)")
        out("}")

    @staticmethod
    def device_memory_summary(device: torch.device | str) -> dict:
        """Live device-memory budget of a CUDA device (memory_monitor_vk
        queryVRAMSummary analog): the caching allocator's bytes in use and
        peak, and the device's free and total bytes (``cudaMemGetInfo``).
        A device without device memory (the CPU) gives {}."""
        device = torch.device(device)
        if device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
        return {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": total,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_free": free,
        }
