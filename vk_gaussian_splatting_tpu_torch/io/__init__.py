import os

from vk_gaussian_splatting_tpu_torch.io.ply import load_ply


def load_scene(path: str, **kw):
    """Extension-dispatched splat loading (PlyLoaderAsync::innerLoad,
    ply_loader_async.cpp:291-305). Only ``.ply`` is ported so far."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply(path, **kw)
    if ext in (".spz", ".splat"):
        raise NotImplementedError(
            f"{ext} loading is not ported yet (ROADMAP.md queue 1: remaining IO)")
    raise ValueError(f"unsupported splat file extension: {ext}")


__all__ = ["load_ply", "load_scene"]
