import os

from vk_gaussian_splatting_tpu_torch.io.cameras_json import import_cameras_inria
from vk_gaussian_splatting_tpu_torch.io.obj import load_obj
from vk_gaussian_splatting_tpu_torch.io.ply import load_ply, save_ply
from vk_gaussian_splatting_tpu_torch.io.splat_file import load_splat_file, save_splat_file
from vk_gaussian_splatting_tpu_torch.io.spz import load_spz, save_spz


def load_scene(path: str, **kw):
    """Extension-dispatched splat loading (PlyLoaderAsync::innerLoad,
    ply_loader_async.cpp:291-305 with parameters.cpp's suffix dispatch):
    ``.ply``, ``.spz`` and ``.splat``; ``kw`` goes to the loader (``device``,
    and ``to_rub`` or ``to_cs``). Another suffix raises ValueError."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return load_ply(path, **kw)
    if ext == ".spz":
        return load_spz(path, **kw)
    if ext == ".splat":
        return load_splat_file(path, **kw)
    raise ValueError(f"unsupported splat file extension: {ext}")


__all__ = [
    "load_ply", "save_ply", "load_splat_file", "save_splat_file",
    "load_spz", "save_spz", "import_cameras_inria", "load_obj", "load_scene",
]
