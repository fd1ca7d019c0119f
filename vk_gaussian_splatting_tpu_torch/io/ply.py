"""3DGS PLY reader (counterpart of ``vk_gaussian_splatting_tpu/io/ply.py:30-115``).

Reads the INRIA 3DGS vertex layout (x y z [nx ny nz] f_dc_0..2 f_rest_0..44
opacity scale_0..2 rot_0..3) from binary little-endian or ascii PLY via one
numpy structured-dtype read. Like the reference, coordinates convert RDF
(PLY) -> RUB on load (ply_loader_async.cpp:440, splat_set.h:78). The
native multithreaded extractor of the JAX package is not ported yet.
"""

from __future__ import annotations

import io as _io

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.scene.splat_set import CoordinateSystem, SplatSet

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
}


def _parse_header(f) -> tuple[str, int, list[tuple[str, str]]]:
    """Returns (format, vertex_count, [(name, dtype)])."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    props: list[tuple[str, str]] = []
    count = 0
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                count = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return fmt, count, props


def load_ply(path: str, to_rub: bool = True,
             device: torch.device | str | None = None) -> SplatSet:
    """Read a 3DGS PLY into a SplatSet on ``device`` (default: the card)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        fmt, n, props = _parse_header(f)
        names = [p[0] for p in props]
        dtype = np.dtype(props)
        if fmt == "binary_little_endian":
            data = np.fromfile(f, dtype=dtype, count=n)
        else:
            flat = np.loadtxt(_io.TextIOWrapper(f, "ascii"), dtype=np.float64,
                              max_rows=n).reshape(n, len(props))
            data = np.zeros(n, dtype=dtype)
            for i, name in enumerate(names):
                data[name] = flat[:, i]

    def cols(prefix, k):
        return np.stack(
            [data[f"{prefix}{i}"].astype(np.float32) for i in range(k)], axis=1
        )

    means = np.stack([data[a].astype(np.float32) for a in "xyz"], axis=1)
    sh_dc = cols("f_dc_", 3) if "f_dc_0" in names else np.zeros((n, 3), np.float32)
    opac = (data["opacity"].astype(np.float32) if "opacity" in names
            else np.zeros(n, np.float32))
    scales = cols("scale_", 3) if "scale_0" in names else np.full((n, 3), -8.0, np.float32)
    quats = cols("rot_", 4) if "rot_0" in names else np.tile(
        np.array([1, 0, 0, 0], np.float32), (n, 1))

    n_rest = sum(1 for p in names if p.startswith("f_rest_"))
    m = n_rest // 3
    if n_rest:
        # PLY layout is channel-major ([R: m coeffs][G: m][B: m]); SplatSet
        # is coefficient-major with RGB per coefficient.
        sh_rest = cols("f_rest_", n_rest).reshape(n, 3, m).transpose(0, 2, 1)
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    splats = SplatSet(means=t(means), scales=t(scales), quats=t(quats),
                      opacities=t(opac), sh_dc=t(sh_dc), sh_rest=t(sh_rest))
    if to_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RDF, CoordinateSystem.RUB)
    return splats
