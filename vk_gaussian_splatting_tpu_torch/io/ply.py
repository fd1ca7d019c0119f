"""3DGS PLY reader and writer (counterpart of ``vk_gaussian_splatting_tpu/io/ply.py``).

Reads the INRIA 3DGS vertex layout (x y z [nx ny nz] f_dc_0..2 f_rest_0..44
opacity scale_0..2 rot_0..3) from binary little-endian or ascii PLY. A
binary all-f32 file whose property groups are contiguous goes through the
native multithreaded extractor (``native.ply_extract_3dgs``, the miniply
analog, one pass with the SH repack); any other file, or a host without a
C++ compiler, through one numpy structured-dtype read. Like the reference,
coordinates convert RDF (PLY) -> RUB on load (ply_loader_async.cpp:440,
splat_set.h:78) and back on save. Parsing runs on the host; the splats
land on ``device`` at the end.
"""

from __future__ import annotations

import io as _io

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch import native
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
        if (fmt == "binary_little_endian" and all(d == "<f4" for _, d in props)
                and _groups_contiguous(names) and native.available()):
            payload = np.fromfile(f, dtype=np.uint8, count=n * dtype.itemsize)
            return _from_native(payload, n, names, dtype.itemsize, to_rub, device)
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

    return _splats(means, scales, quats, opac, sh_dc, sh_rest, to_rub, device)


def _splats(means, scales, quats, opac, sh_dc, sh_rest, to_rub, device) -> SplatSet:
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    splats = SplatSet(means=t(means), scales=t(scales), quats=t(quats),
                      opacities=t(opac), sh_dc=t(sh_dc), sh_rest=t(sh_rest))
    if to_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RDF, CoordinateSystem.RUB)
    return splats


def _from_native(payload: np.ndarray, n: int, names: list[str], stride: int, to_rub: bool,
                 device) -> SplatSet:
    """One-pass extraction with the SH repack through native/fast_splats.cpp
    (the JAX ``_from_native``): every group's head offset, -1 where absent."""
    byte_off = {nm: i * 4 for i, nm in enumerate(names)}
    m = sum(1 for p in names if p.startswith("f_rest_")) // 3
    offsets = [byte_off["x"], byte_off["y"], byte_off["z"],
               byte_off.get("f_dc_0", -1), -1, -1,
               byte_off.get("opacity", -1),
               byte_off.get("scale_0", -1), -1, -1,
               byte_off.get("rot_0", -1), -1, -1, -1,
               byte_off.get("f_rest_0", -1)]
    means, sh_dc, opac, scales, quats, sh_rest = native.ply_extract_3dgs(payload, n, stride,
                                                                         offsets, m)
    return _splats(means, scales, quats, opac, sh_dc, sh_rest, to_rub, device)


def _groups_contiguous(names: list[str]) -> bool:
    """Whether each property group the native extractor copies as one run
    from its head offset (xyz, f_dc, scale, rot, f_rest) is consecutive: a
    valid PLY may order its properties otherwise, which that copy would
    read as garbage."""
    def run(group: list[str]) -> bool:
        if group[0] not in names:
            return True  # absent group: the extractor gets offset -1 (defaults)
        i0 = names.index(group[0])
        return names[i0:i0 + len(group)] == group

    groups = [["x", "y", "z"], [f"f_dc_{i}" for i in range(3)],
              [f"scale_{i}" for i in range(3)], [f"rot_{i}" for i in range(4)]]
    return all(run(g) for g in groups) and (
        not any(p.startswith("f_rest_") for p in names) or _contiguous_rest(names))


def _contiguous_rest(names: list[str]) -> bool:
    """Whether f_rest_0 .. f_rest_{k-1} stand in order, one after another."""
    if "f_rest_0" not in names:
        return False
    i0 = names.index("f_rest_0")
    n_rest = sum(1 for p in names if p.startswith("f_rest_"))
    return names[i0:i0 + n_rest] == [f"f_rest_{i}" for i in range(n_rest)]


def save_ply(path: str, splats: SplatSet, from_rub: bool = True) -> None:
    """Write the INRIA binary layout (the reverse of ``load_ply``): all f32,
    groups contiguous, so ``load_ply`` reads it back through the native
    extractor where it built."""
    if from_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RUB, CoordinateSystem.RDF)

    def host(x):
        return x.detach().cpu().numpy().astype(np.float32, copy=False)

    means, sh_dc, sh_rest = host(splats.means), host(splats.sh_dc), host(splats.sh_rest)
    n, m = means.shape[0], sh_rest.shape[1]
    names = (["x", "y", "z"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * m)] + ["opacity"]
             + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    # PLY's f_rest is channel-major ([R: m coeffs][G: m][B: m])
    rest = sh_rest.transpose(0, 2, 1).reshape(n, 3 * m)
    cols = np.concatenate([means, sh_dc, rest, host(splats.opacities)[:, None],
                           host(splats.scales), host(splats.quats)], axis=1)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        np.ascontiguousarray(cols, dtype="<f4").tofile(f)
