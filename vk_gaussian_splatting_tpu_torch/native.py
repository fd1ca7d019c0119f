"""The port's ctypes shim for the native host library ``native/fast_splats.cpp``
(counterpart of ``vk_gaussian_splatting_tpu/native.py``).

The C++ source at the repository root is shared with the JAX package and
compiled here as it is, by the system C++ compiler (``c++ -O3 -std=c++17
-shared -fPIC -pthread``), into ``build/native/libfast_splats-<hash>.so``
at the repository root, keyed by a hash of the source and the flags (as
``ops/_build.py`` keys the CUDA kernels), never next to the source. Four
entry points: ``ply_extract``, ``ply_extract_block``, ``ply_extract_3dgs``
(the multithreaded PLY column gather, the miniply analog) and
``radix_argsort_f32`` (the host sort of ``SortMethod.HOST``).

This is host code, not a device kernel: where no compiler exists the build
fails quietly and ``available()`` is False, and the call sites
(io/ply.load_ply, io/async_loader.AsyncHostSorter) fall back to numpy, as
in the JAX package. Nothing here touches a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "native" / "fast_splats.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
COMPILERS = ("c++", "g++", "clang++")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library goes for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfast_splats-{h.hexdigest()[:16]}.so"


def _build(again: bool = False) -> Path | None:
    """The library, compiled first if missing (or, with ``again``, in any
    case); None without a compiler."""
    out = library_path()
    if out.exists() and not again:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    for cxx in COMPILERS:
        try:
            subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=300)
        except (subprocess.SubprocessError, OSError):
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        return out
    return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = None
        for again in (False, True):  # a library another host built may not load here
            path = _build(again)
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(str(path))
                break
            except OSError:
                continue
        if lib is None:
            return None
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.fast_ply_extract.argtypes = [p, i64, i64, ctypes.POINTER(i64), i32,
                                         ctypes.POINTER(p)]
        lib.fast_ply_extract_block.argtypes = [p, i64, i64, i64, i32, p]
        lib.radix_argsort_f32.argtypes = [p, i64, p]
        lib.fast_ply_extract_3dgs.argtypes = [p, i64, i64, ctypes.POINTER(i64), i64] + [p] * 6
        for fn in (lib.fast_ply_extract, lib.fast_ply_extract_block, lib.radix_argsort_f32,
                   lib.fast_ply_extract_3dgs):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built and loaded (else the callers use numpy)."""
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library did not build: no C++ compiler")
    return lib


def _check_records(payload: np.ndarray, n_rows: int, stride: int, spans) -> None:
    """Raise unless ``payload`` is a contiguous byte buffer holding n_rows
    records of ``stride`` bytes and every (offset, bytes) of ``spans`` lies
    inside a record: the library reads them without checks."""
    if payload.dtype != np.uint8 or not payload.flags.c_contiguous:
        raise ValueError("the payload must be a contiguous uint8 buffer")
    if n_rows < 0 or payload.size < n_rows * stride:
        raise ValueError(f"the payload holds {payload.size} bytes, not {n_rows} records of "
                         f"{stride}")
    if any(off < 0 or off + size > stride for off, size in spans):
        raise ValueError(f"a property lies outside the {stride}-byte record")


def ply_extract(payload: np.ndarray, n_rows: int, stride: int,
                offsets: list[int]) -> list[np.ndarray]:
    """Gather f32 columns at byte ``offsets`` from a packed record buffer."""
    lib = _lib_or_raise()
    _check_records(payload, n_rows, stride, [(o, 4) for o in offsets])
    outs = [np.empty(n_rows, np.float32) for _ in offsets]
    off = (ctypes.c_int64 * len(offsets))(*offsets)
    ptrs = (ctypes.c_void_p * len(offsets))(*[o.ctypes.data for o in outs])
    lib.fast_ply_extract(payload.ctypes.data, n_rows, stride, off, len(offsets), ptrs)
    return outs


def ply_extract_block(payload: np.ndarray, n_rows: int, stride: int,
                      base_offset: int, n_cols: int) -> np.ndarray:
    """``n_cols`` consecutive f32 properties from ``base_offset`` of each
    record, as one (n_rows, n_cols) array."""
    lib = _lib_or_raise()
    _check_records(payload, n_rows, stride, [(base_offset, 4 * n_cols)])
    out = np.empty((n_rows, n_cols), np.float32)
    lib.fast_ply_extract_block(payload.ctypes.data, n_rows, stride, base_offset, n_cols,
                               out.ctypes.data)
    return out


def ply_extract_3dgs(payload: np.ndarray, n: int, stride: int, offsets: list[int], m: int):
    """One pass over the records for the whole 3DGS layout, SH repack
    included: (means, sh_dc, opacity, scales, quats, sh_rest). offsets: 15
    byte offsets [x, y, z, f_dc * 3, opacity, scale * 3, rot * 4, f_rest_0],
    -1 for an absent group (which keeps its default)."""
    lib = _lib_or_raise()
    if len(offsets) != 15:
        raise ValueError(f"ply_extract_3dgs takes 15 offsets, got {len(offsets)}")
    sizes = {0: 12, 3: 12, 6: 4, 7: 12, 10: 16, 14: 12 * m}  # the groups' runs
    _check_records(payload, n, stride, [(offsets[i], b) for i, b in sizes.items()
                                        if offsets[i] >= 0 and b])
    means = np.empty((n, 3), np.float32)
    sh_dc = np.zeros((n, 3), np.float32)
    opacity = np.zeros(n, np.float32)
    scales = np.full((n, 3), -8.0, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    sh_rest = np.empty((n, m, 3), np.float32) if m else np.zeros((n, 0, 3), np.float32)
    off = (ctypes.c_int64 * 15)(*offsets)
    lib.fast_ply_extract_3dgs(payload.ctypes.data, n, stride, off, m, means.ctypes.data,
                              sh_dc.ctypes.data, opacity.ctypes.data, scales.ctypes.data,
                              quats.ctypes.data, sh_rest.ctypes.data)
    return means, sh_dc, opacity, scales, quats, sh_rest


def radix_argsort_f32(values: np.ndarray) -> np.ndarray:
    """Stable ascending argsort of f32 values, (N,) int32 (a 4 x 8-bit LSD
    radix sort of order-preserving keys: -0 before +0, NaNs with the sign
    bit set before -inf and the others after +inf)."""
    lib = _lib_or_raise()
    values = np.ascontiguousarray(values, np.float32)
    order = np.empty(values.shape[0], np.int32)
    lib.radix_argsort_f32(values.ctypes.data, values.shape[0], order.ctypes.data)
    return order
