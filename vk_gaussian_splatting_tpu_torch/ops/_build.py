"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes plain C entry points. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of the source,
the shared headers ``csrc/*.cuh`` and the flags, and loaded with ctypes. A
later call, or a later process, reuses the library while those are
unchanged. Any failure raises: there is no fallback to another
implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# No fast math, and no multiply-add contraction: the kernels round each
# operation as their plain PyTorch twins do (see csrc/rasterize_fwd.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu goes for its current
    source and headers (a header edit must not load a stale library)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_source(source: Path, out: Path) -> None:
    """Compile ``source`` with NVCC_FLAGS into the library ``out``, its
    register and shared-memory report (-Xptxas -v) beside it as
    ``<out>.log``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}{res.stderr}")
    Path(str(out) + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it."""
    out = library_path(name)
    if not out.exists():
        compile_source(CSRC / f"{name}.cu", out)
    return ctypes.CDLL(str(out))


def entry(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of csrc/<name>.cu's library, typed; every
    entry point returns an int (a cudaError_t or a byte count)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` detached, contiguous and 16-byte aligned (copied only where it
    is not), as the kernels' vector loads want their inputs."""
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
