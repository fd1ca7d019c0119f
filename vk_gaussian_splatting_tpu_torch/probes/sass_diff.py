"""Whether every kernel of another build of the CUDA sources compiles to the
same machine code here.

    python -m vk_gaussian_splatting_tpu_torch.probes.sass_diff OTHER_CSRC [name ...]

builds ``OTHER_CSRC/<name>.cu`` (for example a parent commit's ``csrc/``
unpacked with ``git archive``) and this tree's ``csrc/<name>.cu`` with
``_build.NVCC_FLAGS``, disassembles both with ``cuobjdump -sass`` and, for
each kernel of the other build, looks for a kernel of this build with the
same instructions (addresses and encodings dropped, names not compared: a
kernel that gained a template flag keeps its code under a new name). It
prints one line per kernel and exits 1 unless every kernel has its twin.
By default it checks the four raster sources. Needs ``nvcc`` and
``cuobjdump``, not a card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from vk_gaussian_splatting_tpu_torch.ops import _build

RASTER = ("rasterize_fwd", "rasterize_bwd", "raster_bucket_fwd", "raster_bucket_bwd")


def sass_functions(library: Path) -> dict[str, tuple[str, ...]]:
    """{mangled kernel name: its instructions}, each without its address
    and encoding comments."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    functions, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            functions[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            functions[name].append(re.sub(r"/\*.*?\*/|;", "", line).split())
    return {k: tuple(" ".join(i) for i in v) for k, v in functions.items()}


def compare(other: Path, names=RASTER) -> bool:
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            libs = []
            for tag, csrc in (("other", other), ("this", _build.CSRC)):
                out = Path(tmp) / f"lib{name}-{tag}.so"
                _build.compile_source(csrc / f"{name}.cu", out)
                libs.append(sass_functions(out))
            bodies = {body: k for k, body in libs[1].items()}
            for kernel, body in sorted(libs[0].items()):
                twin = bodies.get(body)
                print(f"{name}: {kernel} ({len(body)} instructions) -> "
                      f"{twin if twin else 'NO KERNEL WITH THE SAME CODE'}", flush=True)
                same = same and twin is not None
            print(f"{name}: {len(libs[0])} kernels in the other build, {len(libs[1])} here",
                  flush=True)
    return same


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    ok = compare(Path(argv[0]).resolve(), tuple(argv[1:]) or RASTER)
    print("every kernel of the other build has its twin here" if ok else
          "some kernel's code changed", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
