"""What the harness and the reference import."""

import subprocess
import sys

from splatbench import spec

HARNESS = ("splatbench.run", "splatbench.workloads", "splatbench.kinds.view",
           "splatbench.kinds.train", "splatbench.trace", "splatbench.checks", "splatbench.counts",
           "splatbench.work.gs3d", "splatbench.work.gut3d", "splatbench.spec", "splatbench.scene",
           "splatbench.cameras", "splatbench.faults", "splatbench.calibrate",
           "splatbench.reference.gs3d", "splatbench.reference.gut3d",
           "splatbench.reference.train")
REFERENCE = ("splatbench.reference.gs3d", "splatbench.reference.gut3d",
             "splatbench.reference.train", "splatbench.counts", "splatbench.work.gs3d",
             "splatbench.work.gut3d", "splatbench.scene", "splatbench.cameras",
             "splatbench.checks")


def top_level_modules(modules) -> set:
    code = ("import importlib, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(res.stdout.split())


def test_the_harness_loads_no_jax():
    """After importing the harness (the program with it), no loaded module
    has the top-level name of JAX or of the JAX package: compared whole,
    since the port's name begins with the JAX package's."""
    names = top_level_modules(HARNESS)
    assert "vk_gaussian_splatting_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "vk_gaussian_splatting_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = top_level_modules(REFERENCE)
    assert not names & {"vk_gaussian_splatting_tpu_torch", "vk_gaussian_splatting_tpu", "jax"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from splatbench import run

    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "vk_gaussian_splatting_tpu_torch.extra", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert set(run.forbidden_modules()) == before | {"flax"}
