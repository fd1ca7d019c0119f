"""Test env: force CPU backend with 8 virtual devices (multi-chip sharding tests
run on a virtual mesh, per SURVEY.md §4). Must run before any jax import."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# Force CPU even if jax was imported (and the platform resolved) before this
# conftest ran — e.g. by a pytest plugin.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# NOTE: do not enable jax_compilation_cache_dir here — serializing the large
# interpret-mode Pallas executables segfaults the CPU backend (observed at
# compilation_cache.put_executable_and_time).


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's CUDA kernels); "
        "skips where torch.cuda.is_available() is false")
