"""PyTorch + CUDA port of ``vk_gaussian_splatting_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package keeps its
module layout and public names, so each module's counterpart is found at
the same path. It imports torch and numpy, never JAX.

Ported so far: the 3DGS raster forward frame, ``render(prepared, camera,
cfg)`` in ``vk_gaussian_splatting_tpu_torch.render``, for the VERT/MESH
pipelines with pair binning. Plain tensor code runs on any torch device;
the tile blender is a hand-written CUDA kernel (csrc/rasterize_fwd.cu,
built for sm_90a at first use) on a CUDA device and its plain PyTorch twin
on the CPU. The names exported here are the JAX package's.

Layout:
  io/      PLY loader
  scene/   SplatSet / PreparedSplats, pinhole cameras
  ops/     SH, EWA projection, depth keys, tile binning, gs2d response,
           tile blender (kernel wrapper + twin), kernel build
  render/  render_3dgs and the pipeline dispatch
  csrc/    CUDA sources
"""

__version__ = "0.1.0"

from vk_gaussian_splatting_tpu_torch.config import (
    CameraType,
    Pipeline,
    RasterConfig,
    RenderConfig,
    RtConfig,
    ShFormat,
    ShutterType,
    StochasticMode,
)
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera, look_at, make_camera
from vk_gaussian_splatting_tpu_torch.scene.splat_set import SplatSet, PreparedSplats

__all__ = [
    "Camera",
    "CameraType",
    "Pipeline",
    "PreparedSplats",
    "RasterConfig",
    "RenderConfig",
    "RtConfig",
    "ShFormat",
    "ShutterType",
    "SplatSet",
    "StochasticMode",
    "look_at",
    "make_camera",
]
