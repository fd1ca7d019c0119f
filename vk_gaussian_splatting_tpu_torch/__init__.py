"""PyTorch + CUDA port of ``vk_gaussian_splatting_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package keeps its
module layout and public names, so each module's counterpart is found at
the same path. It imports torch and numpy, never JAX.

Ported so far: the 3DGS, 3DGUT and 3DGRT raster frames, forward and
backward — ``render(prepared, camera, cfg)`` in
``vk_gaussian_splatting_tpu_torch.render`` for the VERT/MESH, MESH_3DGUT
and RTX pipelines with pair binning (``RasterConfig.method="pairs"``, the
default) or bucket-grid binning (``method="bucket"``) — and the training
step (``train_step``, Adam, the loss, densification, checkpoints). Plain
tensor code runs on any torch device; the two tile blenders and their
backwards are hand-written CUDA kernels (csrc/rasterize_{fwd,bwd}.cu,
csrc/raster_bucket_{fwd,bwd}.cu, each for the gs2d and the gut3d response
model of csrc/response.cuh, built for sm_90a at first use) on a CUDA
device and plain PyTorch twins on the CPU.
Entry points that make tensors use the card unless given another device.
The names exported here are the JAX package's.

Layout:
  io/      PLY loader
  scene/   SplatSet / PreparedSplats, cameras (pinhole and fisheye
           parameters, DoF, distortion, rolling shutter)
  ops/     SH, EWA and UT projections, depth keys, pair binning and
           bucket-grid binning (each with its sort-based backward), the
           gs2d and gut3d responses, the pair blender and the bucket
           rasterizer (kernel wrappers, twins, autograd Functions), kernel
           build
  render/  render_3dgs, render_3dgut, render_3dgrt, the per-tile rays and
           the pipeline dispatch
  train.py loss, Adam, train_step, densify / prune, checkpoints
  probes/  the design probes P1-P3 (the scripts/ Pallas probes) on the card
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
from vk_gaussian_splatting_tpu_torch.train import (
    TrainConfig,
    densify_split,
    l1_loss,
    load_checkpoint,
    make_optimizer,
    prune_splats,
    reset_opacities,
    rgb_loss,
    save_checkpoint,
    ssim,
    train_step,
)

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
    "TrainConfig",
    "densify_split",
    "l1_loss",
    "load_checkpoint",
    "look_at",
    "make_camera",
    "make_optimizer",
    "prune_splats",
    "reset_opacities",
    "rgb_loss",
    "save_checkpoint",
    "ssim",
    "train_step",
]
