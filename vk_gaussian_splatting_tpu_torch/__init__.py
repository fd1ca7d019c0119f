"""PyTorch + CUDA port of ``vk_gaussian_splatting_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package keeps its
module layout and public names, so each module's counterpart is found at
the same path. It imports torch and numpy, never JAX.

Ported so far: the 3DGS, 3DGUT and 3DGRT raster frames, forward and
backward — ``render(prepared, camera, cfg)`` in
``vk_gaussian_splatting_tpu_torch.render`` for the VERT/MESH, MESH_3DGUT
and RTX pipelines with pair binning (``RasterConfig.method="pairs"``, the
default) or bucket-grid binning (``method="bucket"``) — and the training
step (``train_step``, Adam, the loss, densification, checkpoints); the
packed tier (forward only) and stochastic transparency with its a-trous
pass (``cfg.stochastic``, ``cfg.denoise``) on each of them; meshes on the
raster path (``render_mesh``, ``render_3dgs_composed``); lighting and
shadows on the raster path (``render_3dgs_lit``, ``render_hybrid`` for the
HYBRID and HYBRID_3DGUT pipelines, ``DeferredMaterial``,
``make_shadow_fn``: deferred Phong shading and per-light deep shadow
maps); 3DGRT's ray-traced tier (``render_3dgrt_exact``, the per-ray
shadows of ``make_ray_shadow_fn``, the wavefront bounces of
``render_composed_wavefront``: the splat and mesh tracer of
ops/raytrace.py, plain torch); multi-instance scenes (``SplatScene``:
instances baked into one PreparedSplats with the global index table and
the SH band rotation) and project files (``save_project``,
``load_project``, ``CameraSet``); the inspection tools (``mse``, ``psnr``,
``flip``, ``flip_mean``, ``ImageCompare``, the grid and gizmo overlays,
``pixel_trace`` and ``pixel_trace_gut``), plain torch. Plain
tensor code runs on any torch device; the two tile blenders and their
backwards are hand-written CUDA kernels (csrc/rasterize_{fwd,bwd}.cu,
csrc/raster_bucket_{fwd,bwd}.cu, each for the gs2d and the gut3d response
model of csrc/response.cuh, built for sm_90a at first use) on a CUDA
device and plain PyTorch twins on the CPU.
Entry points that make tensors use the card unless given another device.
The names exported here are the JAX package's.

Layout:
  io/      PLY, spz, .splat, OBJ, cameras.json loaders, project JSON
  scene/   SplatSet / PreparedSplats, instances (SplatScene), cameras
           (pinhole and fisheye parameters, DoF, distortion, rolling
           shutter; CameraSet), lights
  ops/     SH (and its band rotation), image metrics and the compare tool, EWA and UT projections, the splat and mesh ray tracer, depth keys, pair binning and
           bucket-grid binning (each with its sort-based backward), the
           gs2d and gut3d responses and the stochastic stream, the pair
           blender and the bucket rasterizer (kernel wrappers, twins,
           autograd Functions), the a-trous denoiser, kernel build
  render/  render_3dgs, render_3dgut, render_3dgrt, the per-tile rays, the
           pipeline dispatch, render_mesh and render_3dgs_composed,
           render_3dgs_lit and render_hybrid with deferred shading and
           deep shadow maps or ray shadows, render_3dgrt_exact, the
           wavefront bounces (render_composed_wavefront), the grid and
           gizmo overlays (helpers.py)
  debug.py per-pixel contribution traces
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
from vk_gaussian_splatting_tpu_torch.debug import format_trace, pixel_trace, pixel_trace_gut
from vk_gaussian_splatting_tpu_torch.io.project import Project, load_project, save_project
from vk_gaussian_splatting_tpu_torch.ops.compare import CompareMode, ImageCompare, composite
from vk_gaussian_splatting_tpu_torch.ops.metrics import flip, flip_mean, mse, psnr
from vk_gaussian_splatting_tpu_torch.render.deferred import DeferredMaterial
from vk_gaussian_splatting_tpu_torch.render.helpers import (
    render_gizmo_overlay,
    render_grid_overlay,
)
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    render_3dgrt_exact,
    render_3dgs_composed,
    render_3dgs_lit,
    render_composed_wavefront,
    render_hybrid,
)
from vk_gaussian_splatting_tpu_torch.render.shadows import make_ray_shadow_fn, make_shadow_fn
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera, CameraSet, look_at, make_camera
from vk_gaussian_splatting_tpu_torch.scene.instances import (
    GlobalIndexTable,
    SplatInstance,
    SplatScene,
)
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
    "CameraSet",
    "CameraType",
    "CompareMode",
    "DeferredMaterial",
    "GlobalIndexTable",
    "ImageCompare",
    "Pipeline",
    "PreparedSplats",
    "Project",
    "RasterConfig",
    "RenderConfig",
    "RtConfig",
    "ShFormat",
    "ShutterType",
    "SplatInstance",
    "SplatScene",
    "SplatSet",
    "StochasticMode",
    "TrainConfig",
    "composite",
    "densify_split",
    "flip",
    "flip_mean",
    "format_trace",
    "l1_loss",
    "load_checkpoint",
    "load_project",
    "look_at",
    "make_camera",
    "make_optimizer",
    "make_ray_shadow_fn",
    "make_shadow_fn",
    "mse",
    "pixel_trace",
    "pixel_trace_gut",
    "prune_splats",
    "psnr",
    "render_3dgrt_exact",
    "render_3dgs_composed",
    "render_3dgs_lit",
    "render_composed_wavefront",
    "render_gizmo_overlay",
    "render_grid_overlay",
    "render_hybrid",
    "reset_opacities",
    "rgb_loss",
    "save_checkpoint",
    "save_project",
    "ssim",
    "train_step",
]
