"""Static render configuration.

A field-for-field copy of ``vk_gaussian_splatting_tpu/config.py``: the same
enums and the same three frozen dataclasses with the same defaults, so a
``RenderConfig`` means one thing in both packages (tests/test_torch_config.py
holds them equal). It is copied rather than imported because the JAX
package's ``__init__`` imports JAX, which this package never does.

Parameter groups mirror the reference's global parameter structs
(parameters.h:82-240: prmFrame / prmRender / prmRaster / prmRtx / prmData).
Fields that only other pipelines read are carried unchanged; the raster
frame rejects the values it does not implement yet
(render/pipelines.render_3dgs).
"""

from __future__ import annotations

import dataclasses
import enum


class Pipeline(enum.IntEnum):
    """The six rendering pipelines (shaderio.h:61-66)."""

    VERT = 0          # raster 3DGS (vertex-shader path in reference; one raster path here)
    MESH = 1          # raster 3DGS (default)
    RTX = 2           # 3DGRT ray tracing
    HYBRID = 3        # 3DGS raster primary + 3DGRT secondary
    MESH_3DGUT = 4    # raster 3DGUT (unscented transform)
    HYBRID_3DGUT = 5  # 3DGUT raster primary + 3DGRT secondary


class ShFormat(enum.IntEnum):
    """SH coefficient storage format (shaderio.h data-format macros; splat_set_vk.cpp:396-447)."""

    FLOAT32 = 0
    FLOAT16 = 1
    UINT8 = 2


class CameraType(enum.IntEnum):
    PINHOLE = 0
    FISHEYE = 1


class ShutterType(enum.IntEnum):
    """Rolling-shutter scan direction (threedgut_camera_models.h.slang:52-57)."""

    ROLLING_TOP_TO_BOTTOM = 0
    ROLLING_LEFT_TO_RIGHT = 1
    ROLLING_BOTTOM_TO_TOP = 2
    ROLLING_RIGHT_TO_LEFT = 3
    GLOBAL = 4


class SortMethod(enum.IntEnum):
    """GPU vs CPU sorting (reference: vrdx radix sort vs SplatSorterAsync)."""

    DEVICE = 0  # on-device sort inside binning — reference "GPU sort"
    HOST = 1    # host-side sort, permutation shipped to the device — reference "CPU sort"


class StochasticMode(enum.IntEnum):
    """Stochastic transparency variants (shaderio.h:95-105; doc/stochastic_transparency.md)."""

    NONE = 0
    SPLAT = 1  # per-fragment stochastic accept in raster (threedgs_raster.frag.slang:265-290)
    PASS = 2   # Monte-Carlo pass termination in RT (rgen:765-800)
    ANYHIT = 3 # single-trace stochastic any-hit (rgen:821-961)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Tile rasterizer parameters (prmRaster, parameters.h:180-214)."""

    tile_size: int = 16
    chunk: int = 128             # pairs per blend step (the transmittance freeze granularity)
    bucket_chunk: int = 384      # bucket-kernel blend chunk (method="bucket")
    slots_k: int = 16            # max tiles per splat in slot expansion
    expansion: str = "slots"     # "slots" (fast, capped) | "exact" (uncapped, max_pairs budget)
    # binning architecture: "pairs" materializes (splat, tile) pairs and
    # sorts them (ops/binning.py); "bucket" sorts splats into class-pyramid
    # buckets and merges per tile (not ported yet)
    method: str = "pairs"
    # per-class window-span capacities of the bucket kernel (method="bucket")
    bucket_caps: tuple = (512, 256, 512, 256)
    extent_sigma: float = 2.8284271247461903  # sqrt(8) std-devs (threedgs.h.slang stdDev)
    max_basis_px: float = 2048.0  # extent clamp (threedgs.h.slang:117-118)
    dilation: float = 0.3         # low-pass dilation (threedgs.h.slang:69-70)
    alpha_min: float = 1.0 / 255.0
    alpha_clamp: float = 0.999
    alpha_cull_qmax: float = 8.0  # discard A=dot(fragPos,fragPos) > 8 (frag.slang:236-255)
    ms_antialiasing: bool = False  # Mip-Splatting alpha compensation (threedgs.h.slang:63-76)
    point_cloud_mode: bool = False  # fixed 0.2 eigenvalues (threedgs.h.slang:108-110)
    # DEVICE: on-device depth sort inside binning; HOST: the caller passes a
    # host-computed permutation as render_3dgs(host_order=...)
    sort_method: SortMethod = SortMethod.DEVICE
    frustum_dilation: float = 0.2  # NDC cull margin (FrameInfo.frustumDilation default)
    depth_iso_threshold: float = 0.7  # depth picking T threshold (parameters.h:200)
    size_culling: bool = False
    size_culling_min_px: float = 1.0
    # pair-attribute precision through the binning sorts: "f32" = full
    # precision; "packed" = bf16-pair + fixed-point words (forward only)
    pair_format: str = "f32"
    # mesh compositing pass: "smooth" = per-vertex Gouraud shading +
    # perspective-correct interpolated depth; "flat" = per-face color + centroid depth
    mesh_shading: str = "smooth"


@dataclasses.dataclass(frozen=True)
class RtConfig:
    """3DGRT ray-tracing parameters (prmRtx, parameters.h:216-240)."""

    kernel_degree: int = 2        # generalized gaussian degree, default quadratic (parameters.h:215)
    # secondary-ray ordering: "radial" | "windowed" | "auto" (picks by origin spread)
    order: str = "auto"
    max_passes: int = 32          # t-slab count of the windowed exact order
    min_transmittance: float = 0.001
    alpha_clamp: float = 0.999
    alpha_min: float = 0.01       # hit response cull (threedgrt.h.slang:149-160)
    # degree-0 kernel support radius in canonical units (splat_set_vk.cpp kernelScale)
    kernel_scale_deg0: float = 3.0
    max_bounces: int = 3          # wavefront bounce cap (FrameInfo.rtxMaxBounces, shaderio.h:273)
    # splat shadow transmittance in the hybrid path: "map" (deep shadow
    # maps) | "ray" (per-shade-point ray trace toward each light)
    shadows: str = "map"
    # colored-shadow controls (FrameInfo, shaderio.h:305-307)
    shadow_offset: float = 0.2
    shadow_transmittance_threshold: float = 0.0
    shadow_color_strength: float = 0.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level frame parameters (prmFrame/prmRender, parameters.h:82-178)."""

    pipeline: Pipeline = Pipeline.MESH
    width: int = 800
    height: int = 600
    sh_degree: int = 3            # requested max SH degree (clamped to data degree)
    sh_format: ShFormat = ShFormat.FLOAT32
    camera_type: CameraType = CameraType.PINHOLE
    shutter: ShutterType = ShutterType.GLOBAL  # 3DGUT rolling shutter
    splat_scale: float = 1.0      # global splat scale multiplier (FrameInfo.splatScale)
    stochastic: StochasticMode = StochasticMode.NONE
    temporal_samples: int = 1     # temporal accumulation frames (post.comp.slang)
    # guided spatial denoiser for stochastic/DoF frames: "atrous" | "none"
    denoise: str = "none"
    opacity_gain: float = 1.0
    show_sh_only: bool = False    # visualize SH radiance without base color (FrameInfo.showShOnly)
    raster: RasterConfig = RasterConfig()
    rt: RtConfig = RtConfig()
    # blend a constant background under the splats (reference clears to black)
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def tiles_x(cfg: RenderConfig) -> int:
    return -(-cfg.width // cfg.raster.tile_size)


def tiles_y(cfg: RenderConfig) -> int:
    return -(-cfg.height // cfg.raster.tile_size)
