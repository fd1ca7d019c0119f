"""The raster pipelines as functions of (splats, camera, config).

Counterpart of ``vk_gaussian_splatting_tpu/render/pipelines.py`` for three
of the reference's six pipelines, matching the dist+sort+raster stages of
gaussian_splatting.cpp:1298-1464: project -> bin -> tile blend -> assemble.

- ``render_3dgs`` (VERT/MESH): EWA projection, the gs2d response model.
- ``render_3dgut`` (MESH_3DGUT): the unscented-transform projection for
  binning, then each pixel's camera ray against each splat's 3D Gaussian in
  the blender (the gut3d model), with pinhole or fisheye cameras, OpenCV
  distortion, rolling shutter and thin-lens DoF averaged over
  ``temporal_samples``.
- ``render_3dgrt`` (RTX, its raster form): the same as 3DGUT, with the
  blend ordered by radial distance from the camera and 3DGRT's clamp and
  transmittance cutoff.

Each bins by one of two architectures (``RasterConfig.method``):

- ``"pairs"`` (the default): pair expansion + one (tile, depth) sort
  (ops/binning.py), then the pair blender (ops/rasterize.py; K1/K2 on a
  card);
- ``"bucket"``: one (bucket, depth) sort of four slots per splat
  (ops/bucket_grid.py), then the bucket tile rasterizer, which merges each
  tile's window spans (ops/raster_bucket.py; K3/K4 on a card).

The frame is differentiable: gradients of the image and transmittance
reach ``PreparedSplats`` (and the SplatSet behind it) through the blend's
backward kernel and the binning's sort-based backward. The packed tier
(``RasterConfig.pair_format="packed"``: bf16 pairs and 16-bit opacity in
f32 words, ``gs_attr_rows_packed`` / ``gut_attr_rows_packed``, the response
models gs2dp and gut3dp) renders on both binning methods and is forward
only: a backward through it raises NotImplementedError. Stochastic
transparency (``cfg.stochastic`` SPLAT or ANYHIT, one binary-accept
estimator; the blend's stochastic form, ops/rasterize.py) renders every
pipeline on both methods, f32 and packed, each temporal sample with seed
``sample * 7919 + 1``; ``cfg.denoise="atrous"`` filters the averaged frame
(ops/denoise.py). ``render_3dgs(host_order=...)`` blends in a splat order
sorted on the host (``SortMethod.HOST``: io/async_loader.AsyncHostSorter),
through the bucket kernels' key-row form on the bucket path (f32 rows).
``render_3dgs_composed`` composites the 3DGS frame with an opaque triangle
mesh (render/mesh_raster.py): the mesh pass, the splat pass clipped by the
mesh depth (the gs2d_clip model), the mesh under the splats' transmittance.
``render_3dgs_lit`` and ``render_hybrid`` (HYBRID, HYBRID_3DGUT) light the
raster frame: its normal buffer, deferred Phong shading
(render/deferred.py) and, in the hybrid frame, per-light deep shadow maps
(render/shadows.py, the blend's multi-iso form) or per-ray shadows
(``rt.shadows="ray"``: the splat tracer, ops/raytrace.py).
``render_3dgrt_exact`` is 3DGRT's strict tier: every pixel ray traced
through the splats in the windowed per-ray t order (ops/raytrace.py, plain
torch). ``render_composed_wavefront`` adds to the composed frame the
reflect / refract bounces off its mirror and glass faces
(render/wavefront.py). Configurations this port does not run yet raise
``NotImplementedError`` naming their ROADMAP.md item; none of them quietly
takes another path.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.config import (
    Pipeline,
    RenderConfig,
    StochasticMode,
    tiles_x,
    tiles_y,
)
from vk_gaussian_splatting_tpu_torch.ops.binning import TileBins, bin_splats
from vk_gaussian_splatting_tpu_torch.ops.denoise import atrous_denoise
from vk_gaussian_splatting_tpu_torch.ops.bucket_grid import bucket_splats
from vk_gaussian_splatting_tpu_torch.ops.projection import (
    ProjectedSplats,
    project_splats,
    ut_project_splats,
)
from vk_gaussian_splatting_tpu_torch.ops.raster_bucket import rasterize_buckets
from vk_gaussian_splatting_tpu_torch.ops.rasterize import (
    RasterStatics,
    assemble_image,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu_torch.ops.raytrace import trace_splats
from vk_gaussian_splatting_tpu_torch.ops.response import deg0_min_response, model_of, pack_rows
from vk_gaussian_splatting_tpu_torch.render.mesh_raster import depth_limit_pix_ctx, render_mesh
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays
from vk_gaussian_splatting_tpu_torch.render.wavefront import (
    add_secondary_radiance,
    secondary_spawn,
    trace_secondary,
)
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera
from vk_gaussian_splatting_tpu_torch.scene.splat_set import PreparedSplats


@dataclasses.dataclass
class RenderOutput:
    image: torch.Tensor          # (H, W, 3)
    transmittance: torch.Tensor  # (H, W)
    depth: torch.Tensor          # (H, W) picked depth at T < depth_iso (0 = none)
    splat_id: torch.Tensor       # (H, W) i32 picked splat id (-1 = none)
    num_pairs: torch.Tensor      # () live pairs (bucket path: live slots)
    overflow: torch.Tensor       # () bool — slot/pair budget or bucket cap truncated coverage
    # the hybrid frame's deep shadow maps (None on frames with none): the
    # live pairs of every map face, summed, and the maps, one per light
    # (render/shadows.DeepShadowMap or CubeShadowMap) in the lights' order
    shadow_pairs: torch.Tensor | None = None
    shadow_maps: tuple | None = None


def gs_attr_rows(proj: ProjectedSplats):
    """Per-splat gs2d attribute rows (ops/response.py) and splat ids.

    Returns ((10, N) f32 rows, (N,) i32 ids). The ids are int32, exact for
    every id below 2^31, where the JAX layout carries two f32 rows."""
    n = proj.xy.shape[0]
    if n > 1 << 31:
        raise ValueError(f"{n} splat ids exceed int32")
    rows = torch.stack([
        proj.xy[:, 0], proj.xy[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.alpha,
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        proj.depth,
    ], dim=0)
    return rows, torch.arange(n, dtype=torch.int32, device=proj.xy.device)


SINGLE_ROW_ID_LIMIT = 1 << 24  # the JAX single-row id layouts' f32 ids are exact below it


def host_rank(host_order, n: int, device) -> torch.Tensor:
    """(N,) f32 rank of each splat in a host order: ``rank[host_order[i]] =
    i`` (the JAX ``render_3dgs``'s ``zeros(n).at[host_order].set(arange(n))``:
    a splat the order leaves out keeps rank 0). host_order: (N,) integers,
    a tensor or a numpy array (``AsyncHostSorter.consume``'s), moved to
    ``device``. Ranks are exact below 2^24 and round above it, as the JAX
    package's f32 ranks do."""
    order = torch.as_tensor(host_order, device=device)
    if order.shape != (n,) or order.dtype.is_floating_point:
        raise ValueError(f"host_order must be ({n},) integers, got {order.dtype} "
                         f"{tuple(order.shape)}")
    return torch.zeros(n, dtype=torch.float32, device=device).index_put_(
        (order.long(),), torch.arange(n, dtype=torch.float32, device=device))


def check_single_row_ids(n: int) -> None:
    """The gut3d and packed layouts of the JAX package carry one f32 id row,
    exact only below 2^24 (its ``_id_row``). The port's int32 ids would be
    exact to 2^31, but both packages refuse the same inputs."""
    if n >= SINGLE_ROW_ID_LIMIT:
        raise ValueError(f"{n} splats exceed the 2^24 f32-exact id limit of a single-row "
                         "id layout; use the gs2d f32 path or shard the set")


def gs_attr_rows_packed(proj: ProjectedSplats):
    """Per-splat gs2dp rows (ops/response.py) and splat ids: ((7, N) f32
    rows, (N,) i32 ids), the JAX ``gs_attr_rows_packed`` without its id
    row: ``gs_attr_rows`` packed (``pack_rows``). x, y and the sort depth
    stay exact f32; conic, colour and opacity ride as bf16 / u16 halves of
    f32 words, which carry no gradient. More than 2^24 splats raise
    ValueError (``check_single_row_ids``)."""
    check_single_row_ids(proj.xy.shape[0])
    rows, ids = gs_attr_rows(proj)
    return pack_rows("gs2dp", rows), ids


def gut_attr_rows(prepared: PreparedSplats, proj: ProjectedSplats, cfg: RenderConfig,
                  depth: torch.Tensor | None = None):
    """Per-splat gut3d attribute rows (ops/response.py) and splat ids:
    ((15, N) f32 rows, (N,) i32 ids).

    Position, scale and quaternion come from ``prepared`` itself, so a
    gradient reaches means, scales and quats through them; color, opacity
    and depth from the UT projection. depth: replaces the depth row (3DGRT
    passes radial distance on the bucket path, where that row is the
    merge key). More than 2^24 splats raise ValueError
    (``check_single_row_ids``)."""
    n = proj.xy.shape[0]
    check_single_row_ids(n)
    quats = prepared.quats / torch.linalg.norm(prepared.quats, dim=-1,
                                               keepdim=True).clamp_min(1e-12)
    scl = torch.exp(prepared.scales_log) * cfg.splat_scale
    rows = torch.stack([
        prepared.means[:, 0], prepared.means[:, 1], prepared.means[:, 2],
        scl[:, 0], scl[:, 1], scl[:, 2],
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3],
        proj.alpha,
        proj.depth if depth is None else depth,
    ], dim=0)
    return rows, torch.arange(n, dtype=torch.int32, device=proj.xy.device)


def gut_attr_rows_packed(prepared: PreparedSplats, proj: ProjectedSplats, cfg: RenderConfig,
                         depth: torch.Tensor | None = None):
    """Per-splat gut3dp rows (ops/response.py) and splat ids: ((10, N) f32
    rows, (N,) i32 ids), the JAX ``gut_attr_rows_packed`` without its id
    row: ``gut_attr_rows`` packed (``pack_rows``), exact f32 positions and
    sort depth, bf16 / u16 halves for scale, quaternion, colour and
    opacity. depth: replaces the depth in both the packed word and the
    sort row, as in ``gut_attr_rows``."""
    rows, ids = gut_attr_rows(prepared, proj, cfg, depth)
    return pack_rows("gut3dp", rows), ids


def packed(cfg: RenderConfig) -> bool:
    return cfg.raster.pair_format == "packed"


def raster_statics(cfg: RenderConfig) -> RasterStatics:
    """The blend statics of a 3DGS frame: the gs2d model, or gs2dp for the
    packed tier. SPLAT and ANYHIT are one estimator, the binary accept
    (the JAX ``raster_statics``: ANYHIT's first accepted hit saturates T in
    a sorted front-to-back loop); PASS renders the deterministic frame
    here, as there."""
    return RasterStatics(
        tiles_x=tiles_x(cfg),
        tiles_y=tiles_y(cfg),
        chunk=cfg.raster.chunk,
        alpha_min=cfg.raster.alpha_min,
        alpha_clamp=cfg.raster.alpha_clamp,
        qmax=cfg.raster.alpha_cull_qmax,
        depth_iso=cfg.raster.depth_iso_threshold,
        model="gs2dp" if packed(cfg) else "gs2d",
        stochastic=cfg.stochastic in (StochasticMode.SPLAT, StochasticMode.ANYHIT),
    )


def gut_statics(st: RasterStatics, cfg: RenderConfig, **kw) -> RasterStatics:
    """gut3d statics: the response model (gut3dp for the packed tier), its
    generalized-Gaussian degree, and the degree-0 support cull from
    rt.kernel_scale_deg0 (the JAX ``_gut_statics``)."""
    return dataclasses.replace(
        st, model="gut3dp" if packed(cfg) else "gut3d", kernel_degree=cfg.rt.kernel_degree,
        kernel_min_response=max(st.kernel_min_response, deg0_min_response(cfg.rt)), **kw)


def bucket_statics(cfg: RenderConfig) -> RasterStatics:
    """The bucket blend's statics: the pair statics with the bucket chunk."""
    return dataclasses.replace(raster_statics(cfg), chunk=cfg.raster.bucket_chunk)


def bin_for_cfg(proj: ProjectedSplats, rows: torch.Tensor, ids: torch.Tensor,
                cfg: RenderConfig, max_pairs: int, st: RasterStatics | None = None,
                sort_depth: torch.Tensor | None = None):
    """The bin stage of ``cfg.raster.method``: TileBins (pairs) or
    BucketBins (bucket), for rows of ``st.model`` (gs2d by default).
    sort_depth replaces ``proj.depth`` in the sort key only (3DGRT's radial
    distance, a host order's rank)."""
    grad_rows = model_of(st or raster_statics(cfg)).grad_rows
    if cfg.raster.method == "bucket":
        return bucket_splats(proj, rows, ids, tiles_x=tiles_x(cfg), tiles_y=tiles_y(cfg),
                             caps=tuple(cfg.raster.bucket_caps), grad_rows=grad_rows,
                             sort_depth=sort_depth)
    exact = cfg.raster.expansion == "exact"
    return bin_splats(
        proj, rows, ids,
        tile_size=cfg.raster.tile_size,
        tiles_x=tiles_x(cfg), tiles_y=tiles_y(cfg),
        chunk=cfg.raster.chunk,
        slots_k=cfg.raster.slots_k,
        max_pairs=max_pairs if exact else 0,
        expansion=cfg.raster.expansion,
        grad_rows=grad_rows,
        sort_depth=sort_depth,
    )


def sample_seed(sample: int) -> int:
    """The stochastic stream's seed of temporal sample ``sample`` (the JAX
    pipelines')."""
    return sample * 7919 + 1


def blend_bins(bins, cfg: RenderConfig, st: RasterStatics, pix_ctx=None, seed: int = 0):
    """The blend stage of ``cfg.raster.method``: (out, out_id). ``st`` is
    the pair statics; the bucket path swaps in the bucket chunk. ``seed``
    keys a stochastic ``st``."""
    if cfg.raster.method == "bucket":
        st = dataclasses.replace(st, chunk=cfg.raster.bucket_chunk)
        return rasterize_buckets(bins, st, tuple(cfg.raster.bucket_caps), pix_ctx, seed)
    return rasterize_bins(bins, st, pix_ctx, seed)


def _bin_counts(bins):
    """(num_pairs, overflow) of either kind of bins."""
    return (bins.num_pairs if isinstance(bins, TileBins) else bins.num_valid), bins.overflow


def pairs_cfg(cfg: RenderConfig) -> RenderConfig:
    """``cfg`` binning pairs: the JAX ``bin_for_cfg`` bins pairs whatever
    the method, so every pass that calls it there (the composed, lit and
    hybrid frames, the normal buffer, the shadow maps) bins pairs here."""
    return cfg.replace(raster=dataclasses.replace(cfg.raster, method="pairs"))


def _reject_unported(cfg: RenderConfig) -> None:
    rc = cfg.raster
    if rc.method not in ("pairs", "bucket"):
        raise ValueError(f"unknown raster.method {rc.method!r}")
    if rc.pair_format not in ("f32", "packed"):
        raise ValueError(f"unknown raster.pair_format {rc.pair_format!r}")
    if rc.tile_size != 16:
        raise ValueError("the tile blender requires tile_size == 16")


def _assemble(out, out_id, cfg: RenderConfig):
    return assemble_image(out, out_id, tiles_x(cfg), tiles_y(cfg), cfg.width, cfg.height,
                          cfg.background)


def _maybe_denoise(out: RenderOutput, cfg: RenderConfig) -> RenderOutput:
    """``cfg.denoise="atrous"``: the averaged image filtered by its own guide
    buffers (ops/denoise.py, the JAX ``_maybe_denoise``); aux buffers pass
    through."""
    if cfg.denoise != "atrous":
        return out
    with timing.span("denoise"):
        img = atrous_denoise(out.image, out.depth, out.splat_id, out.transmittance)
    return dataclasses.replace(out, image=img)


def _blend_samples(bins, cfg: RenderConfig, st: RasterStatics, samples: int,
                   cam: Camera | None = None) -> RenderOutput:
    """Blend the frame once per temporal sample, each with its own seed and,
    for gut3d (``cam`` given), its own rays (thin-lens DoF draws new lens
    samples per sample id); average image and transmittance, take the aux
    picks from the first sample (post.comp.slang temporal accumulation; the
    JAX ``render_3dgs`` loops, ``_blend_samples`` and
    ``_blend_samples_bucket``), then ``_maybe_denoise``."""
    img = trans = depth = splat_id = None
    for sample in range(samples):
        pix_ctx = None
        if cam is not None:
            with timing.span("rays"):
                pix_ctx = build_tile_rays(cam, cfg, sample_id=sample)
        with timing.span("blend"):
            out, out_id = blend_bins(bins, cfg, st, pix_ctx, sample_seed(sample))
        with timing.span("assemble"):
            i, t, d, s = _assemble(out, out_id, cfg)
        img = i if img is None else img + i
        trans = t if trans is None else trans + t
        if depth is None:
            depth, splat_id = d, s
    if samples > 1:
        img, trans = img / samples, trans / samples
    num_pairs, overflow = _bin_counts(bins)
    return _maybe_denoise(RenderOutput(image=img, transmittance=trans, depth=depth,
                                       splat_id=splat_id, num_pairs=num_pairs,
                                       overflow=overflow), cfg)


def render_3dgs(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                max_pairs: int = 0, host_order: torch.Tensor | None = None) -> RenderOutput:
    """3DGS raster pipeline (PIPELINE_VERT / PIPELINE_MESH), differentiable
    in ``prepared`` through image and transmittance (depth and splat id are
    not differentiated; nothing of the packed tier is). Each stage runs
    under a ``torch.profiler`` span (``timing.span``) named project, bin,
    blend or assemble (then denoise, for ``cfg.denoise="atrous"``), with
    the child spans project.sh (the SH radiance, SH degree 1 and up) and,
    on the pair path, bin.rows, bin.expand, bin.sort and bin.gather (the
    bucket path: bin.rows). The EWA projection is
    pinhole whatever ``cfg.camera_type`` says, as in the JAX package. A
    stochastic frame blends ``cfg.temporal_samples`` times, a deterministic
    one once (``_blend_samples``).

    max_pairs: pair budget of ``raster.expansion="exact"`` (pair path).
    host_order: (N,) integers, a splat order sorted on the host
    (``SortMethod.HOST``, io/async_loader.AsyncHostSorter; it may be a
    camera move stale), as a tensor or numpy array. Its rank
    (``host_rank``) replaces the depth in the sort key; the picked depth
    stays the model's. On the bucket path with f32 rows the rank also rides
    as the key row (``GS_KEY``) on which the bucket kernels' key-row form
    merges (``RasterStatics.key_is_row``); packed rows have no room for it
    and take the pair path, as in the JAX package."""
    _reject_unported(cfg)
    st = raster_statics(cfg)
    with timing.span("project"):
        proj = project_splats(prepared, cam, cfg)
    with timing.span("bin"):
        with timing.span("bin.rows"):
            rows, ids = (gs_attr_rows_packed if packed(cfg) else gs_attr_rows)(proj)
        rank = None
        if host_order is not None:
            rank = host_rank(host_order, rows.shape[1], rows.device)
            if cfg.raster.method == "bucket" and packed(cfg):
                cfg = cfg.replace(raster=dataclasses.replace(cfg.raster, method="pairs"))
            elif cfg.raster.method == "bucket":
                rows = torch.cat([rows, rank[None]])
                st = dataclasses.replace(st, key_is_row=True)
        bins = bin_for_cfg(proj, rows, ids, cfg, max_pairs, st, sort_depth=rank)
    samples = max(cfg.temporal_samples, 1) if st.stochastic else 1
    return _blend_samples(bins, cfg, st, samples)


def gut_bin(prepared: PreparedSplats, proj: ProjectedSplats, cam: Camera, cfg: RenderConfig,
            max_pairs: int = 0, radial_order: bool = False):
    """The bin stage of the gut3d pipelines: (bins, statics).

    radial_order (3DGRT): the reference marches BVH hits through a sorted
    k-buffer per pass (rgen:615-818) to recover each ray's front-to-back
    order; sorting by euclidean distance to the shared ray origin
    reproduces that order for splat centers, and the blend runs at
    rt.alpha_clamp and rt.min_transmittance. The radial distance orders the
    blend on both binning paths but lands in different places, as in the
    JAX package: on the pair path it replaces the depth in the sort key
    only, so the picked depth stays view z; on the bucket path, whose kernel
    merges on the depth row, it is the depth row, so the picked depth is
    the radial distance (in the packed tier both the packed depth and the
    sort row)."""
    st = raster_statics(cfg)
    attr_rows = gut_attr_rows_packed if packed(cfg) else gut_attr_rows
    if not radial_order:
        st = gut_statics(st, cfg)
        with timing.span("bin.rows"):
            rows, ids = attr_rows(prepared, proj, cfg)
        return bin_for_cfg(proj, rows, ids, cfg, max_pairs, st), st
    st = gut_statics(st, cfg, alpha_clamp=cfg.rt.alpha_clamp,
                     min_transmittance=cfg.rt.min_transmittance)
    radial = torch.linalg.norm(prepared.means.detach() - cam.position, dim=-1)
    bucket = cfg.raster.method == "bucket"
    with timing.span("bin.rows"):
        rows, ids = attr_rows(prepared, proj, cfg, depth=radial if bucket else None)
    return bin_for_cfg(proj, rows, ids, cfg, max_pairs, st, sort_depth=radial), st


def _render_gut(prepared, cam, cfg, max_pairs, radial_order):
    _reject_unported(cfg)
    with timing.span("project"):
        proj = ut_project_splats(prepared, cam, cfg)
    with timing.span("bin"):
        bins, st = gut_bin(prepared, proj, cam, cfg, max_pairs, radial_order)
    return _blend_samples(bins, cfg, st, max(cfg.temporal_samples, 1), cam)


def render_3dgut(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                 max_pairs: int = 0) -> RenderOutput:
    """3DGUT raster pipeline (PIPELINE_MESH_3DGUT): unscented-transform
    projection for binning + the exact per-pixel 3D ray response in the
    blender, with thin-lens DoF and temporal-sample averaging (each sample
    also keys a stochastic blend). Stage spans: project, bin, then rays,
    blend and assemble per sample (and denoise); child spans as
    ``render_3dgs``'s: project.sh, bin.rows and, on the pair path,
    bin.expand, bin.sort and bin.gather."""
    return _render_gut(prepared, cam, cfg, max_pairs, radial_order=False)


def render_3dgrt(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                 max_pairs: int = 0) -> RenderOutput:
    """3DGRT primary rays (PIPELINE_RTX) as a raster pass: 3DGUT's frame in
    radial order (``gut_bin``), the stage spans of ``render_3dgut``."""
    return _render_gut(prepared, cam, cfg, max_pairs, radial_order=True)


def _composed_frame(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig, max_pairs: int,
                    mesh, lights):
    """The mesh-composited frame of ``render_3dgs_composed``: (RenderOutput,
    the splats' transmittance in front of the mesh (H,W), the mesh pass's
    face id (H,W) int32)."""
    _reject_unported(cfg)
    with timing.span("mesh"):
        mesh_img, mesh_trans, mesh_depth, face_id = render_mesh(mesh, cam, cfg, max_pairs, lights)
    pairs = pairs_cfg(cfg)
    st = dataclasses.replace(raster_statics(cfg), model="gs2d_clip")
    with timing.span("project"):
        proj = project_splats(prepared, cam, cfg)
    with timing.span("bin"):
        rows, ids = gs_attr_rows(proj)
        bins = bin_for_cfg(proj, rows, ids, pairs, max_pairs, st)
    with timing.span("blend"):
        out, out_id = rasterize_bins(bins, st, depth_limit_pix_ctx(mesh_depth, cfg), 0)
    with timing.span("assemble"):
        img, trans, depth, splat_id = assemble_image(out, out_id, st.tiles_x, st.tiles_y,
                                                     cfg.width, cfg.height)
        covered = mesh_trans < 0.5
        frame = RenderOutput(image=img + trans[..., None] * mesh_img,
                             transmittance=trans * mesh_trans,
                             depth=torch.where((depth == 0) & covered, mesh_depth, depth),
                             splat_id=splat_id, num_pairs=bins.num_pairs, overflow=bins.overflow)
    return frame, trans, face_id


def render_3dgs_composed(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                         max_pairs: int = 0, mesh=None, lights=()) -> RenderOutput:
    """3DGS raster composited with an opaque triangle mesh (the FTB
    mesh-composited frame, gaussian_splatting.cpp:705-850; the JAX
    ``render_3dgs_composed``): the mesh pass (``render_mesh``, its depth
    prepass), then the splat pass clipped by the mesh depth, then the mesh
    colour under the splats' remaining transmittance. The splat pass bins
    pairs whatever ``raster.method`` says and blends f32 gs2d rows with the
    gs2d_clip model whatever ``pair_format`` says, over a black background,
    once (a stochastic one with seed 0: no temporal samples, no denoise),
    as the JAX function does. Differentiable in ``prepared`` (K2's gs2d_clip
    form) and, through a flat mesh, in its face colours. ``num_pairs`` and
    ``overflow`` are the splat pass's. The depth falls back to the mesh's
    where the splats picked none and the mesh covers."""
    return _composed_frame(prepared, cam, cfg, max_pairs, mesh, lights)[0]


def render_composed_wavefront(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                              max_pairs: int = 0, mesh=None, lights=(),
                              max_bounces: int | None = None, stride: int = 1, shadow_fn=None):
    """The mesh-composited frame plus wavefront secondary bounces (the
    reflect / refract bounce loop of rgen:244-337 on the raster primary
    pass; the JAX ``render_composed_wavefront`` without its ``interpret``):
    pixels whose mesh face is reflective (illum 1) or refractive (illum >=
    2), every ``stride``-th in each axis, continue as one batch of rays
    traced against the mesh and the splats for ``max_bounces`` bounces
    (default ``cfg.rt.max_bounces``; render/wavefront.py), their radiance
    upsampled and added. shadow_fn: a scalar shadow function for the
    bounces' mesh shading (a per-channel one raises ValueError, as in the
    JAX package). Spans: those of ``render_3dgs_composed``, then spawn and
    per bounce bounce (trace, shade). Returns (RenderOutput of the composed
    frame, the image with the bounces (H,W,3))."""
    frame, splat_trans, face_id = _composed_frame(prepared, cam, cfg, max_pairs, mesh, lights)
    with timing.span("spawn"):
        origins, dirs, throughput, _, shape_lr = secondary_spawn(cam, cfg, mesh, face_id,
                                                                 splat_trans, stride)
    radiance = trace_secondary(prepared, cam, cfg, mesh, origins, dirs, throughput, lights,
                               shadow_fn, max_bounces)
    return frame, add_secondary_radiance(frame.image, radiance, shape_lr, cfg)


def _set_index_for(material, splat_id, instance_base):
    """(H,W) int32 set index of each pixel where ``material`` is per set (a
    tuple), else None: the global-index-table material routing of
    deferred_shading.comp.slang:107-124."""
    from vk_gaussian_splatting_tpu_torch.render.deferred import (
        DeferredMaterial,
        instance_index_image,
    )
    if isinstance(material, DeferredMaterial):
        return None
    if instance_base is None or len(instance_base) == 0:
        raise ValueError("per-set materials need instance_base (the "
                         "GlobalIndexTable.instance_base offsets)")
    return instance_index_image(splat_id, instance_base)


def _lit_frame(prepared, cam, cfg, max_pairs, lights, material, instance_base, use_gut,
               shadow_res=None, shadow_max_pairs=None):
    """The lit frames' common body: the primary pass (f32 gs2d or gut3d rows,
    pairs, seed 0, over the background), the normal buffer, then with a
    ``shadow_res`` the lights' shadow maps (each in a pair budget of
    ``shadow_max_pairs``), then the shade. Returns (RenderOutput, shaded,
    normal image); the RenderOutput's ``overflow`` is the primary's or any
    map's, and its ``shadow_pairs`` and ``shadow_maps`` are the maps'."""
    from vk_gaussian_splatting_tpu_torch.render.deferred import (
        DeferredMaterial,
        deferred_shade,
        render_normal_buffer,
    )
    _reject_unported(cfg)
    if material is None:
        material = DeferredMaterial()
    st = raster_statics(cfg)
    if use_gut:
        st = dataclasses.replace(gut_statics(st, cfg), model="gut3d")
    else:
        st = dataclasses.replace(st, model="gs2d")
    pix_ctx = None
    with timing.span("project"):
        proj = (ut_project_splats if use_gut else project_splats)(prepared, cam, cfg)
    with timing.span("bin"):
        rows, ids = gut_attr_rows(prepared, proj, cfg) if use_gut else gs_attr_rows(proj)
        bins = bin_for_cfg(proj, rows, ids, pairs_cfg(cfg), max_pairs, st)
    if use_gut:
        with timing.span("rays"):
            pix_ctx = build_tile_rays(cam, cfg, sample_id=0)
    with timing.span("blend"):
        out, out_id = rasterize_bins(bins, st, pix_ctx, 0)
    with timing.span("assemble"):
        img, trans, depth, splat_id = _assemble(out, out_id, cfg)
    with timing.span("normals"):
        normal_img = render_normal_buffer(prepared, proj, cam, cfg, st, max_pairs, pix_ctx,
                                          use_gut_rows=use_gut)
    shadow_fn = None
    if shadow_res is not None and lights:
        from vk_gaussian_splatting_tpu_torch.render.shadows import (
            make_ray_shadow_fn,
            make_shadow_fn,
        )
        shadow_fn = (make_ray_shadow_fn(prepared, cfg) if cfg.rt.shadows == "ray"
                     else make_shadow_fn(prepared, tuple(lights), cfg, shadow_res,
                                         shadow_max_pairs))
    with timing.span("shade"):
        shaded = deferred_shade(img, trans, normal_img, depth, cam, cfg, list(lights), material,
                                shadow_fn=shadow_fn,
                                set_index_img=_set_index_for(material, splat_id, instance_base))
    frame = RenderOutput(image=img, transmittance=trans, depth=depth, splat_id=splat_id,
                         num_pairs=bins.num_pairs, overflow=bins.overflow)
    if shadow_fn is not None and cfg.rt.shadows != "ray":
        frame = dataclasses.replace(frame, overflow=frame.overflow | shadow_fn.overflow,
                                    shadow_pairs=shadow_fn.num_pairs,
                                    shadow_maps=tuple(shadow_fn.maps.values()))
    return frame, shaded, normal_img


def render_3dgs_lit(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                    max_pairs: int = 0, lights=(), material=None, instance_base=()):
    """3DGS raster + surface reconstruction + deferred Phong shading (the
    raster frame with lighting, gaussian_splatting.cpp:888-908 + S11; the
    JAX ``render_3dgs_lit``): the 3DGS pass (f32 gs2d rows binned as pairs
    whatever the config's method and format; a stochastic one blends once
    with seed 0), its opacity-weighted normal buffer
    (``render_normal_buffer``) and ``deferred_shade``.

    material: one DeferredMaterial (the default one if None), or a tuple
    of them, one per instance, routed per pixel by the splat-id pick and
    ``instance_base`` (the global index table's instance offsets, (0, n1,
    n1 + n2, ..., N): a sequence, or ``GlobalIndexTable.instance_base``
    itself). Stage spans: project, bin, blend, assemble, normals,
    shade. Differentiable in ``prepared`` through the image, the normal
    buffer and the shade. Returns (RenderOutput, shaded (H,W,3), normals
    (H,W,3))."""
    return _lit_frame(prepared, cam, cfg, max_pairs, lights, material, instance_base,
                      use_gut=False)


def render_hybrid(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                  max_pairs: int = 0, lights=(), material=None, instance_base=(),
                  shadow_res: int = 512, shadow_max_pairs: int | None = None):
    """The hybrid pipelines (PIPELINE_HYBRID, PIPELINE_HYBRID_3DGUT; the JAX
    ``render_hybrid``): raster primary visibility, by the 3DGS pass or, on
    HYBRID_3DGUT, the 3DGUT pass (UT projection, rays of sample 0, f32
    gut3d rows), binned as pairs; its normal buffer; then deferred shading
    with per-light shadow transmittance — the raster + secondary-ray structure
    of rgen:343-460/1261-1464. ``cfg.rt.shadows == "map"``: deep shadow
    maps (render/shadows.py ``make_shadow_fn``: a cone map of
    ``shadow_res``, a six-face cube map for a point light inside the
    scene's bounding sphere); ``"ray"``: a shadow ray per shade point and
    light through the splats (``make_ray_shadow_fn``). With no light it
    shades by the headlight, unshadowed. Stage spans as
    ``render_3dgs_lit``, with rays (3DGUT) and a shadow_map span per light
    before shade, holding each map's shadow_map.project, shadow_map.bin and
    shadow_map.blend (ray shadows: a trace span per light within shade).

    max_pairs: the primary's pair budget (the normal buffer's too);
    shadow_max_pairs: every map's (None: max(4 N, 2^18)). With maps the
    RenderOutput's ``overflow`` fires if the primary or any map
    overflowed, ``shadow_pairs`` holds the maps' live pairs, summed, and
    ``shadow_maps`` the maps. Returns (RenderOutput, shaded, normals)."""
    return _lit_frame(prepared, cam, cfg, max_pairs, lights, material, instance_base,
                      use_gut=cfg.pipeline == Pipeline.HYBRID_3DGUT, shadow_res=shadow_res,
                      shadow_max_pairs=shadow_max_pairs)


def render_3dgrt_exact(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
                       ray_block: int = 4096, chunk: int = 512) -> RenderOutput:
    """3DGRT primaries in exact per-ray t order: the strict tier (the JAX
    ``render_3dgrt_exact``). Every pixel ray (pinhole, from ``cam.fx``,
    ``fy``, ``cx``, ``cy``, through the pixel centre) is traced through
    the splats by ``ops/raytrace.trace_splats`` in the windowed order
    (``rt.max_passes`` per-ray t-slabs, the tMin advance of rgen:676-818),
    at a trace's cost and with no tile raster. The depth is each ray's
    iso-depth (rgen:728-741); no splat id is picked (-1); ``num_pairs`` is
    N and ``overflow`` False. Span: trace."""
    _reject_unported(cfg)
    h, w = cfg.height, cfg.width
    dev = cam.viewmat.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
                            indexing="ij")
    d_cam = torch.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                         torch.ones_like(xs)], -1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    # d_cam @ viewmat[:3, :3] as f32 sums of products (the JAX matmul)
    flat_d = (d_cam.reshape(-1, 3)[:, :, None] * cam.viewmat[None, :3, :3]).sum(dim=1)
    flat_o = cam.position.expand(flat_d.shape)
    r = flat_d.shape[0]
    res = trace_splats(prepared, flat_o, flat_d, flat_d.new_zeros(r),
                       flat_d.new_full((r,), float("inf")), cfg, chunk=chunk,
                       ray_block=ray_block, order="windowed")
    img = res.radiance.reshape(h, w, 3)
    trans = res.transmittance.reshape(h, w)
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    return RenderOutput(
        image=img + trans[..., None] * bg, transmittance=trans,
        depth=res.depth.reshape(h, w),
        splat_id=torch.full((h, w), -1, dtype=torch.int32, device=dev),
        num_pairs=torch.tensor(prepared.means.shape[0], dtype=torch.int32, device=dev),
        overflow=torch.tensor(False, device=dev))


def render(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
           max_pairs: int = 0, **kw) -> RenderOutput:
    """Pipeline dispatch (shaderio.h:61-66 pipeline ids): VERT and MESH to
    ``render_3dgs``, MESH_3DGUT to ``render_3dgut``, RTX to ``render_3dgrt``,
    HYBRID and HYBRID_3DGUT to ``render_hybrid``, whose RenderOutput it
    returns (``kw``: its lights, material, instance_base, shadow_res,
    shadow_max_pairs)."""
    if cfg.pipeline in (Pipeline.HYBRID, Pipeline.HYBRID_3DGUT):
        return render_hybrid(prepared, cam, cfg, max_pairs, **kw)[0]
    if cfg.pipeline == Pipeline.MESH_3DGUT:
        return render_3dgut(prepared, cam, cfg, max_pairs, **kw)
    if cfg.pipeline == Pipeline.RTX:
        return render_3dgrt(prepared, cam, cfg, max_pairs, **kw)
    return render_3dgs(prepared, cam, cfg, max_pairs, **kw)
