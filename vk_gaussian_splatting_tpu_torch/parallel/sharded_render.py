"""Multi-device sharding policies (SURVEY.md §2.4, §5 "long-context" analogs).

The reference is a single-GPU app; its scale escape hatches (sparse
LargeBuffers for >4 GB attributes, multi-TLAS chunking past 16.7M instances —
splat_set_vk.h:175, splat_set_manager_vk.cpp:1060) become ranks of a
``torch.distributed`` process group here, one rank per device (NCCL on
cards, gloo on the CPU), over a 1-D ``DeviceMesh`` (``make_mesh``):

- **splat sharding**: each rank stores and projects its N/D splats (the
  same count on every rank, ``parallel.distributed.shard_leading``) — the
  LargeBuffer replacement; attribute memory scales with devices.
- **tile sharding**: each rank blends a horizontal band of tile rows; the
  compact projected fields (13 f32 per splat, far smaller than raw
  parameters) ride one all-gather across the group, the rank's band
  shifted into a short image of its own (a band-local grid on the bucket
  path).
- gradients: the all-gather's backward is a reduce-scatter (sum) to the
  owning rank, so per-splat parameter gradients land sharded exactly like
  the parameters; each rank back-propagates its own band's loss, so the
  summed loss is reduced for reporting only and no gradient is scaled by
  the world size.

Each stage runs under a ``torch.profiler`` span: prepare, project, gather
(the collectives), rays (gut3d), bin, blend, assemble; in the train step
also loss and backward.

Every rank calls each function with its own shard and the same camera and
config; a function returns the rank's band. Nothing gathers the image: it
stays distributed, as the JAX package's band-sharded global array does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.profiler import record_function

from vk_gaussian_splatting_tpu_torch.config import RenderConfig, tiles_y
from vk_gaussian_splatting_tpu_torch.ops.projection import (
    ProjectedSplats,
    project_splats,
    ut_project_splats,
)
from vk_gaussian_splatting_tpu_torch.ops.rasterize import assemble_image
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    bin_for_cfg,
    blend_bins,
    gs_attr_rows,
    gut_attr_rows,
    gut_statics,
    raster_statics,
    sample_seed,
)
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays
from vk_gaussian_splatting_tpu_torch.scene.cameras import Camera
from vk_gaussian_splatting_tpu_torch.scene.splat_set import SplatSet, prepare_splats

PROJ_FLOATS = 13  # xy 2, conic 3, depth, radius 2, color 3, alpha, valid


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device_type: str | None = None) -> DeviceMesh:
    """1-D DeviceMesh over every rank of the initialised process group
    (``parallel.distributed.initialize``), one device per rank. n_devices:
    the world size, if given (a mesh over fewer ranks than the group is not
    supported). device_type: where the ranks' tensors live, "cuda" or
    "cpu"; by default "cuda" under NCCL and "cpu" otherwise (gloo also
    carries CUDA tensors: pass "cuda")."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a group of {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The rank's device of ``mesh``: its current CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _AllGather(torch.autograd.Function):
    """Concatenate every rank's ``x`` along ``dim`` in rank order; the
    backward reduce-scatters (sums) the gradient back to the owning rank."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((dist.get_world_size(group) * xt.shape[0], *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        gt = g.movedim(ctx.dim, 0).contiguous()
        out = gt.new_empty((gt.shape[0] // dist.get_world_size(ctx.group), *gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt, op=dist.ReduceOp.SUM, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along
    ``dim`` in rank order, differentiable: its backward sums each rank's
    slice of the gradient over the ranks into the owner's."""
    return _AllGather.apply(x, group, dim)


def _any(flag: torch.Tensor, group) -> torch.Tensor:
    """() bool: ``flag`` is set on some rank."""
    t = flag.to(torch.int32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t[0] > 0


def _band_rows(cfg: RenderConfig, n_bands: int) -> int:
    """Tile rows per band, padded up: when tiles_y does not divide the mesh
    size, the last band renders rows past the image (empty — the shifted
    projection leaves them uncovered) and is cropped to the height."""
    return -(-tiles_y(cfg) // n_bands)


def band_span(cfg: RenderConfig, band: int, n_bands: int) -> tuple[int, int]:
    """(first row, end row) of the image that band ``band`` of ``n_bands``
    holds: rows [band * h, min((band + 1) * h, H)) for h the band's padded
    height (empty where the padding leaves a band past the image)."""
    h = _band_rows(cfg, n_bands) * cfg.raster.tile_size
    y0 = min(band * h, cfg.height)
    return y0, min(y0 + h, cfg.height)


def _band_cfg(cfg: RenderConfig, n_bands: int) -> RenderConfig:
    """The band's own short image, f32 rows (the sharded path blends the f32
    models whatever ``pair_format`` says, as in the JAX package)."""
    return cfg.replace(height=_band_rows(cfg, n_bands) * cfg.raster.tile_size,
                       raster=dataclasses.replace(cfg.raster, pair_format="f32"))


def _band_offset(cfg: RenderConfig, band: int, n_bands: int) -> float:
    return float(band * _band_rows(cfg, n_bands) * cfg.raster.tile_size)


def _shift(proj: ProjectedSplats, y_off: float) -> ProjectedSplats:
    """``proj`` with y moved up by the band's row offset (x as it is: the
    JAX package's ``xy - [0, y_off]``, with no host-to-device copy, which
    from pageable memory would wait for the stream)."""
    return dataclasses.replace(proj, xy=torch.stack([proj.xy[:, 0], proj.xy[:, 1] - y_off], 1))


def _band_raster(shifted: ProjectedSplats, rows, ids, local_cfg: RenderConfig, st,
                 max_pairs: int, pix_ctx=None, sort_depth=None):
    """Blend one band (an ordinary short image) by the configured method —
    pair binning, or on method="bucket" a band-local bucket grid — once
    (sample 0's seed where ``st`` is stochastic). Returns (img, trans,
    overflow)."""
    with record_function("bin"):
        bins = bin_for_cfg(shifted, rows, ids, local_cfg, max_pairs, st, sort_depth)
    with record_function("blend"):
        out, out_id = blend_bins(bins, local_cfg, st, pix_ctx, sample_seed(0))
    with record_function("assemble"):
        img, trans, _, _ = assemble_image(out, out_id, st.tiles_x, st.tiles_y, local_cfg.width,
                                          local_cfg.height, local_cfg.background)
    return img, trans, bins.overflow


def _render_band(proj: ProjectedSplats, cfg: RenderConfig, max_pairs: int,
                 band: int, n_bands: int):
    """Rasterize one horizontal band of tile rows against full projected splats."""
    shifted = _shift(proj, _band_offset(cfg, band, n_bands))
    local_cfg = _band_cfg(cfg, n_bands)
    rows, ids = gs_attr_rows(shifted)
    return _band_raster(shifted, rows, ids, local_cfg, raster_statics(local_cfg), max_pairs)


def _gather_proj(proj: ProjectedSplats, group) -> ProjectedSplats:
    """Every rank's projected fields in rank order, by one all-gather of
    (N/D, PROJ_FLOATS) f32 (``valid`` rides as 0 / 1), each field then
    contiguous again (the bin stage's elementwise kernels read strided
    columns more slowly)."""
    packed = torch.cat([proj.xy, proj.conic, proj.depth[:, None], proj.radius, proj.color,
                        proj.alpha[:, None], proj.valid[:, None].to(torch.float32)], dim=1)
    with record_function("gather"):
        g = all_gather(packed, group)
        xy, conic, depth, radius, color, alpha, valid = (
            f.contiguous() for f in torch.split(g, [2, 3, 1, 2, 3, 1, 1], dim=1))
    return ProjectedSplats(xy=xy, conic=conic, depth=depth[:, 0], radius=radius, color=color,
                           alpha=alpha[:, 0], valid=valid[:, 0] > 0.5)


def _crop(img, trans, cfg: RenderConfig, band: int, n_bands: int):
    y0, y1 = band_span(cfg, band, n_bands)
    return img[:y1 - y0], trans[:y1 - y0]


def render_3dgs_sharded(splats: SplatSet, cam: Camera, cfg: RenderConfig,
                        max_pairs: int, mesh: DeviceMesh):
    """Forward 3DGS render with the splats sharded over the mesh's ranks and
    the image over horizontal bands. splats: this rank's shard (rank r holds
    global splats [r n, (r + 1) n), n the shard size, the same on every
    rank). Returns (image, transmittance, overflow): this rank's band, rows
    ``band_span(cfg, rank, mesh.size())`` of the (H, W, 3) image and (H, W)
    transmittance, plus the OR of all bands' overflow flags."""
    group, nd, band = mesh.get_group(), mesh.size(), mesh.get_local_rank()
    with record_function("prepare"):
        prepared = prepare_splats(splats, cfg.sh_format)
    with record_function("project"):
        proj = project_splats(prepared, cam, cfg)
    img, trans, ov = _render_band(_gather_proj(proj, group), cfg, max_pairs, band, nd)
    return (*_crop(img, trans, cfg, band, nd), _any(ov, group))


def _gut_band(splats: SplatSet, cam: Camera, cfg: RenderConfig, max_pairs: int,
              mesh: DeviceMesh, radial_order: bool):
    """The gut3d band of 3DGUT (view-z order) or 3DGRT (radial order, its
    clamp and transmittance cutoff): splat-sharded UT projection and rows,
    the id row offset by the shard base before the gather, the rays of the
    band's sub-viewport (cy shifted: the pixel context never crosses bands)."""
    group, nd, band = mesh.get_group(), mesh.size(), mesh.get_local_rank()
    with record_function("prepare"):
        prepared = prepare_splats(splats, cfg.sh_format)
    with record_function("project"):
        proj = ut_project_splats(prepared, cam, cfg)
    local_cfg = _band_cfg(cfg, nd)
    st = raster_statics(local_cfg)
    radial = None
    if radial_order:
        st = gut_statics(st, local_cfg, alpha_clamp=cfg.rt.alpha_clamp,
                         min_transmittance=cfg.rt.min_transmittance)
        radial = torch.linalg.norm(prepared.means.detach() - cam.position, dim=-1)
        bucket = cfg.raster.method == "bucket"
        rows, ids = gut_attr_rows(prepared, proj, local_cfg, depth=radial if bucket else None)
        radial = all_gather(radial, group)
    else:
        st = gut_statics(st, local_cfg)
        rows, ids = gut_attr_rows(prepared, proj, local_cfg)
    with record_function("gather"):
        ids = all_gather(ids + band * ids.shape[0], group)
        rows = all_gather(rows, group, dim=1)
    y_off = _band_offset(cfg, band, nd)
    shifted = _shift(_gather_proj(proj, group), y_off)
    band_cam = dataclasses.replace(cam, cy=cam.cy - y_off)
    with record_function("rays"):
        pix_ctx = build_tile_rays(band_cam, local_cfg)
    img, trans, ov = _band_raster(shifted, rows, ids, local_cfg, st, max_pairs, pix_ctx,
                                  sort_depth=radial)
    return (*_crop(img, trans, cfg, band, nd), _any(ov, group))


def render_3dgut_sharded(splats: SplatSet, cam: Camera, cfg: RenderConfig,
                         max_pairs: int, mesh: DeviceMesh):
    """3DGUT forward with splat-sharded UT projection and band-sharded
    exact-ray rasterization (``render_3dgs_sharded``'s shards and bands).
    Each band blends with rays regenerated for its sub-viewport, once.
    Global shutter only (rolling shutter needs global scan coordinates).
    Returns (image band, transmittance band, overflow)."""
    return _gut_band(splats, cam, cfg, max_pairs, mesh, radial_order=False)


def render_3dgrt_sharded(splats: SplatSet, cam: Camera, cfg: RenderConfig,
                         max_pairs: int, mesh: DeviceMesh):
    """3DGRT primary rays over the mesh: splat-sharded UT projection +
    band-sharded exact-ray blending in shared-origin RADIAL order (the
    per-ray-t order of rgen:615-818 for primaries — see render_3dgrt), the
    radial distance gathered as the sort key. Returns (image band,
    transmittance band, overflow), as ``render_3dgs_sharded``."""
    return _gut_band(splats, cam, cfg, max_pairs, mesh, radial_order=True)


def train_step_sharded(splats: SplatSet, cam: Camera, target: torch.Tensor,
                       cfg: RenderConfig, max_pairs: int, mesh: DeviceMesh,
                       lr: float = 1e-2):
    """One SGD step of image-supervised splat optimization over the mesh:
    the loss is the sum of squared differences of the 3DGS frame and the
    target.

    splats: this rank's shard (as ``render_3dgs_sharded``). target: this
    rank's band of the (H, W, 3) target, rows ``band_span(cfg, rank,
    mesh.size())``. Returns (this rank's updated shard, a new SplatSet, and
    the loss summed over all ranks)."""
    group, nd, band = mesh.get_group(), mesh.size(), mesh.get_local_rank()
    y0, y1 = band_span(cfg, band, nd)
    if target.shape[0] != y1 - y0:
        raise ValueError(f"target band of {target.shape[0]} rows, band {band} holds {y1 - y0}")
    params = {f.name: getattr(splats, f.name).detach().requires_grad_(True)
              for f in dataclasses.fields(splats)}
    with record_function("prepare"):
        prepared = prepare_splats(SplatSet(**params), cfg.sh_format)
    with record_function("project"):
        proj = project_splats(prepared, cam, cfg)
    img, _, _ = _render_band(_gather_proj(proj, group), cfg, max_pairs, band, nd)
    with record_function("loss"):
        loss = torch.sum((img[:y1 - y0] - target) ** 2)
    with record_function("backward"):
        loss.backward()
    new = SplatSet(**{k: (p - lr * p.grad).detach() for k, p in params.items()})
    total = loss.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return new, total
