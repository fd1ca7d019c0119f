"""Pair-list tile blender, forward and backward: the CUDA kernels' wrappers,
their plain PyTorch twins, the autograd Function that joins them, and
``assemble_image``.

Counterpart of ``vk_gaussian_splatting_tpu/ops/rasterize_pallas.py``: K1
(``_make_fwd_kernel``, :202-364) and K2 (``_make_bwd_kernel``, :367-483,
wrapped by ``_rt_bwd``, :599-633) for the gs2d and gut3d response models
(``RasterStatics.model``, ops/response.py), and ``assemble_image``
(:645-680). The CUDA kernels are ``csrc/rasterize_fwd.cu`` and
``csrc/rasterize_bwd.cu``, one entry point per model in each. The packed
models gs2dp and gut3dp and the smooth triangles tri2d_smooth
(ops/response.py) are forward only: K1 has an entry for each, and a
backward through them raises NotImplementedError, as
``rasterize_pallas._rt_bwd`` does. The mesh models gs2d_clip (gs2d behind
a per-pixel depth limit) and tri2d (flat opaque triangles) have both.

The gut3d model reads a per-tile pixel context ``pix_ctx``, (T, 8, 256) f32
rays (render/rays.py), and gs2d_clip one whose row 6 is the depth limit; it
gets no gradient, as in the JAX package. gut3d's attributes are 15 f32
rows, gs2d's 10 (ops/response.py).

Per tile the output is rows ``(r, g, b, T, depth)`` over the tile's 256
pixels, ``(T, 5, 256)`` f32, plus the picked splat ids ``(T, 256)`` int32 —
the id never passes through a float. Unlike the TPU kernel, every tile is
written: an empty tile is rgb 0, T 1, depth 0, id -1.

``rasterize_tiles`` is differentiable in ``attrs`` through rgb and T; the
picked depth and id are not differentiated (as in the JAX package). On CUDA
tensors the forward launches K1 and the backward K2; on CPU tensors both
run the plain twins; nothing else decides which. A failed build or launch
raises. Each wrapper counts its launches per form: ``launches`` for gs2d,
``launches_<model>`` for each other model (``LAUNCH_COUNTER``), and each of
those with ``_stoch`` appended for the stochastic form
(``RasterStatics.stochastic``; the triangles have none).

Stochastic transparency (``RasterStatics.stochastic``, the JAX
``_alpha_closure``, rasterize_pallas.py:180-194): each pair that passes the
cutoffs is accepted as opaque (alpha exactly 1) where a uniform
``hash_uniform(key, pixel, lane)`` (ops/response.py) falls below its alpha,
else dropped. On the pair path the key is ``seed + p // chunk`` and the lane
``p % chunk``, p the global pair index, as the TPU kernel keys its 128-lane
blocks (:237, :393); the bucket twins key by their own layout
(``key_offset``, ops/raster_bucket.py). ``seed`` is per temporal sample.
The accept has no gradient: the backward gives the colour rows theirs and
every other row 0, as ``jax.vjp`` of the JAX ``where`` does.

The multi-iso form (``RasterStatics.multi_iso``, gs2d alone, deterministic;
the deep shadow map's, rasterize_pallas.py:304-356, render/shadows.py)
records per pixel the depths at which T first falls below each of the four
``iso_thresholds`` in place of the (depth, id) pick: its output is
``(T, 8, 256)``, rows 0-3 gs2d's rgb and T, rows 4-7 the four depths (0
where nothing was picked), and its ids are -1. Its backward is gs2d's (the
JAX ``_rt_bwd`` reads rows 0-3 alone).
"""

from __future__ import annotations

import ctypes
import dataclasses
import typing

import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.ops import _build
from vk_gaussian_splatting_tpu_torch.ops.response import (
    ATTR_B,
    ATTR_R,
    PIX,
    PIX_ROWS,
    TILE,
    WARP_OF_PIXEL,
    WARP_PIXELS,
    WARPS,
    MODELS,
    alpha,
    alpha_vjp,
    bound_of_warp,
    hash_uniform,
    may_hit,
    model_of,
    pair_reach,
    pixel_attrs,
    reach_may_hit,
    refuse_backward,
    stochastic_accept,
    tile_bound,
    unpack_rows,
    warp_bound,
)

OUT_ROWS = 5       # r, g, b, T, depth
CTX_ROWS = 5       # backward context: g_r, g_g, g_b, S_total, g_T * T_final
GRAD_ROWS = ATTR_B + 1  # gs2d: rows 0-8 get gradients; the depth row gets none
MAX_CHUNK = 256    # csrc/rasterize_{fwd,bwd}.cu stage at most this many pairs
STOCH = "_stoch"  # the suffix of a stochastic form's counters and C entries
KEYROW = "_keyrow"  # the suffix of a key-row form's (RasterStatics.key_is_row, gs2d)
ISO = "_iso"  # the suffix of the multi-iso form's (RasterStatics.multi_iso, gs2d)
ISO_OUT_ROWS = 8   # the multi-iso form: r, g, b, T, four iso depths
ISO_PICKS = 4      # its picks: one per transmittance level
# the model of each kernel form (a model, + STOCH for its stochastic form,
# + KEYROW for the bucket kernels' key-row form of gs2d, + ISO for K1's
# multi-iso form of gs2d)
FORM_MODEL = {m: m for m in MODELS}
FORM_MODEL.update({m + STOCH: m for m in MODELS if MODELS[m].stochastic})
FORM_MODEL.update({"gs2d" + KEYROW: "gs2d", "gs2d" + STOCH + KEYROW: "gs2d",
                   "gs2d" + ISO: "gs2d"})
# the launch counter of each form, an attribute of each kernel's wrapper;
# and the kept count of the last launch of each culling kernel (K1, K2, K3,
# K4), an attribute of its wrapper, per form
LAUNCH_COUNTER = {f: "launches" + f.removeprefix("gs2d") if FORM_MODEL[f] == "gs2d"
                  else "launches_" + f for f in FORM_MODEL}
KEPT_COUNTER = {f: "kept" + name.removeprefix("launches") for f, name in LAUNCH_COUNTER.items()}


def form_of(st) -> str:
    """The kernel form of ``st``: its model, + ``STOCH`` if stochastic,
    + ``KEYROW`` if it merges on the key row, + ``ISO`` if multi-iso."""
    return (st.model + (STOCH if st.stochastic else "") + (KEYROW if st.key_is_row else "")
            + (ISO if st.multi_iso else ""))


def zero_counters(wrapper, models=tuple(MODELS)) -> None:
    """Set ``wrapper``'s launch and kept counters of ``models`` to 0, every
    form of each and no form of another model (a pair wrapper's key-row
    counters stay 0: only the bucket kernels have that form)."""
    for f, name in LAUNCH_COUNTER.items():
        if FORM_MODEL[f] in models:
            setattr(wrapper, name, 0)
            setattr(wrapper, KEPT_COUNTER[f], 0)


TRAINED = tuple(m for m, spec in MODELS.items() if spec.trained)  # the models with a backward
BUCKET_MODELS = ("gs2d", "gut3d", "gs2dp", "gut3dp")  # the models K3 and K4 have forms of


def check_bucket_model(st) -> None:
    """Raise for a model the bucket kernels have no form of: gs2d_clip and
    the triangles, and the multi-iso form (their JAX bucket forms have no
    caller: the deep shadow map bins pairs)."""
    model_of(st)
    if st.model not in BUCKET_MODELS:
        raise NotImplementedError(f"the bucket kernels have no {st.model} form "
                                  "(ROADMAP.md queue 2)")
    if st.multi_iso:
        raise NotImplementedError("the bucket kernels have no multi-iso form: the deep "
                                  "shadow map bins pairs (ROADMAP.md queue 2)")


def check_multi_iso(st) -> None:
    """Raise for a multi-iso ``st`` K1 has no form of: one not gs2d or
    stochastic (the JAX deep shadow map blends deterministic gs2d rows,
    shadows.py:145-148), or thresholds that are not ISO_PICKS of them."""
    if not st.multi_iso:
        return
    if st.model != "gs2d" or st.stochastic or st.key_is_row:
        raise NotImplementedError(
            f"the multi-iso form is the deterministic gs2d blend's (the deep shadow map's), "
            f"not {form_of(dataclasses.replace(st, multi_iso=False))}'s")
    if len(st.iso_thresholds) != ISO_PICKS:
        raise ValueError(f"the multi-iso form takes {ISO_PICKS} thresholds, got "
                         f"{st.iso_thresholds!r}")


@dataclasses.dataclass(frozen=True)
class RasterStatics:
    """Static blend parameters (render/pipelines.raster_statics builds them)."""

    tiles_x: int
    tiles_y: int
    chunk: int = 128             # freeze granularity: blend steps end at p % chunk == 0
    alpha_min: float = 1.0 / 255.0
    alpha_clamp: float = 0.999
    qmax: float = 8.0
    min_transmittance: float = 1e-4
    depth_iso: float = 0.7       # depth-pick transmittance threshold
    model: str = "gs2d"          # response model (ops/response.py)
    kernel_degree: int = 2       # gut3d generalized-Gaussian degree
    kernel_min_response: float = 0.0113  # gut3d response cutoff
    stochastic: bool = False     # binary accept per (pixel, pair), keyed by the sample seed
    key_is_row: bool = False     # bucket kernels: merge on the key row (ops/response.GS_KEY)
    multi_iso: bool = False      # four depth picks (rows 4-7) in place of (depth, id)
    iso_thresholds: tuple = (0.75, 0.5, 0.25, 0.05)  # the multi-iso picks' T levels


def _tile_pixel_coords(tiles: torch.Tensor, tiles_x: int, dtype=torch.float32):
    """Pixel-center coordinates of the given tiles as (n, 256, 1) columns."""
    pix = torch.arange(PIX, device=tiles.device)
    tx = (tiles % tiles_x)[:, None]
    ty = (tiles // tiles_x)[:, None]
    px = (tx * TILE + pix % TILE).to(dtype) + 0.5
    py = (ty * TILE + pix // TILE).to(dtype) + 0.5
    return px[..., None], py[..., None]


def _tile_steps(tile_start, tile_count, tiles, c):
    """(start, end, first chunk, step count) of the given tiles' pair ranges."""
    start = tile_start[tiles].to(torch.int64)
    end = start + tile_count[tiles].to(torch.int64)
    first_block = start // c
    nsteps = torch.where(end > start, (end - 1) // c - first_block + 1, 0)
    return start, end, first_block, nsteps


class _Step(typing.NamedTuple):
    """One blend step of the twins' sweep, vectorized over tiles."""

    p: torch.Tensor          # (n, c) global pair index of each lane
    pc: torch.Tensor         # (n, c) the same, clamped to a valid column
    lane_live: torch.Tensor  # (n, c) the lane lies in its tile's [start, end)
    live: torch.Tensor       # (n, 256, c) lane live and pixel not frozen
    block: torch.Tensor      # (n, rows, c) the lanes' attribute rows
    alpha: torch.Tensor      # (n, 256, c), 0 where not live or cut off
    drawn: torch.Tensor      # (n, 256, c) bool, alpha passed the cutoffs before an accept
    q: torch.Tensor          # 1 - alpha
    excl: torch.Tensor       # exclusive product of q along the lanes
    tcol: torch.Tensor       # (n, 256, 1) T at the step's start


class _Pixels(typing.NamedTuple):
    """What the alpha of the given tiles reads of their pixels."""

    px: torch.Tensor         # (n, 256, 1) pixel centers
    py: torch.Tensor
    pix: torch.Tensor | None  # (n, 8, 256) pixel context (gut3d), else None


def _chunks(attrs, tile_start, tile_count, st: RasterStatics, tiles):
    """Each blend step's pairs of the given tiles, vectorized over tiles:
    (p, pc, in_range, rows): the (n, c) global pair index of each lane, the
    same clamped to a valid column, whether it lies in its tile's [start,
    end), and the lanes' (rows, n, c) attribute rows, in the f32 layout of
    ``f32_model(st)`` (a packed model's rows unpacked). For tile t, step k
    covers the global chunk ``first_block[t] + k``."""
    c = st.chunk
    start, end, first_block, nsteps = _tile_steps(tile_start, tile_count, tiles, c)
    lane = torch.arange(c, device=attrs.device)
    p_max = max(attrs.shape[1] - 1, 0)
    for k in range(int(nsteps.max()) if tiles.shape[0] else 0):
        p = (first_block + k)[:, None] * c + lane                       # (n, c)
        pc = p.clamp(max=p_max)
        rows = unpack_rows(st.model, attrs[:, pc])
        yield p, pc, (p >= start[:, None]) & (p < end[:, None]), rows


def _blend_steps(attrs, tile_start, tile_count, st: RasterStatics, tiles, pix_ctx=None,
                 seed: int = 0, key_offset: torch.Tensor | None = None):
    """The front-to-back sweep both twins walk, one ``_Step`` per blend
    step (``_chunks``), with the TPU kernel's chunk semantics.

    A pixel is frozen for a whole step when its T at the step's start is
    <= min_transmittance. T advances after each step is yielded. Returns
    the tiles' ``_Pixels`` too. A stochastic ``st`` accepts each alpha by
    ``hash_uniform(seed + p // chunk + key_offset, pixel, p % chunk)``;
    ``key_offset`` (n,), per listed tile, is 0 on the pair path."""
    n = tiles.shape[0]
    c = st.chunk
    px, py = _tile_pixel_coords(tiles, st.tiles_x)
    pixels = _Pixels(px, py, pix_ctx[tiles] if model_of(st).uses_pix else None)
    pixel = torch.arange(PIX, device=attrs.device)[None, :, None]
    offset = 0 if key_offset is None else key_offset[:, None, None]

    def steps():
        tcol = torch.ones((n, PIX, 1), dtype=attrs.dtype, device=attrs.device)
        for p, pc, lane_live, rows in _chunks(attrs, tile_start, tile_count, st, tiles):
            live = lane_live[:, None, :] & (tcol > st.min_transmittance)
            block = rows.permute(1, 0, 2)                               # (n, R, c)
            a = alpha(block, px, py, pixels.pix, live, st)              # (n, 256, c)
            drawn = a > 0
            if st.stochastic:
                key = seed + p[:, None, :1] // c + offset
                a = stochastic_accept(a, hash_uniform(key, pixel, p[:, None, :] % c))
            q = 1.0 - a
            incl = torch.cumprod(q, dim=-1)
            excl = torch.cat([torch.ones_like(q[..., :1]), incl[..., :-1]], dim=-1)
            yield _Step(p, pc, lane_live, live, block, a, drawn, q, excl, tcol)
            tcol = tcol * excl[..., -1:] * q[..., -1:]

    return pixels, steps()


def _all_tiles(tile_start, tiles):
    if tiles is None:
        return torch.arange(tile_start.shape[0], device=tile_start.device)
    return tiles


def rasterize_tiles_ref(attrs: torch.Tensor, ids: torch.Tensor,
                        tile_start: torch.Tensor, tile_count: torch.Tensor,
                        st: RasterStatics, tiles: torch.Tensor | None = None,
                        pix_ctx: torch.Tensor | None = None, seed: int = 0,
                        key_offset: torch.Tensor | None = None):
    """Plain PyTorch twin of the kernel, with the TPU kernel's chunk semantics.

    Each step of the sweep (``_blend_steps``) is an ``(n, 256, chunk)``
    alpha block of ``st.model`` with an exclusive product along the lanes.
    ``tiles`` selects a subset of tiles (all by default); the result rows
    follow it. ``pix_ctx``: the (T, 8, 256) pixel context of gut3d.
    ``seed``, ``key_offset``: the stochastic stream (``_blend_steps``).
    Each pair's colour and picked depth are the model's (``pixel_attrs``:
    its rows, or tri2d_smooth's per pixel). A multi-iso ``st`` picks once
    per threshold, each as the single pick at ``depth_iso`` (one pair may
    cross several), and returns (n, 8, 256) rows with ids -1.
    """
    check_multi_iso(st)
    c = st.chunk
    dev = attrs.device
    tiles = _all_tiles(tile_start, tiles)
    n = tiles.shape[0]
    lane = torch.arange(c, device=dev)
    acc = torch.zeros((n, PIX, 3), dtype=attrs.dtype, device=dev)
    tcol = torch.ones((n, PIX, 1), dtype=attrs.dtype, device=dev)
    levels = st.iso_thresholds if st.multi_iso else (st.depth_iso,)
    pick_d = [torch.zeros((n, PIX), dtype=attrs.dtype, device=dev) for _ in levels]
    pick_id = torch.full((n, PIX), -1, dtype=torch.int32, device=dev)
    picked = [torch.zeros((n, PIX), dtype=torch.bool, device=dev) for _ in levels]
    pixels, steps = _blend_steps(attrs, tile_start, tile_count, st, tiles, pix_ctx, seed,
                                 key_offset)
    for s in steps:
        w = s.alpha * s.excl * s.tcol
        colours, depth = pixel_attrs(s.block, pixels.px, pixels.py, st)
        acc = acc + torch.stack([(w * col).sum(-1) for col in colours], dim=-1)
        # depth (and id) at the first lane where T drops below each level
        t_after = s.tcol * s.excl * s.q
        for k, level in enumerate(levels):
            cond = (t_after < level) & (s.alpha > 0.0)
            first = torch.where(cond, lane, c).amin(dim=-1)             # (n, 256)
            upd = (first < c) & ~picked[k]
            fl = first.clamp(max=c - 1)
            if depth.shape[1] == 1:
                d_sel = torch.gather(depth[:, 0], 1, fl)
            else:
                d_sel = torch.gather(depth, 2, fl[..., None])[..., 0]
            pick_d[k] = torch.where(upd, d_sel, pick_d[k])
            if not st.multi_iso:
                pick_id = torch.where(upd, ids[torch.gather(s.pc, 1, fl)], pick_id)
            picked[k] = picked[k] | upd
        tcol = s.tcol * s.excl[..., -1:] * s.q[..., -1:]
    out = torch.cat([acc.transpose(1, 2), tcol.transpose(1, 2), torch.stack(pick_d, 1)], 1)
    return out, pick_id


@torch.no_grad()
def blend_work(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
               st: RasterStatics, tiles: torch.Tensor | None = None,
               pix_ctx: torch.Tensor | None = None,
               keep: torch.Tensor | None = None, seed: int = 0,
               key_offset: torch.Tensor | None = None) -> tuple[int, ...]:
    """(evaluations, hits) of a frame: the (pixel, pair) alpha evaluations
    both kernels make (every pair of each step a pixel enters live), and
    those whose alpha passes the cutoffs, where the kernels do the blend
    or gradient work. What a kernel's bound counts. ``tiles`` restricts
    the count to a subset of tiles (all by default).

    ``keep``, a bool per pair (a kernel's cull), adds four counts over the
    steps a tile enters (some pixel live at the step's start): (tested,
    kept, kept evaluations, draws), the pairs the cull tests, those it
    keeps, the kept pairs' evaluations, and those of them whose alpha
    passes the cutoffs before a stochastic accept (where the stochastic
    kernels hash a uniform; the hits of a deterministic sweep). A (P,
    WARPS) ``keep`` (K1's per-warp cull, ``pair_warp_may_hit``) counts the
    kept (warp, pair) bits instead, and as kept evaluations the live
    (pixel, pair)s whose warp keeps the pair (``WARP_OF_PIXEL``). A
    stochastic ``st`` sweeps the stream of ``seed`` and ``key_offset`` (its
    hits are the accepted pairs)."""
    evals = hits = tested = kept = kept_evals = draws = 0
    for s in _blend_steps(attrs, tile_start, tile_count, st, _all_tiles(tile_start, tiles),
                          pix_ctx, seed, key_offset)[1]:
        evals += int(s.live.sum())
        hits += int((s.alpha > 0).sum())
        if keep is not None:
            lanes = s.lane_live & s.live.flatten(1).any(dim=1)[:, None]  # (n, c)
            tested += int(lanes.sum())
            k = keep[s.pc]                                              # (n, c[, WARPS])
            if keep.dim() == 2:
                kept += int((lanes[..., None] & k).sum())
                k_px = s.live & k[..., WARP_OF_PIXEL.to(k.device)].transpose(1, 2)
            else:
                kept += int((lanes & k).sum())
                k_px = s.live & k[:, None, :]
            kept_evals += int(k_px.sum())
            draws += int((k_px & s.drawn).sum())
    return (evals, hits) if keep is None else (evals, hits, tested, kept, kept_evals, draws)


@torch.no_grad()
def pair_may_hit(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
                 st: RasterStatics, tiles: torch.Tensor | None = None,
                 pix_ctx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K2's per-tile cull (csrc/response.cuh ``may_hit``, term
    for term, with the same margins; ops/response.may_hit): (P,) bool,
    whether each pair may hit a pixel of the tile whose list holds it. True
    wherever the model's alpha can pass its cutoffs at some pixel of the
    tile (and for NaN, inf or degenerate rows); False for pairs outside the
    ranges of ``tiles`` (all by default)."""
    tiles = _all_tiles(tile_start, tiles)
    bound = tile_bound(st, tiles, pix_ctx)
    keep = torch.zeros(attrs.shape[1], dtype=torch.bool, device=attrs.device)
    for p, _, in_range, rows in _chunks(attrs.detach(), tile_start, tile_count, st, tiles):
        keep[p[in_range]] = may_hit(rows, bound, st)[in_range]
    return keep


@torch.no_grad()
def pair_warp_may_hit(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
                      st: RasterStatics, tiles: torch.Tensor | None = None,
                      pix_ctx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K1's per-warp cull (csrc/rasterize_fwd.cu: each pair's
    csrc/response.cuh ``reach`` against each warp's ``warp_bound``, term for
    term; ops/response.pair_reach, reach_may_hit): (P, WARPS) bool, whether
    each pair may hit a pixel of each warp of the tile whose list holds it
    (warp w's pixels ``WARP_PIXELS[w]``). True wherever the model's alpha
    can pass its cutoffs at some pixel of the warp (and for NaN, inf or
    degenerate rows); False for pairs outside the ranges of ``tiles`` (all
    by default)."""
    tiles = _all_tiles(tile_start, tiles)
    bound = warp_bound(st, tiles, pix_ctx)
    keep = torch.zeros((attrs.shape[1], WARPS), dtype=torch.bool, device=attrs.device)
    for p, _, in_range, rows in _chunks(attrs.detach(), tile_start, tile_count, st, tiles):
        reach = pair_reach(rows, st)
        m = torch.stack([reach_may_hit(reach, bound_of_warp(bound, w), st)
                         for w in range(WARPS)], dim=-1)                # (n, c, WARPS)
        keep[p[in_range]] = m[in_range]
    return keep


@torch.no_grad()
def pair_hits(attrs: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
              st: RasterStatics, tiles: torch.Tensor | None = None,
              pix_ctx: torch.Tensor | None = None, per_warp: bool = False) -> torch.Tensor:
    """(P,) bool: whether each pair's alpha (ops/response.alpha) passes the
    cutoffs at some pixel of its tile, every pixel counted, frozen or not:
    what ``pair_may_hit`` must never drop. False outside ``tiles``' ranges.
    ``per_warp``: (P, WARPS), at some pixel of each of K1's warps
    (``WARP_PIXELS``): what ``pair_warp_may_hit`` must never drop."""
    tiles = _all_tiles(tile_start, tiles)
    px, py = _tile_pixel_coords(tiles, st.tiles_x)
    pix = pix_ctx[tiles] if model_of(st).uses_pix else None
    shape = (attrs.shape[1], WARPS) if per_warp else (attrs.shape[1],)
    hits = torch.zeros(shape, dtype=torch.bool, device=attrs.device)
    for p, _, in_range, rows in _chunks(attrs.detach(), tile_start, tile_count, st, tiles):
        a = alpha(rows.permute(1, 0, 2), px, py, pix, in_range[:, None, :], st) > 0
        if per_warp:                                                    # (n, WARPS, 32, c)
            a = a[:, WARP_PIXELS.flatten().to(a.device)].unflatten(1, (WARPS, 32))
            hits[p[in_range]] = a.any(dim=2).transpose(1, 2)[in_range]
        else:
            hits[p[in_range]] = a.any(dim=1)[in_range]
    return hits


def bwd_context(out: torch.Tensor, g_out: torch.Tensor) -> torch.Tensor:
    """(T, 5, 256) per-pixel backward context from the saved forward output
    and its cotangent (rasterize_pallas._rt_bwd): g_rgb, S_total =
    sum_ch out_rgb * g_rgb, and g_T * T_final. Rows 0-3 of ``out`` are the
    blend before the background; the depth row's cotangent is dropped."""
    g_rgb = g_out[:, 0:3]
    s_total = (out[:, 0:3] * g_rgb).sum(dim=1, keepdim=True)
    gt_tn = g_out[:, 3:4] * out[:, 3:4]
    return torch.cat([g_rgb, s_total, gt_tn], dim=1).contiguous()


def rasterize_tiles_bwd_ref(attrs: torch.Tensor, tile_start: torch.Tensor,
                            tile_count: torch.Tensor, ctx: torch.Tensor,
                            st: RasterStatics, tiles: torch.Tensor | None = None,
                            pix_ctx: torch.Tensor | None = None, seed: int = 0,
                            key_offset: torch.Tensor | None = None):
    """Plain PyTorch twin of the backward kernel: (rows, P) d_attrs.

    Hand-derived, vectorized like the forward twin: the same forward-order
    sweep (``_blend_steps``) with the same per-step freeze. With T_k the
    transmittance before pair k and the suffix the colour still to come
    after it, S_total - s_incl:

        dalpha_k = T_k (g_rgb . c_k) - (suffix_k + g_T T_final) / max(1 - alpha_k, 1 - alpha_clamp)
        dcolor_k = sum_pix g_rgb w_k,   w_k = alpha_k T_k

    and the model's VJP (ops/response.alpha_vjp) takes dalpha to the
    geometry rows. Each pair lies in one tile's range, so its gradient is
    written once. The depth row and pairs no tile visits stay zero. ``tiles``
    restricts the sweep to a subset of tiles (all by default); pairs of the
    other tiles then stay zero too. A forward-only (packed) model raises
    NotImplementedError. A stochastic ``st`` sweeps the stream of ``seed``
    and ``key_offset``; its accepted alphas have no gradient, so only the
    colour rows get one (every division still by the clamped q).
    """
    refuse_backward(st)
    model = model_of(st)
    tiles = _all_tiles(tile_start, tiles)
    pctx = ctx[tiles]
    g_rgb = pctx[:, 0:3].transpose(1, 2)                              # (n, 256, 3)
    s_total = pctx[:, 3, :, None]
    gt_tn = pctx[:, 4, :, None]

    d_attrs = torch.zeros_like(attrs)
    s_run = torch.zeros_like(s_total)
    pixels, steps = _blend_steps(attrs, tile_start, tile_count, st, tiles, pix_ctx, seed,
                                 key_offset)
    for s in steps:
        t_k = s.excl * s.tcol
        w = s.alpha * t_k
        blk = s.block
        cg = (g_rgb[..., 0:1] * blk[:, ATTR_R:ATTR_R + 1, :]
              + g_rgb[..., 1:2] * blk[:, ATTR_R + 1:ATTR_R + 2, :]
              + g_rgb[..., 2:3] * blk[:, ATTR_B:ATTR_B + 1, :])
        wcg = w * cg
        suffix = s_total - (s_run + torch.cumsum(wcg, dim=-1))
        qsafe = torch.clamp(s.q, min=1.0 - st.alpha_clamp)
        dalpha = t_k * cg - (suffix + gt_tn) / qsafe
        d_blk = blk.new_zeros((blk.shape[0], model.grad_rows, blk.shape[2]))
        if not st.stochastic:
            d_blk[:, list(model.geo_rows)] = alpha_vjp(blk, pixels.px, pixels.py, pixels.pix,
                                                       s.live, st, dalpha)
        d_blk[:, ATTR_R:ATTR_B + 1] = torch.stack(
            [(g_rgb[..., ch:ch + 1] * w).sum(dim=1) for ch in range(3)], dim=1)
        d_attrs[:model.grad_rows, s.p[s.lane_live]] = d_blk.permute(1, 0, 2)[:, s.lane_live]
        s_run = s_run + wcg.sum(dim=-1, keepdim=True)
    return d_attrs


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, attrs on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_pix_ctx(pix_ctx, st, device) -> None:
    """The (T, 8, 256) f32 pixel context a gut3d blend needs; none for gs2d."""
    if model_of(st).uses_pix:
        if pix_ctx is None:
            raise ValueError(f"the {st.model} model needs a pixel context")
        _check("pix_ctx", pix_ctx, torch.float32, (st.tiles_x * st.tiles_y, PIX_ROWS, PIX),
               device)
    elif pix_ctx is not None:
        raise ValueError(f"the {st.model} model takes no pixel context")


def _check_pairs(attrs, tile_start, tile_count, st, ids=None, pix_ctx=None) -> int:
    """Validate the blend inputs; returns the pair count P."""
    num_tiles = st.tiles_x * st.tiles_y
    dev = attrs.device
    p = attrs.shape[1] if attrs.dim() == 2 else -1
    if st.key_is_row:
        raise ValueError("the pair blender sorts by its pair keys and takes no key row")
    _check("attrs", attrs, torch.float32, (model_of(st).rows, p), dev)
    if ids is not None:
        _check("ids", ids, torch.int32, (p,), dev)
    _check("tile_start", tile_start, torch.int32, (num_tiles,), dev)
    _check("tile_count", tile_count, torch.int32, (num_tiles,), dev)
    check_pix_ctx(pix_ctx, st, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no blender for device {dev}")
    if dev.type == "cuda" and not 1 <= st.chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {st.chunk} outside [1, {MAX_CHUNK}]")
    return p


def count_launch(wrapper, st) -> None:
    """One more launch of ``wrapper``'s kernel in the form of ``st``."""
    name = LAUNCH_COUNTER[form_of(st)]
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def model_args(st):
    """The C entry points' model arguments after the chunk: alpha_min,
    alpha_clamp, qmax, kernel_min_response, kernel_degree."""
    return (st.alpha_min, st.alpha_clamp, st.qmax, st.kernel_min_response, st.kernel_degree)


def _blend_fwd(attrs, ids, tile_start, tile_count, st, pix_ctx, seed):
    """K1 on CUDA tensors (its cull and blend kernels, one launch counted),
    the twin on CPU tensors."""
    p = _check_pairs(attrs, tile_start, tile_count, st, ids, pix_ctx)
    dev = attrs.device
    if dev.type == "cpu":
        return rasterize_tiles_ref(attrs, ids, tile_start, tile_count, st, pix_ctx=pix_ctx,
                                   seed=seed)
    num_tiles = st.tiles_x * st.tiles_y
    fn = _kernel("rasterize_fwd", st)
    rows = ISO_OUT_ROWS if st.multi_iso else OUT_ROWS
    out = torch.empty((num_tiles, rows, PIX), dtype=torch.float32, device=dev)
    out_id = torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
    masks = torch.empty((p,), dtype=torch.uint8, device=dev)  # the cull's byte per pair
    with torch.cuda.device(dev):
        kept = torch.zeros((1,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(attrs.data_ptr(), p, ids.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), _ptr(pix_ctx), num_tiles, st.tiles_x, st.chunk,
                 *model_args(st), st.min_transmittance, st.depth_iso,
                 out.data_ptr(), out_id.data_ptr(), kept.data_ptr(), masks.data_ptr(), seed,
                 stream, *(st.iso_thresholds if st.multi_iso else ()))
    if err != 0:
        raise RuntimeError(f"rasterize_fwd ({form_of(st)}) launch failed: cudaError {err}")
    count_launch(rasterize_tiles, st)
    setattr(rasterize_tiles, KEPT_COUNTER[form_of(st)], kept)
    return out, out_id


def rasterize_tiles_bwd(attrs: torch.Tensor, tile_start: torch.Tensor,
                        tile_count: torch.Tensor, ctx: torch.Tensor,
                        st: RasterStatics, pix_ctx: torch.Tensor | None = None,
                        seed: int = 0) -> torch.Tensor:
    """(rows, P) d_attrs from the (T, 5, 256) ``bwd_context``.

    CUDA tensors launch csrc/rasterize_bwd.cu's entry for the form of
    ``st`` and count one launch in ``rasterize_tiles_bwd.launches`` (gs2d),
    ``.launches_gut3d`` or their ``_stoch`` forms (``seed``: the forward's);
    CPU tensors run the plain twin. The kernel writes
    each visited pair's gradient once with a plain store, in a fixed
    reduction order, so its result repeats bit for bit. Where it culls the
    model's pair lists (``Model.cull_pairs``: gs2d) it sweeps only the
    pairs its per-tile cull keeps (``pair_may_hit``). It leaves in
    ``rasterize_tiles_bwd.kept`` (gs2d) or ``.kept_gut3d`` a one-element
    int32 tensor on the card: the pairs it kept (all, where it does not
    cull) over the blend steps it entered (``blend_work``'s ``kept``, or
    ``tested``), to be read with ``int()`` after a synchronise. A
    forward-only (packed) model raises NotImplementedError."""
    refuse_backward(st)
    p = _check_pairs(attrs, tile_start, tile_count, st, pix_ctx=pix_ctx)
    dev = attrs.device
    num_tiles = st.tiles_x * st.tiles_y
    _check("ctx", ctx, torch.float32, (num_tiles, CTX_ROWS, PIX), dev)
    if dev.type == "cpu":
        return rasterize_tiles_bwd_ref(attrs, tile_start, tile_count, ctx, st, pix_ctx=pix_ctx,
                                       seed=seed)
    fn = _kernel("rasterize_bwd", st)
    d_attrs = torch.zeros_like(attrs)  # the kernel writes visited, kept pairs only
    with torch.cuda.device(dev):
        kept = torch.zeros((1,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(attrs.data_ptr(), p, tile_start.data_ptr(), tile_count.data_ptr(),
                 ctx.data_ptr(), _ptr(pix_ctx), num_tiles, st.tiles_x, st.chunk,
                 *model_args(st), st.min_transmittance, d_attrs.data_ptr(), kept.data_ptr(),
                 seed, stream)
    if err != 0:
        raise RuntimeError(f"rasterize_bwd ({form_of(st)}) launch failed: cudaError {err}")
    count_launch(rasterize_tiles_bwd, st)
    setattr(rasterize_tiles_bwd, KEPT_COUNTER[form_of(st)], kept)
    return d_attrs


zero_counters(rasterize_tiles_bwd, TRAINED)


class _RasterizeTiles(torch.autograd.Function):
    """The blend with its backward kernel (rasterize_pallas.rasterize_tiles'
    custom VJP): K1 / K2 on CUDA tensors, the twins on CPU tensors. The
    pixel context gets no gradient (the JAX VJP returns zeros for it). The
    backward of a packed model raises NotImplementedError (its rows are bit
    patterns; ``rasterize_pallas._rt_bwd``)."""

    @staticmethod
    def forward(ctx, attrs, ids, tile_start, tile_count, pix_ctx, st, seed):
        out, out_id = _blend_fwd(attrs, ids, tile_start, tile_count, st, pix_ctx, seed)
        ctx.mark_non_differentiable(out_id)
        ctx.save_for_backward(attrs, tile_start, tile_count, pix_ctx, out)
        ctx.st, ctx.seed = st, seed
        return out, out_id

    @staticmethod
    def backward(ctx, g_out, g_id):
        with timing.span("backward.blend"):
            attrs, tile_start, tile_count, pix_ctx, out = ctx.saved_tensors
            # the multi-iso form's rgb and T are gs2d's: K2's gs2d form
            st = dataclasses.replace(ctx.st, multi_iso=False)
            d_attrs = rasterize_tiles_bwd(attrs, tile_start, tile_count,
                                          bwd_context(out, g_out), st, pix_ctx, ctx.seed)
            return d_attrs, None, None, None, None, None, None


def rasterize_tiles(attrs: torch.Tensor, ids: torch.Tensor,
                    tile_start: torch.Tensor, tile_count: torch.Tensor,
                    st: RasterStatics, pix_ctx: torch.Tensor | None = None, seed: int = 0):
    """Blend sorted pair attributes into per-tile outputs.

    attrs: (rows, P) f32 rows of ``st.model`` in (tile, depth) order; ids:
    (P,) i32; tile_start, tile_count: (T,) i32, T = tiles_x * tiles_y;
    pix_ctx: the (T, 8, 256) f32 pixel context of gut3d (None for gs2d);
    seed: the stochastic stream's seed (read only if ``st.stochastic``).
    Returns ((T, 5, 256) f32 rows r, g, b, T, depth; (T, 256) i32 ids), or
    for a multi-iso ``st`` ((T, 8, 256) rows r, g, b, T and the four iso
    depths; ids -1), counted in ``rasterize_tiles.launches_iso``.
    CUDA tensors launch csrc/rasterize_fwd.cu's entry for the form of
    ``st`` and count one launch in ``rasterize_tiles.launches`` (gs2d),
    ``.launches_gut3d``, ``.launches_gs2dp``, ``.launches_gut3dp`` or their
    ``_stoch`` forms; CPU tensors run the plain twin. The kernel's warps
    skip the pairs its per-warp cull drops (``pair_warp_may_hit``), and it
    leaves in ``rasterize_tiles.kept`` (gs2d), or the model's
    ``KEPT_COUNTER``, a one-element int32 tensor on the card: the kept
    (warp, pair) bits over
    the blend steps it entered (``blend_work``'s ``kept`` with that mask),
    to be read with ``int()`` after a synchronise. Gradients reach
    ``attrs`` through rgb and T (``rasterize_tiles_bwd``).
    """
    return _RasterizeTiles.apply(attrs, ids, tile_start, tile_count, pix_ctx, st, int(seed))


zero_counters(rasterize_tiles)

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_MODEL = [_F, _F, _F, _F, _I]  # alpha_min, alpha_clamp, qmax, kernel_min_response, degree
_ARGTYPES = {  # the C entry points' parameters, in order (csrc/*.cu)
    "rasterize_fwd": [_P, _L, _P, _P, _P, _P, _I, _I, _I, *_MODEL, _F, _F, _P, _P, _P, _P, _I,
                      _P],
    "rasterize_bwd": [_P, _L, _P, _P, _P, _P, _I, _I, _I, *_MODEL, _F, _P, _P, _I, _P],
}


def entry_name(name: str, st) -> str:
    """The C entry point of kernel ``name`` for the form of ``st``: ``name``
    for gs2d, ``name + "_" + st.model`` for the others (the same source,
    another instantiation of its model template), then ``_stoch`` for the
    stochastic form (its stochastic template flag), ``_keyrow`` for the
    key-row form (its key-row flag; K3 and K4 of gs2d alone) and ``_iso``
    for the multi-iso form (K1 of gs2d alone)."""
    if name.startswith("raster_bucket"):
        check_bucket_model(st)
    model_of(st)
    check_multi_iso(st)
    if st.multi_iso and name != "rasterize_fwd":
        raise NotImplementedError(f"{name} has no multi-iso form: its backward is gs2d's")
    base = name if st.model == "gs2d" else f"{name}_{st.model}"
    return (base + (STOCH if st.stochastic else "") + (KEYROW if st.key_is_row else "")
            + (ISO if st.multi_iso else ""))


def _kernel(name: str, st):
    # the multi-iso entry takes its four thresholds after the common parameters
    argtypes = _ARGTYPES[name] + [_F] * (ISO_PICKS if st.multi_iso else 0)
    return _build.entry(name, entry_name(name, st), argtypes)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def rasterize_bins(bins, st: RasterStatics, pix_ctx: torch.Tensor | None = None,
                   seed: int = 0):
    """Convenience wrapper over a TileBins (ops/binning.py)."""
    return rasterize_tiles(bins.attrs, bins.pair_id, bins.tile_start,
                           bins.tile_count, st, pix_ctx, seed)


def assemble_image(out: torch.Tensor, out_id: torch.Tensor, tiles_x: int,
                   tiles_y: int, width: int, height: int,
                   background=(0.0, 0.0, 0.0)):
    """Per-tile outputs -> (H, W, 3) image, (H, W) transmittance, (H, W)
    picked depth and (H, W) i32 splat id. The background is blended under
    the splats as rgb + T·bg. No tile needs masking: every tile is written."""
    blocks = out.reshape(tiles_y, tiles_x, OUT_ROWS, TILE, TILE)
    full = blocks.permute(0, 3, 1, 4, 2).reshape(tiles_y * TILE, tiles_x * TILE, OUT_ROWS)
    full = full[:height, :width]
    ids = out_id.reshape(tiles_y, tiles_x, TILE, TILE).permute(0, 2, 1, 3)
    ids = ids.reshape(tiles_y * TILE, tiles_x * TILE)[:height, :width]
    trans = full[..., 3]
    bg = torch.tensor(background, dtype=torch.float32, device=out.device)
    img = full[..., 0:3] + trans[..., None] * bg
    return (img.contiguous(), trans.contiguous(), full[..., 4].detach().contiguous(),
            ids.contiguous())
