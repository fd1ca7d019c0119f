"""Splat and mesh ray tracing for arbitrary ray batches (counterpart of
``vk_gaussian_splatting_tpu/ops/raytrace.py``).

The reference marches particle hits per ray through a BVH with a sorted
k-buffer and a multi-pass tMin advance (threedgrt_raytrace.rgen.slang:
615-818), and intersects meshes with a closest-hit trace that clips the
particle range (rgen:495-553). Both are dense batch programs here, as in
the JAX module:

- ``trace_splats``: the splats sorted once by distance to the ray batch's
  origin centroid, then a sweep over splat chunks that composes front to
  back (an exclusive cumprod within a chunk, the carried transmittance
  across chunks), each ray restricted to its [t_min, t_max] window; the
  "windowed" order marches ``rt.max_passes`` per-ray t-slabs, exact across
  slabs.
- ``trace_mesh``: Moller-Trumbore closest hit over Morton-ordered face
  chunks, each chunk skipped where no ray of a ray block can reach its box.

Plain torch, as the JAX module is plain XLA: no part of it is a Pallas
kernel. Each operation is the JAX module's, in its order; the splat
colours are summed as products (the JAX ``Precision.HIGHEST`` matmul), so
no TF32 setting can reach them. Differentiable through autograd of the
plain ops (the sort permutations get no gradient).

The JAX module maps its ray blocks one after another (``lax.map``); the
blocks are independent, so here one step of the sweep covers as many ray
blocks as ``BATCH_BYTES`` lets through, which changes nothing but the
launch count. The random draws of the stochastic estimators come from
``trace_uniforms`` (a ``torch.Generator`` per draw, not the JAX stream),
with the JAX shapes and reuse: the any-hit draws are (ray_block, chunk)
per pass and chunk, read by every ray block of the pass.
"""

from __future__ import annotations

import dataclasses

import torch

from vk_gaussian_splatting_tpu_torch import timing
from vk_gaussian_splatting_tpu_torch.config import RenderConfig
from vk_gaussian_splatting_tpu_torch.ops.response import deg0_min_response, kernel_response
from vk_gaussian_splatting_tpu_torch.ops.sh import eval_sh_radiance
from vk_gaussian_splatting_tpu_torch.scene.splat_set import PreparedSplats, dequantize_sh

KERNEL_MIN_RESPONSE = 0.0113  # particleProcessHit cull (threedgrt.h.slang:160)
ANYHIT_STREAM = 0xA247        # the JAX keys of the two estimators' draws
PASS_STREAM = 0x57AC
# the largest (rays, lanes) f32 intermediate of one sweep step: the ray
# blocks a step covers (trace_mesh: its (rays, faces, 3) products)
BATCH_BYTES = 1 << 28


def splat_view_colors(prepared: PreparedSplats, origin: torch.Tensor, cfg: RenderConfig):
    """(colour (N,3), opacity (N,)) as seen from ``origin``: the SH radiance
    of particleProcessHit (threedgrt.h.slang:196-214) with the per-ray
    direction taken as origin -> splat (exact at the splat centre, where
    the kernel peaks)."""
    rgb = prepared.color[:, :3]
    if cfg.sh_degree >= 1 and prepared.sh.shape[1] > 0:
        dirs = prepared.means - origin
        dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
        rgb = rgb + eval_sh_radiance(dequantize_sh(prepared.sh), dirs, cfg.sh_degree)
        rgb = torch.clamp(rgb, min=0.0)
    return rgb, prepared.color[:, 3] * cfg.opacity_gain


@dataclasses.dataclass
class TraceResult:
    radiance: torch.Tensor       # (R, 3) integrated splat radiance
    transmittance: torch.Tensor  # (R,) remaining transmittance
    depth: torch.Tensor          # (R,) iso-surface depth (t where T crosses
    #                              depth_iso; 0 = never crossed, rgen:728-741)


@dataclasses.dataclass
class MeshHit:
    t: torch.Tensor     # (R,) hit distance (inf = miss)
    face: torch.Tensor  # (R,) int32 face id in the caller's order (-1 = miss)
    hit: torch.Tensor   # (R,) bool


def _splat_rows(prepared: PreparedSplats, colors, opacities, sort_key) -> torch.Tensor:
    """(14, N) splat rows in ascending ``sort_key`` order (stable): position
    0-2, scale 3-5, quaternion 6-9, rgb 10-12, opacity 13."""
    scl = torch.exp(prepared.scales_log)
    quats = prepared.quats / torch.clamp(
        torch.linalg.norm(prepared.quats, dim=-1, keepdim=True), min=1e-12)
    rows = torch.stack([
        prepared.means[:, 0], prepared.means[:, 1], prepared.means[:, 2],
        scl[:, 0], scl[:, 1], scl[:, 2],
        quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3],
        colors[:, 0], colors[:, 1], colors[:, 2],
        opacities,
    ], dim=0)
    return rows[:, torch.argsort(sort_key.detach(), stable=True)]


def _splat_frames(rows: torch.Tensor, splat_scale: float) -> torch.Tensor:
    """(19, N) per-splat frame rows from ``_splat_rows``'s: position 0-2,
    the scales times ``splat_scale`` floored at 1e-12 (3-5), the rotation
    R row-major (6-14), rgb 15-17, opacity 18. The JAX module forms these
    per chunk in every sweep step; they depend on the splat alone, so they
    are formed once here, by the same operations, to the same bits."""
    scl = [torch.clamp(rows[3 + i] * splat_scale, min=1e-12) for i in range(3)]
    qw, qx, qy, qz = (rows[6 + i] for i in range(4))
    r = [
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy),
        2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx),
        2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy),
    ]
    return torch.stack([rows[0], rows[1], rows[2], *scl, *r, rows[10], rows[11], rows[12],
                        rows[13]], dim=0)


FRAME_RGB = 15  # the first colour row of ``_splat_frames``


def _chunk_alpha_t(block, o, d, kernel_degree: int, alpha_min: float, alpha_clamp: float,
                   min_resp0: float = 0.0):
    """Per (ray, splat of the chunk) response: alpha (R, C) and the
    world-units parameter t of the maximum response (R, C). block: (19, C)
    rows of ``_splat_frames``; o, d: (R, 3) origins and unit directions. The
    canonical-frame math of threedgrt.h.slang:57-81."""
    pos = [block[i][None, :] for i in range(3)]
    scl = [block[3 + i][None, :] for i in range(3)]
    r = [[block[6 + 3 * i + j][None, :] for j in range(3)] for i in range(3)]
    op = block[18][None, :]

    o_r = [o[:, i:i + 1] for i in range(3)]
    d_r = [d[:, i:i + 1] for i in range(3)]

    oc, dc = [], []
    for j in range(3):
        oc.append((r[0][j] * (o_r[0] - pos[0]) + r[1][j] * (o_r[1] - pos[1])
                   + r[2][j] * (o_r[2] - pos[2])) / scl[j])
        dc.append((r[0][j] * d_r[0] + r[1][j] * d_r[1] + r[2][j] * d_r[2]) / scl[j])
    dd = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]
    # world-units max-response parameter (rint:159-172)
    t_hit = -(oc[0] * dc[0] + oc[1] * dc[1] + oc[2] * dc[2]) / torch.clamp(dd, min=1e-20)
    dn = torch.rsqrt(dd + 1e-30)
    dcn = [x * dn for x in dc]
    cr0 = dcn[1] * oc[2] - dcn[2] * oc[1]
    cr1 = dcn[2] * oc[0] - dcn[0] * oc[2]
    cr2 = dcn[0] * oc[1] - dcn[1] * oc[0]
    dist_sq = cr0 * cr0 + cr1 * cr1 + cr2 * cr2

    resp = kernel_response(dist_sq, kernel_degree)
    a_raw = op * resp
    mask = (a_raw > alpha_min) & (resp > max(KERNEL_MIN_RESPONSE, min_resp0))
    return torch.where(mask, torch.clamp(a_raw, max=alpha_clamp), 0.0), t_hit


def _int32(x: int) -> int:
    """x wrapped to int32, as the JAX package's int32 arithmetic wraps."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def trace_uniforms(stream: int, seed: int, shape, device, pass_id: int = 0,
                   chunk_id: int = 0) -> torch.Tensor:
    """U[0, 1) draws of an estimator: ``stream`` ANYHIT_STREAM (the any-hit
    accepts of pass ``pass_id`` and chunk ``chunk_id``, the JAX counter
    seed * 131071 + pass * 677 + chunk) or PASS_STREAM (the pass accepts,
    counter seed), from a generator seeded by the stream and the counter.
    The JAX module folds the same counters into its keys; the numbers
    differ (ROADMAP.md queue 3)."""
    counter = seed if stream == PASS_STREAM else _int32(seed * 131071 + pass_id * 677 + chunk_id)
    gen = torch.Generator(device=device).manual_seed((stream << 32) | (counter & 0xFFFFFFFF))
    return torch.rand(shape, generator=gen, device=device)


def _colour_sum(w: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """(R, 3): w (R, C) against the chunk's rgb rows, each channel a sum of
    f32 products."""
    return torch.stack([(w * block[FRAME_RGB + c][None, :]).sum(dim=1) for c in range(3)],
                       dim=1)


def _ray_batches(r_total: int, rb: int, lanes: int):
    """Slices of whole ray blocks, each holding at most BATCH_BYTES of one
    f32 (rays, lanes) intermediate (at least one block)."""
    blocks = max(1, BATCH_BYTES // (rb * max(lanes, 1) * 4))
    step = blocks * rb
    return [slice(s, min(s + step, r_total)) for s in range(0, r_total, step)]


def trace_splats(prepared: PreparedSplats, origins: torch.Tensor, dirs: torch.Tensor,
                 t_min: torch.Tensor, t_max: torch.Tensor, cfg: RenderConfig, chunk: int = 512,
                 ray_block: int = 1024, stochastic: bool | str = False, seed: int = 0,
                 order: str | None = None) -> TraceResult:
    """Integrate splats along arbitrary rays front to back within per-ray
    [t_min, t_max) windows: origins, dirs (R, 3) (unit), t_min, t_max (R,).
    Runs under a ``trace`` profiler span.

    order (default cfg.rt.order): "radial", the shared-origin radial order
    (exact for clustered origins); "windowed", cfg.rt.max_passes per-ray
    t-slabs, the reference's tMin advance (rgen:676-762: exact across slabs,
    radial within one); "auto", windowed where the batch's mean origin
    spread exceeds 10 % of the median splat distance (one host read).

    stochastic: "pass" (or True), the pass-stochastic estimator (rgen:
    765-800: the integrated result accepted with p = 1 - T and divided by
    p; T becomes 0 or 1); "anyhit", the single-trace any-hit estimator
    (rgen:821-961: each hit accepted with probability alpha becomes opaque).
    seed: the draws' seed (``trace_uniforms``). chunk: splats per sweep
    step; ray_block: rays that share one (ray_block, chunk) draw of the
    any-hit estimator."""
    if order is None:
        order = cfg.rt.order
    if stochastic is True:
        stochastic = "pass"
    with timing.span("trace"):
        return _trace_splats(prepared, origins, dirs, t_min, t_max, cfg, chunk, ray_block,
                             stochastic, int(seed), order)


def _trace_splats(prepared, origins, dirs, t_min, t_max, cfg, chunk, ray_block, stochastic,
                  seed, order):
    dev = origins.device
    r_total = origins.shape[0]
    centroid = origins.mean(dim=0)
    colors, opac = splat_view_colors(prepared, centroid, cfg)
    sort_key = torch.linalg.norm(prepared.means - centroid, dim=-1)
    rows = _splat_rows(prepared, colors, opac, sort_key)
    chunks = torch.split(_splat_frames(rows, cfg.splat_scale), chunk, dim=1)

    rb = min(ray_block, max(r_total, 1))
    rc = cfg.rt
    iso = cfg.raster.depth_iso_threshold
    min_resp0 = deg0_min_response(rc)
    anyhit = stochastic == "anyhit"

    if order == "auto":
        spread = torch.mean(torch.linalg.norm(origins - centroid, dim=-1))
        srt = torch.sort(sort_key.detach()).values
        n = srt.shape[0]
        median = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5  # jnp.median: the midpoint
        order = "windowed" if bool(spread > 0.1 * (median + 1e-12)) else "radial"
    elif order not in ("radial", "windowed"):
        raise ValueError(f"unknown trace order {order!r}")

    def sweep(o, d, lo, hi, carry, pass_id, rows_of_ray):
        rad, trans, iso_d = carry
        for ci, blk in enumerate(chunks):
            alpha, t_hit = _chunk_alpha_t(blk, o, d, rc.kernel_degree, rc.alpha_min,
                                          rc.alpha_clamp, min_resp0)
            alpha = torch.where((t_hit > lo[:, None]) & (t_hit < hi[:, None]), alpha, 0.0)
            if anyhit:
                u = trace_uniforms(ANYHIT_STREAM, seed, (rb, chunk), dev, pass_id, ci)
                u = u[rows_of_ray, :blk.shape[1]]
                alpha = torch.where((u < alpha) & (alpha > 0.0), 1.0, 0.0)
            q = 1.0 - alpha
            cq = torch.cumprod(q, dim=1)
            t_excl = torch.cat([torch.ones_like(q[:, :1]), cq[:, :-1]], dim=1)
            w = alpha * t_excl * trans[:, None]
            rad = rad + _colour_sum(w, blk)
            t_run = trans * cq[:, -1]
            # iso-depth pick: the first t where the running T crosses below iso
            t_inner = trans[:, None] * t_excl * q
            open_ = iso_d == 0.0
            crossed = (t_inner < iso) & open_[:, None]
            first = torch.argmax(crossed.to(torch.uint8), dim=1)  # the first True
            picked = torch.gather(t_hit, 1, first[:, None])[:, 0]
            iso_d = torch.where(crossed.any(dim=1) & open_, picked, iso_d)
            trans = t_run
        return rad, trans, iso_d

    far_max = None
    if order == "windowed":
        far_max = 2.0 * torch.max(sort_key) + 1.0

    outs = []
    for sl in _ray_batches(r_total, rb, chunk):
        o, d, tmin, tmax = origins[sl], dirs[sl], t_min[sl], t_max[sl]
        nr = o.shape[0]
        rows_of_ray = torch.arange(nr, device=dev) % rb
        carry = (o.new_zeros((nr, 3)), o.new_ones((nr,)), o.new_zeros((nr,)))
        if order == "radial":
            carry = sweep(o, d, tmin, tmax, carry, 0, rows_of_ray)
        else:
            # per-ray t-slabs over the finite part of the window; the last
            # slab is open-ended so unbounded rays still integrate everything
            far = torch.where(torch.isfinite(tmax), tmax, far_max)
            dt = torch.clamp(far - tmin, min=1e-6) / (rc.max_passes - 1)
            for p in range(rc.max_passes):
                lo = tmin if p == 0 else tmin + dt * float(p)
                hi = tmax if p == rc.max_passes - 1 else tmin + dt * float(p + 1)
                carry = sweep(o, d, torch.minimum(lo, tmax), torch.minimum(hi, tmax), carry, p,
                              rows_of_ray)
        outs.append(carry)
    radiance = torch.cat([c[0] for c in outs])
    trans = torch.cat([c[1] for c in outs])
    depth = torch.cat([c[2] for c in outs])
    if stochastic == "pass":
        u = trace_uniforms(PASS_STREAM, seed, (r_total,), dev)
        opacity = 1.0 - trans
        accept = u < opacity
        radiance = torch.where(accept[:, None],
                               radiance / torch.clamp(opacity, min=1e-6)[:, None], 0.0)
        trans = torch.where(accept, 0.0, 1.0)
    elif stochastic not in (False, None, "anyhit"):
        raise ValueError(f"unknown trace estimator {stochastic!r}")
    return TraceResult(radiance=radiance, transmittance=trans, depth=depth)


def _morton3(q: torch.Tensor) -> torch.Tensor:
    """(F, 3) int32 in [0, 1024) -> (F,) interleaved 30-bit Morton codes."""
    def spread(x):
        x = x & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _cross(a, b):
    """a x b over (x, y, z) component tuples (the jnp.cross formula)."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def trace_mesh(positions: torch.Tensor, indices: torch.Tensor, origins: torch.Tensor,
               dirs: torch.Tensor, t_min: torch.Tensor, chunk: int = 256,
               ray_block: int = 2048) -> MeshHit:
    """Closest-hit Moller-Trumbore over spatially coherent face chunks (the
    mesh BLAS of rgen:495-553): positions (V, 3), indices (F, 3), origins
    and dirs (R, 3), t_min (R,). Runs under a ``trace`` profiler span.

    Faces are ordered by the Morton code of their centroid (stable), so a
    chunk of ``chunk`` faces is spatially tight. Per chunk each ray first
    tests the chunk's box (a slab test clamped by its best t so far); a
    block of ``ray_block`` rays none of which can reach the box skips the
    chunk (the JAX ``lax.cond``; one host read per chunk and batch of
    blocks). Face ids map back to the caller's order."""
    with timing.span("trace"):
        return _trace_mesh(positions, indices, origins, dirs, t_min, chunk, ray_block)


def _trace_mesh(positions, indices, origins, dirs, t_min, chunk, ray_block):
    idx = indices.long()
    v0, v1, v2 = positions[idx[:, 0]], positions[idx[:, 1]], positions[idx[:, 2]]
    f = v0.shape[0]
    dev = origins.device
    r_total = origins.shape[0]

    # Morton order on centroids quantized to the mesh bounds
    cen = (v0 + v1 + v2) / 3.0
    lo = torch.amin(cen, dim=0)
    span = torch.clamp(torch.amax(cen, dim=0) - lo, min=1e-9)
    qc = torch.clamp(((cen - lo) / span * 1023.0).to(torch.int32), 0, 1023)
    order = torch.argsort(_morton3(qc), stable=True)
    v0, v1, v2 = v0[order], v1[order], v2[order]
    e1, e2 = v1 - v0, v2 - v0

    n_chunks = -(-f // chunk)
    f_pad = n_chunks * chunk

    def pad(a, fill):
        return torch.cat([a, a.new_full((f_pad - f, 3), fill)])

    box_lo = pad(torch.minimum(torch.minimum(v0, v1), v2), float("inf")).reshape(
        n_chunks, chunk, 3).amin(dim=1)
    box_hi = pad(torch.maximum(torch.maximum(v0, v1), v2), float("-inf")).reshape(
        n_chunks, chunk, 3).amax(dim=1)
    # face rows as (x, y, z) component rows, chunk by chunk
    comp = [torch.split(a.T.contiguous(), chunk, dim=1) for a in (v0, e1, e2)]

    rb = min(ray_block, max(r_total, 1))
    bts, bfs = [], []
    for sl in _ray_batches(r_total, rb, 3 * chunk):
        o, d, tmin = origins[sl], dirs[sl], t_min[sl]
        nr = o.shape[0]
        block_of_ray = torch.arange(nr, device=dev) // rb
        n_blocks = -(-nr // rb)
        # slab-test direction inverses; exact-zero components get a tiny
        # signed epsilon, which keeps the test conservative
        dsafe = torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
        inv_d = 1.0 / dsafe
        oc = [o[:, i:i + 1] for i in range(3)]
        dc = [d[:, i:i + 1] for i in range(3)]
        best_t = o.new_full((nr,), float("inf"))
        best_f = torch.full((nr,), -1, dtype=torch.int32, device=dev)
        for k in range(n_chunks):
            t1 = (box_lo[k][None, :] - o) * inv_d
            t2 = (box_hi[k][None, :] - o) * inv_d
            tn = torch.amax(torch.minimum(t1, t2), dim=-1)
            tf = torch.amin(torch.maximum(t1, t2), dim=-1)
            can_hit = (tf >= torch.maximum(tn, tmin)) & (tn < best_t)
            block_hit = torch.cat([can_hit, can_hit.new_zeros(n_blocks * rb - nr)]).view(
                n_blocks, rb).any(dim=1)
            if not bool(block_hit.any()):
                continue
            cv0 = [comp[0][k][i][None, :] for i in range(3)]
            ce1 = [comp[1][k][i][None, :] for i in range(3)]
            ce2 = [comp[2][k][i][None, :] for i in range(3)]
            pvec = _cross(dc, ce2)                                      # (R, C) each
            det = _dot(pvec, ce1)
            inv = 1.0 / torch.where(det.abs() < 1e-12, 1.0, det)
            tvec = [oc[i] - cv0[i] for i in range(3)]
            u = _dot(tvec, pvec) * inv
            qvec = _cross(tvec, ce1)
            v = _dot(qvec, dc) * inv
            t = _dot(qvec, ce2) * inv
            ok = ((det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
                  & (t > tmin[:, None]))
            t = torch.where(ok, t, float("inf"))
            cmin = torch.amin(t, dim=1)
            carg = torch.argmin(t, dim=1).to(torch.int32) + k * chunk
            better = (cmin < best_t) & block_hit[block_of_ray]
            best_t = torch.where(better, cmin, best_t)
            best_f = torch.where(better, carg, best_f)
        bts.append(best_t)
        bfs.append(best_f)
    bt, bf = torch.cat(bts), torch.cat(bfs)
    hit = torch.isfinite(bt) & (bf >= 0) & (bf < f_pad)
    # back to the caller's face ids (before the Morton order)
    face = torch.where(hit, order[torch.clamp(bf, 0, f - 1).long()].to(torch.int32), -1)
    return MeshHit(t=torch.where(hit, bt, float("inf")), face=face, hit=hit)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def refract_or_reflect(d: torch.Tensor, n: torch.Tensor, ior: torch.Tensor) -> torch.Tensor:
    """Refraction with the inside flip and the total-internal-reflection
    fallback (wavefront.h.slang illum >= 2 dispatch). d (R,3) unit
    incident, n (R,3) outward normal, ior (R,). Returns unit directions."""
    cos_in = torch.sum(d * n, dim=-1, keepdim=True)
    inside = cos_in > 0.0
    nn = torch.where(inside, -n, n)
    eta = torch.where(inside[..., 0], ior, 1.0 / ior)[..., None]
    ci = -torch.sum(d * nn, dim=-1, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - ci * ci)
    refr = eta * d + (eta * ci - torch.sqrt(torch.clamp(k, min=0.0))) * nn
    refr = refr / torch.clamp(torch.linalg.norm(refr, dim=-1, keepdim=True), min=1e-12)
    return torch.where(k > 0.0, refr, reflect(d, nn))
