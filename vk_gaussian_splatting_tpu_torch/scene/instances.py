"""Multi-instance splat-set scene model (counterpart of
``vk_gaussian_splatting_tpu/scene/instances.py``).

The reference manages per-set buffers, per-instance transforms, and a
**global index table** resolving global splat id -> (set, local id) so one
unified sort covers every instance (SplatSetManagerVk,
splat_set_manager_vk.cpp:2304-2360 rebuildGlobalIndexTables, :2426-2517
unified sorting buffers). Here, as in the JAX package, the instance
transforms are *baked into the flattened parameter tensors* at
scene-preparation time: a rigid + uniform-scale transform composes exactly
into per-splat (mean, quat, log-scale), so the whole scene becomes one
concatenated PreparedSplats that every pipeline and the unified sort already
handle. The global index table survives as (instance_id, local_id) tensors
for picking and per-instance materials.

Non-uniform-scale (and sheared or reflecting) transforms re-factorize each
splat's transformed covariance A Sigma A^T by a batched 3x3 eigh back into
(log-scale, quat), on the host in float64 numpy exactly as the JAX package
does (the factorization is not unique for equal eigenvalues, so both
packages take the same numpy route): on a card that copies the asset's
means, scales and quats to the host once per bake. The rigid path runs on
the assets' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.config import ShFormat
from vk_gaussian_splatting_tpu_torch.ops.sh import rotate_sh_rest
from vk_gaussian_splatting_tpu_torch.scene.splat_set import (
    PreparedSplats,
    SplatSet,
    prepare_splats,
    quat_to_rotmat,
)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (...,4) (w,x,y,z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """(3,3) rotation -> (w,x,y,z) unit quaternion (numpy, host-side)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def decompose_rigid_uniform(transform: np.ndarray, atol: float = 1e-4):
    """4x4 -> (scale, quat(w,x,y,z), translation). Raises ValueError on
    non-uniform scale, shear or a reflection (those take the general bake)."""
    m = np.asarray(transform, np.float64)
    a = m[:3, :3]
    t = m[:3, 3]
    norms = np.linalg.norm(a, axis=0)
    if np.ptp(norms) > atol * max(norms.max(), 1.0):
        raise ValueError(
            f"instance transform has non-uniform scale {norms}; only rigid + "
            "uniform-scale instance transforms are supported")
    s = float(norms.mean())
    r = a / s
    if not np.allclose(r @ r.T, np.eye(3), atol=1e-3):
        raise ValueError("instance transform has shear; unsupported")
    if np.linalg.det(r) < 0:
        raise ValueError("instance transform has a reflection; unsupported")
    return s, rotmat_to_quat(r), t


def _rotmat_to_quat_batched(r: np.ndarray) -> np.ndarray:
    """(N,3,3) rotations -> (N,4) (w,x,y,z) unit quaternions (Shepperd,
    branchless numpy)."""
    m00, m01, m02 = r[:, 0, 0], r[:, 0, 1], r[:, 0, 2]
    m10, m11, m12 = r[:, 1, 0], r[:, 1, 1], r[:, 1, 2]
    m20, m21, m22 = r[:, 2, 0], r[:, 2, 1], r[:, 2, 2]
    qw = np.sqrt(np.maximum(0.0, 1 + m00 + m11 + m22)) / 2
    qx = np.sqrt(np.maximum(0.0, 1 + m00 - m11 - m22)) / 2
    qy = np.sqrt(np.maximum(0.0, 1 - m00 + m11 - m22)) / 2
    qz = np.sqrt(np.maximum(0.0, 1 - m00 - m11 + m22)) / 2
    qx *= np.where(m21 - m12 < 0, -1.0, 1.0)
    qy *= np.where(m02 - m20 < 0, -1.0, 1.0)
    qz *= np.where(m10 - m01 < 0, -1.0, 1.0)
    q = np.stack([qw, qx, qy, qz], axis=-1)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def bake_general_transform(transform: np.ndarray, means: np.ndarray,
                           scales_log: np.ndarray, quats: np.ndarray):
    """Apply an arbitrary invertible affine instance transform per splat
    (numpy on the host). The transformed covariance A Sigma A^T (A = linear
    part) is eigendecomposed back into fresh (means, log-scales, quats),
    keeping the scale/quat factorization the gut3d exact-ray response
    requires. Returns numpy float32 arrays."""
    m4 = np.asarray(transform, np.float64)
    a = m4[:3, :3]
    if abs(np.linalg.det(a)) < 1e-12:
        raise ValueError("instance transform is singular")
    means2 = np.asarray(means, np.float64) @ a.T + m4[:3, 3]

    q = np.asarray(quats, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = np.empty((q.shape[0], 3, 3))
    r[:, 0, 0] = 1 - 2 * (y * y + z * z)
    r[:, 0, 1] = 2 * (x * y - w * z)
    r[:, 0, 2] = 2 * (x * z + w * y)
    r[:, 1, 0] = 2 * (x * y + w * z)
    r[:, 1, 1] = 1 - 2 * (x * x + z * z)
    r[:, 1, 2] = 2 * (y * z - w * x)
    r[:, 2, 0] = 2 * (x * z - w * y)
    r[:, 2, 1] = 2 * (y * z + w * x)
    r[:, 2, 2] = 1 - 2 * (x * x + y * y)

    s = np.exp(np.asarray(scales_log, np.float64))       # (N,3)
    m = (a[None] @ r) * s[:, None, :]                    # A R diag(s)
    cov = m @ np.swapaxes(m, 1, 2)
    eigval, eigvec = np.linalg.eigh(cov)                 # ascending
    scales2 = 0.5 * np.log(np.maximum(eigval, 1e-30))
    det = np.linalg.det(eigvec)
    eigvec[:, :, 2] *= np.where(det < 0, -1.0, 1.0)[:, None]
    quats2 = _rotmat_to_quat_batched(eigvec)
    return (means2.astype(np.float32), scales2.astype(np.float32),
            quats2.astype(np.float32))


@dataclasses.dataclass
class SplatInstance:
    """One placed instance of a splat-set asset (SplatSetInstanceVk,
    splat_set_manager_vk.h): transform + per-instance material overrides."""

    asset: int
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    splat_scale: float = 1.0
    opacity_gain: float = 1.0
    visible: bool = True
    name: str = ""


@dataclasses.dataclass
class GlobalIndexTable:
    """Global splat id -> (instance, local id) (manager :2304-2360), over
    the visible instances in order."""

    instance_id: torch.Tensor   # (N_total,) int32
    local_id: torch.Tensor      # (N_total,) int32
    instance_base: np.ndarray   # (n_visible+1,) int64 host offsets


def _rigid_or_none(transform):
    """``decompose_rigid_uniform``'s (scale, quat, translation), or None for
    a transform that takes the general bake."""
    try:
        return decompose_rigid_uniform(transform)
    except ValueError:
        return None


def _f32(x: float) -> float:
    """x rounded to float32 (an exact scalar for float32 tensor arithmetic)."""
    return float(np.float32(x))


def _rotate_rows(means: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """means (N,3) @ r.T as float32 multiply-adds (no matmul, no TF32)."""
    return torch.stack([means[:, 0] * r[j, 0] + means[:, 1] * r[j, 1] + means[:, 2] * r[j, 2]
                        for j in range(3)], dim=1)


class SplatScene:
    """Asset + instance CRUD (the manager's create/delete protocol,
    splat_set_manager_vk.h Request flags), host-side; ``flatten`` produces
    the device scene on the assets' device."""

    def __init__(self):
        self.assets: list[SplatSet] = []
        self.asset_names: list[str] = []
        self.instances: list[SplatInstance] = []

    def add_asset(self, splats: SplatSet, name: str = "") -> int:
        self.assets.append(splats)
        self.asset_names.append(name or f"asset {len(self.assets) - 1}")
        return len(self.assets) - 1

    def add_instance(self, asset: int, transform=None, **kw) -> int:
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        self.instances.append(
            SplatInstance(asset=asset, transform=np.asarray(transform), **kw))
        return len(self.instances) - 1

    def remove_instance(self, idx: int) -> None:
        del self.instances[idx]

    @property
    def total_splats(self) -> int:
        return sum(self.assets[i.asset].num_splats
                   for i in self.instances if i.visible)

    def flatten(self, sh_format: ShFormat = ShFormat.FLOAT32
                ) -> tuple[PreparedSplats, GlobalIndexTable]:
        """Bake the visible instances into one concatenated PreparedSplats
        and the index table.

        Rigid instances compose into per-splat parameters:
          mean' = s R mean + t,  quat' = q_T (x) quat,  log-scale' += log(s),
        with R formed from q_T in float32 (``quat_to_rotmat``) on the host,
        as the JAX package forms it; whether the SH bands rotate is decided
        on that float32 matrix (``np.allclose(R, I, atol=1e-7)``). Other
        transforms go through ``bake_general_transform``, and their SH
        rotates by the polar rotation factor of the linear part (with a
        reflection's sign fixed). The SH bands rotate exactly into world
        space (ops/sh.py rotate_sh_rest) and are zero-padded to the widest
        visible asset. ``opacity_gain`` scales the activated opacity,
        clipped to [1e-6, 1 - 1e-6]. Raises ValueError with no visible
        instance.
        """
        live = [inst for inst in self.instances if inst.visible]
        if not live:
            raise ValueError("scene has no visible instances")
        parts = []
        inst_ids = []
        local_ids = []
        bases = [0]
        max_m = max(self.assets[i.asset].sh_rest.shape[1] for i in live)
        for idx, inst in enumerate(live):
            asset = self.assets[inst.asset]
            dev = asset.means.device
            n = asset.num_splats
            log_gain = np.log(max(inst.splat_scale, 1e-12))
            rigid = _rigid_or_none(inst.transform)
            if rigid is not None:
                s, q_t, t = rigid
                q32 = torch.as_tensor(np.asarray(q_t, np.float32))
                r = quat_to_rotmat(q32[None])[0]          # float32, host
                r_world = r.numpy().astype(np.float64)
                means2 = (_rotate_rows(asset.means, r.to(dev)) * _f32(s)
                          + torch.as_tensor(np.asarray(t, np.float32), device=dev))
                quats_n = asset.quats / torch.linalg.norm(
                    asset.quats, dim=-1, keepdim=True).clamp_min(1e-12)
                quats2 = quat_multiply(q32.to(dev)[None], quats_n)
                scales2 = asset.scales + _f32(np.log(s)) + _f32(log_gain)
            else:
                host = {f: getattr(asset, f).detach().cpu().numpy()
                        for f in ("means", "scales", "quats")}
                m2, s2, q2 = bake_general_transform(
                    inst.transform, host["means"], host["scales"] + log_gain, host["quats"])
                means2, scales2, quats2 = (torch.as_tensor(v, device=dev) for v in (m2, s2, q2))
                a_lin = np.asarray(inst.transform, np.float64)[:3, :3]
                u, _, vt = np.linalg.svd(a_lin)
                r_world = u @ vt
                if np.linalg.det(r_world) < 0:
                    r_world = u @ np.diag([1.0, 1.0, -1.0]) @ vt
            sh = asset.sh_rest
            if sh.shape[1] > 0 and not np.allclose(r_world, np.eye(3), atol=1e-7):
                sh = rotate_sh_rest(sh, r_world)
            m = sh.shape[1]
            if m < max_m:
                sh = torch.cat([sh, sh.new_zeros((n, max_m - m, 3))], dim=1)
            opac = asset.opacities
            if inst.opacity_gain != 1.0:
                a = torch.sigmoid(opac) * _f32(inst.opacity_gain)
                a = torch.clamp(a, 1e-6, 1 - 1e-6)
                opac = torch.log(a / (1 - a))
            parts.append(SplatSet(means=means2, scales=scales2, quats=quats2, opacities=opac,
                                  sh_dc=asset.sh_dc, sh_rest=sh))
            inst_ids.append(torch.full((n,), idx, dtype=torch.int32, device=dev))
            local_ids.append(torch.arange(n, dtype=torch.int32, device=dev))
            bases.append(bases[-1] + n)

        merged = SplatSet(**{f: torch.cat([getattr(p, f) for p in parts])
                             for f in ("means", "scales", "quats", "opacities",
                                       "sh_dc", "sh_rest")})
        table = GlobalIndexTable(instance_id=torch.cat(inst_ids),
                                 local_id=torch.cat(local_ids),
                                 instance_base=np.asarray(bases, np.int64))
        return prepare_splats(merged, sh_format), table
