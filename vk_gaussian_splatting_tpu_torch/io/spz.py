"""Niantic .spz compressed splat format, versions 1-3: counterpart of
``vk_gaussian_splatting_tpu/io/spz.py``.

Vectorized numpy form of the spz library's decode path
(3rdparty/spz/src/cc/load-spz.cc): a gzip stream holding a 16-byte header
(magic NGSP, version, numPoints, shDegree, fractionalBits, flags), then
positions (24-bit fixed point with ``frac_bits`` fractional bits, or f16 in
v1), alphas (u8 sigmoid), colours (u8, scale 0.15), scales (u8, /16 - 10
in log space), rotations (v3: smallest-three, 10 bits a component; v1-2:
first-three u8) and SH (u8, +-1 range). The writer is v3
(load-spz.cc:258-330 packGaussians).

spz payloads are RUB; the splats convert to the requested coordinate
system (the reference keeps RUB and reorders the quaternion to (w, x, y,
z), ply_loader_async.cpp:307-347). Decoded on the host, they land on
``device``.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.scene.splat_set import CoordinateSystem, SplatSet

_MAGIC = 0x5053474E
_COLOR_SCALE = 0.15
_SH_DIM = {0: 0, 1: 3, 2: 8, 3: 15}


def _unpack_quat_smallest_three(raw: np.ndarray) -> np.ndarray:
    """(n, 4) u8 -> (n, 4) f32 (x, y, z, w) (load-spz.cc:347-380): the index
    of the largest component in the top 2 bits, then the other three from
    component 3 down, 9 bits of magnitude (scaled by sqrt(1/2)) and a sign
    bit each; the largest is sqrt(1 - the others' squares)."""
    comp = (raw[:, 0].astype(np.uint32)
            | (raw[:, 1].astype(np.uint32) << 8)
            | (raw[:, 2].astype(np.uint32) << 16)
            | (raw[:, 3].astype(np.uint32) << 24))
    i_largest = (comp >> 30).astype(np.int64)
    mask9 = np.uint32((1 << 9) - 1)
    out = np.zeros((raw.shape[0], 4), np.float32)
    c = comp.copy()
    for i in range(3, -1, -1):
        use = i != i_largest
        mag = (c & mask9).astype(np.float32)
        neg = ((c >> np.uint32(9)) & np.uint32(1)) == 1
        val = (np.sqrt(0.5) * mag / float((1 << 9) - 1)).astype(np.float32)
        out[:, i] = np.where(use, np.where(neg, -val, val), 0.0)
        c = np.where(use, c >> np.uint32(10), c)
    largest = np.sqrt(np.clip(1.0 - np.sum(out * out, axis=1), 0.0, None))
    out[np.arange(raw.shape[0]), i_largest] = largest
    return out


def _pack_quat_smallest_three(q_xyzw: np.ndarray) -> np.ndarray:
    """(n, 4) f32 (x, y, z, w) -> (n, 4) u8, the inverse of the above
    (load-spz.cc:216-242 packQuaternionSmallestThree): the quaternion
    normalised and signed so its largest component is positive."""
    n = q_xyzw.shape[0]
    q = q_xyzw / np.maximum(np.linalg.norm(q_xyzw, axis=1, keepdims=True), 1e-12)
    i_largest = np.argmax(np.abs(q), axis=1)
    flip = np.sign(q[np.arange(n), i_largest])
    q = q * np.where(flip == 0, 1.0, flip)[:, None]
    comp = i_largest.astype(np.uint32) << 30
    cmask = (1 << 9) - 1
    for i in range(4):  # component i sits above the used components after it
        use = i != i_largest
        v = q[:, i] / np.sqrt(0.5)
        neg = (v < 0).astype(np.uint32)
        mag = np.clip(np.round(np.abs(v) * cmask), 0, cmask).astype(np.uint32)
        bits = (neg << np.uint32(9)) | mag
        shift = np.zeros(n, np.uint32)
        for j in range(3, i, -1):
            shift += np.where(j != i_largest, 10, 0).astype(np.uint32)
        comp = comp | np.where(use, bits << shift, 0).astype(np.uint32)
    return np.stack([((comp >> np.uint32(8 * b)) & np.uint32(0xFF)).astype(np.uint8)
                     for b in range(4)], axis=1)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float32, copy=False)


def load_spz(path: str, to_cs: CoordinateSystem = CoordinateSystem.RUB,
             device: torch.device | str | None = None) -> SplatSet:
    """Read an .spz file into a SplatSet on ``device`` (default: the card)."""
    device = resolve_device(device)
    with gzip.open(path, "rb") as f:
        buf = f.read()
    magic, version, n, sh_degree, frac_bits, _flags, _ = struct.unpack_from("<IIIBBBB", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an spz file (bad magic)")
    if not 1 <= version <= 3:
        raise ValueError(f"unsupported spz version {version}")
    if sh_degree > 3:
        raise ValueError(f"unsupported sh degree {sh_degree}")
    sh_dim = _SH_DIM[sh_degree]
    smallest_three = version >= 3

    off = 16
    if version == 1:  # f16 positions
        pos = np.frombuffer(buf, "<f2", n * 3, off).astype(np.float32).reshape(n, 3)
        off += n * 6
    else:
        raw = np.frombuffer(buf, np.uint8, n * 9, off).reshape(n, 3, 3).astype(np.int32)
        fixed = raw[..., 0] | (raw[..., 1] << 8) | (raw[..., 2] << 16)
        fixed = np.where(fixed & 0x800000, fixed | ~0xFFFFFF, fixed)  # sign-extend 24 bits
        pos = fixed.astype(np.float32) / (1 << frac_bits)
        off += n * 9
    alphas = np.frombuffer(buf, np.uint8, n, off).astype(np.float32) / 255.0
    off += n
    colors = np.frombuffer(buf, np.uint8, n * 3, off).reshape(n, 3).astype(np.float32)
    off += n * 3
    scales = np.frombuffer(buf, np.uint8, n * 3, off).reshape(n, 3).astype(np.float32)
    off += n * 3
    rot_n = 4 if smallest_three else 3
    rots = np.frombuffer(buf, np.uint8, n * rot_n, off).reshape(n, rot_n)
    off += n * rot_n
    sh = np.frombuffer(buf, np.uint8, n * sh_dim * 3, off).reshape(n, sh_dim, 3)

    if smallest_three:
        q_xyzw = _unpack_quat_smallest_three(rots)
    else:
        xyz = rots.astype(np.float32) / 127.5 - 1.0
        w = np.sqrt(np.clip(1.0 - np.sum(xyz * xyz, axis=1), 0.0, None))
        q_xyzw = np.concatenate([xyz, w[:, None]], axis=1)

    alphas_c = np.clip(alphas, 1e-6, 1 - 1e-6)
    arrays = dict(
        means=pos,
        scales=scales / 16.0 - 10.0,
        quats=np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, 0:3]], axis=1),
        opacities=np.log(alphas_c / (1 - alphas_c)),
        sh_dc=(colors / 255.0 - 0.5) / _COLOR_SCALE,
        sh_rest=(sh.astype(np.float32) - 128.0) / 128.0,
    )
    splats = SplatSet(**{k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
                         for k, v in arrays.items()})
    if to_cs != CoordinateSystem.RUB:
        splats = splats.convert_coordinates(CoordinateSystem.RUB, to_cs)
    return splats


def save_spz(path: str, splats: SplatSet, frac_bits: int = 12,
             from_cs: CoordinateSystem = CoordinateSystem.RUB) -> None:
    """Write ``splats`` as a v3 .spz file with ``frac_bits`` fractional bits
    of position (positions must lie within +-2^(23 - frac_bits))."""
    if from_cs != CoordinateSystem.RUB:
        splats = splats.convert_coordinates(from_cs, CoordinateSystem.RUB)
    means = _host(splats.means)
    n = means.shape[0]
    sh_rest = _host(splats.sh_rest)
    sh_degree = {0: 0, 3: 1, 8: 2, 15: 3}[sh_rest.shape[1]]

    fixed = np.round(means * (1 << frac_bits)).astype(np.int32)
    pos = np.stack([((fixed >> (8 * b)) & 0xFF).astype(np.uint8) for b in range(3)], axis=-1)
    a = 1.0 / (1.0 + np.exp(-_host(splats.opacities)))
    alphas = np.clip(np.round(a * 255), 0, 255).astype(np.uint8)
    colors = np.clip(np.round(_host(splats.sh_dc) * (_COLOR_SCALE * 255) + 0.5 * 255),
                     0, 255).astype(np.uint8)
    scales = np.clip(np.round((_host(splats.scales) + 10.0) * 16.0), 0, 255).astype(np.uint8)
    q = _host(splats.quats)
    rots = _pack_quat_smallest_three(np.concatenate([q[:, 1:4], q[:, 0:1]], axis=1))
    sh = np.clip(np.round(sh_rest * 128.0 + 128.0), 0, 255).astype(np.uint8)

    header = struct.pack("<IIIBBBB", _MAGIC, 3, n, sh_degree, frac_bits, 0, 0)
    with gzip.open(path, "wb") as f:
        for part in (header, pos.tobytes(), alphas.tobytes(), colors.tobytes(),
                     scales.tobytes(), rots.tobytes(), sh.tobytes()):
            f.write(part)
