"""Offline viewer: turntable orbit rendering to image files.

The reference is an interactive ImGui/Vulkan viewer (H17); with no display
the viewer renders orbit sequences on the card to PNGs — the inspection
workflow a user can run headless. Usage:

    python -m vk_gaussian_splatting_tpu_torch.viewer scene.ply -o /tmp/orbit \\
        --frames 12 --size 640 480 --pipeline 1
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def orbit_camera(center, radius, azimuth, elevation, width, height,
                 fov_y=0.9, device=None):
    """The camera on the orbit of ``radius`` about ``center`` at
    (azimuth, elevation), looking at the centre, on ``device`` (default:
    the card)."""
    from vk_gaussian_splatting_tpu_torch.scene.cameras import look_at

    eye = center + radius * np.asarray([
        np.cos(elevation) * np.sin(azimuth),
        -np.sin(elevation),
        -np.cos(elevation) * np.cos(azimuth),
    ])
    return look_at(eye, center, [0, 1, 0], width, height, fov_y_rad=fov_y,
                   device=device)


def save_png(path, img):
    """Write an (H, W, 3) image in [0, 1] (tensor or array) as an 8-bit
    PNG: by Pillow, or without it by the stdlib writer of
    ``viewer_web.encode_png``."""
    from vk_gaussian_splatting_tpu_torch.viewer_web import encode_png

    if not isinstance(img, np.ndarray):
        img = img.detach().cpu().numpy()
    with open(path, "wb") as f:
        f.write(encode_png(np.clip(img, 0, 1)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("-o", "--out", default="orbit")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", nargs=2, type=int, default=[640, 480])
    ap.add_argument("--pipeline", type=int, default=1)
    ap.add_argument("--shdegree", type=int, default=3)
    ap.add_argument("--elevation", type=float, default=0.3)
    ap.add_argument("--distance", type=float, default=0.0,
                    help="orbit radius (default: auto from scene extent)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from vk_gaussian_splatting_tpu_torch.config import Pipeline, RenderConfig
    from vk_gaussian_splatting_tpu_torch.devices import resolve_device
    from vk_gaussian_splatting_tpu_torch.io import load_scene
    from vk_gaussian_splatting_tpu_torch.render import render

    dev = resolve_device(args.device)
    splats = load_scene(args.scene, device=dev)
    prepared = splats.prepare()
    means = prepared.means.cpu().numpy()
    center = means.mean(axis=0)
    spread = float(np.abs(means - center).mean())
    radius = args.distance or 4.0 * max(spread, 1e-3)

    w, h = args.size
    cfg = RenderConfig(width=w, height=h, sh_degree=args.shdegree,
                       pipeline=Pipeline(args.pipeline))
    os.makedirs(args.out, exist_ok=True)
    max_pairs = max(4 * prepared.num_splats, 1 << 20)
    for i in range(args.frames):
        az = 2 * np.pi * i / args.frames
        cam = orbit_camera(center, radius, az, args.elevation, w, h, device=dev)
        out = render(prepared, cam, cfg, max_pairs)
        path = os.path.join(args.out, f"frame_{i:03d}.png")
        save_png(path, out.image)
        print(f"{path}  (pairs {int(out.num_pairs)}, "
              f"overflow {bool(out.overflow)})")


if __name__ == "__main__":
    sys.exit(main())
