"""Project save/load (counterpart of ``vk_gaussian_splatting_tpu/io/project.py``;
the reference's vkgs_project_{reader,writer}.{h,cpp}).

Versioned JSON with the reference's sections — renderer settings, splat sets
and instances (relative source paths + transforms + per-instance material
overrides), cameras, lights, mesh references — so a whole working session
round-trips. Assets are stored by path and reloaded through ``io.load_scene``
on open; unknown fields are ignored (reader.cpp:59-154 back-compat
pattern). The JSON keys and their defaults are the JAX package's, letter for
letter, so a project written by either package opens in the other. Its
quirks stay: ``kernelMinResponse`` is written and never read,
``load_assets=False`` appends ``None`` assets, and ``activeCamera`` defaults
to -1 when there is no camera.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.config import (
    CameraType,
    Pipeline,
    RenderConfig,
    ShFormat,
    ShutterType,
    StochasticMode,
)
from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.io import load_scene
from vk_gaussian_splatting_tpu_torch.scene.cameras import CameraSet, make_camera
from vk_gaussian_splatting_tpu_torch.scene.instances import SplatScene
from vk_gaussian_splatting_tpu_torch.scene.lights import make_light

PROJECT_VERSION = 1


@dataclasses.dataclass
class Project:
    """A loaded/loadable session: scene + cameras + lights + render config."""

    scene: SplatScene
    cameras: CameraSet
    lights: list
    config: RenderConfig
    asset_paths: list[str]
    mesh_paths: list[str] = dataclasses.field(default_factory=list)


def _config_to_json(cfg: RenderConfig) -> dict:
    return {
        "pipeline": int(cfg.pipeline),
        "maxShDegree": cfg.sh_degree,
        "shFormat": int(cfg.sh_format),
        "cameraType": int(cfg.camera_type),
        "splatScale": cfg.splat_scale,
        "stochastic": int(cfg.stochastic),
        "temporalSamplesCount": cfg.temporal_samples,
        "opacityGain": cfg.opacity_gain,
        "showShOnly": cfg.show_sh_only,
        "width": cfg.width,
        "height": cfg.height,
        "background": list(cfg.background),
        "kernelDegree": cfg.rt.kernel_degree,
        "kernelMinResponse": 0.0113,  # written for the reference's reader, never read back
        "sizeCulling": cfg.raster.size_culling,
        "sizeCullingMinPixels": cfg.raster.size_culling_min_px,
        "pointCloudModeEnabled": cfg.raster.point_cloud_mode,
        "msAntialiasing": cfg.raster.ms_antialiasing,
        "depthIsoThreshold": cfg.raster.depth_iso_threshold,
        "shutterType": int(cfg.shutter),
        "pairFormat": cfg.raster.pair_format,
        "rtxMaxBounces": cfg.rt.max_bounces,
    }


def _config_from_json(item: dict) -> RenderConfig:
    cfg = RenderConfig()
    raster = dataclasses.replace(
        cfg.raster,
        size_culling=item.get("sizeCulling", False),
        size_culling_min_px=item.get("sizeCullingMinPixels", 1.0),
        point_cloud_mode=item.get("pointCloudModeEnabled", False),
        ms_antialiasing=item.get("msAntialiasing", False),
        depth_iso_threshold=item.get("depthIsoThreshold", 0.7),
        pair_format=item.get("pairFormat", "f32"),
    )
    rt = dataclasses.replace(cfg.rt, kernel_degree=item.get("kernelDegree", 2),
                             max_bounces=item.get("rtxMaxBounces", 3))
    return cfg.replace(
        shutter=ShutterType(item.get("shutterType", int(ShutterType.GLOBAL))),
        pipeline=Pipeline(item.get("pipeline", 1)),
        sh_degree=item.get("maxShDegree", 3),
        sh_format=ShFormat(item.get("shFormat", 0)),
        camera_type=CameraType(item.get("cameraType", 0)),
        splat_scale=item.get("splatScale", 1.0),
        stochastic=StochasticMode(item.get("stochastic", 0)),
        temporal_samples=item.get("temporalSamplesCount", 1),
        opacity_gain=item.get("opacityGain", 1.0),
        show_sh_only=item.get("showShOnly", False),
        width=item.get("width", 800),
        height=item.get("height", 600),
        background=tuple(item.get("background", (0.0, 0.0, 0.0))),
        raster=raster,
        rt=rt,
    )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_project(path: str, project: Project) -> None:
    """Write ``project`` as JSON; asset and mesh paths relative to the
    file's directory where they can be."""
    base = os.path.dirname(os.path.abspath(path))

    def rel(p):
        try:
            return os.path.relpath(os.path.abspath(p), base)
        except ValueError:
            return p

    data = {
        "version": PROJECT_VERSION,
        "renderer": _config_to_json(project.config),
        "splatSets": [
            {"path": rel(p), "name": project.scene.asset_names[i]}
            for i, p in enumerate(project.asset_paths)
        ],
        "splatInstances": [
            {
                "asset": inst.asset,
                "transform": np.asarray(inst.transform, np.float64).tolist(),
                "splatScale": inst.splat_scale,
                "opacityGain": inst.opacity_gain,
                "visible": inst.visible,
                "name": inst.name,
            }
            for inst in project.scene.instances
        ],
        "meshes": [{"path": rel(p)} for p in project.mesh_paths],
        "cameras": [
            {
                "name": project.cameras.names[i],
                "viewMatrix": _host(c.viewmat).astype(np.float64).tolist(),
                # the rolling-shutter end pose and the OpenCV distortion pack:
                # without them a shutter / fisheye session reloads with an
                # ideal global-shutter lens
                "viewMatrixEnd": _host(c.viewmat_end).astype(np.float64).tolist(),
                "distortion": _host(c.distortion).astype(np.float64).tolist(),
                "fx": float(c.fx), "fy": float(c.fy),
                "cx": float(c.cx), "cy": float(c.cy),
                "near": float(c.near), "far": float(c.far),
                "focusDist": float(c.focus_dist),
                "aperture": float(c.aperture),
            }
            for i, c in enumerate(project.cameras.cameras)
        ],
        "activeCamera": project.cameras.active,
        "lights": [
            {
                "type": int(li.type),
                "position": _host(li.position).tolist(),
                "direction": _host(li.direction).tolist(),
                "color": _host(li.color).tolist(),
                "intensity": float(li.intensity),
                "range": float(li.range),
                "attenuationMode": int(li.attenuation_mode),
                "innerConeAngle": float(li.inner_cone_deg),
                "outerConeAngle": float(li.outer_cone_deg),
                "radius": float(li.radius),
            }
            for li in project.lights
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def load_project(path: str, load_assets: bool = True,
                 device: torch.device | str | None = None) -> Project:
    """Read a project; its assets (through ``io.load_scene``), cameras and
    lights on ``device`` (default: the card). With ``load_assets=False``
    each asset is ``None`` and only its name and path are kept."""
    device = resolve_device(device)
    with open(path) as f:
        data = json.load(f)
    base = os.path.dirname(os.path.abspath(path))

    cfg = _config_from_json(data.get("renderer", {}))

    scene = SplatScene()
    asset_paths = []
    for entry in data.get("splatSets", []):
        p = entry["path"]
        if not os.path.isabs(p):
            p = os.path.join(base, p)
        asset_paths.append(p)
        if load_assets:
            scene.add_asset(load_scene(p, device=device), entry.get("name", ""))
        else:
            scene.asset_names.append(entry.get("name", ""))
            scene.assets.append(None)
    for entry in data.get("splatInstances", []):
        scene.add_instance(
            entry["asset"],
            transform=np.asarray(entry.get("transform", np.eye(4).tolist())),
            splat_scale=entry.get("splatScale", 1.0),
            opacity_gain=entry.get("opacityGain", 1.0),
            visible=entry.get("visible", True),
            name=entry.get("name", ""),
        )

    cameras = CameraSet()
    for entry in data.get("cameras", []):
        vm_end = entry.get("viewMatrixEnd")
        dist = entry.get("distortion")
        cameras.add(
            make_camera(
                np.asarray(entry["viewMatrix"], np.float32),
                entry["fx"], entry["fy"], entry["cx"], entry["cy"],
                entry.get("near", 0.01), entry.get("far", 1e4),
                entry.get("focusDist", 1.0), entry.get("aperture", 0.0),
                distortion=(None if dist is None else np.asarray(dist, np.float32)),
                viewmat_end=(None if vm_end is None else np.asarray(vm_end, np.float32)),
                device=device,
            ),
            entry.get("name", ""),
        )
    cameras.active = data.get("activeCamera", 0 if cameras.cameras else -1)

    lights = [
        make_light(
            light_type=entry.get("type", 0),
            position=entry.get("position", (0, 0, 0)),
            direction=entry.get("direction", (0, 0, -1)),
            color=entry.get("color", (1, 1, 1)),
            intensity=entry.get("intensity", 1.0),
            range=entry.get("range", 1e10),
            attenuation=entry.get("attenuationMode", 0),
            inner_cone_deg=entry.get("innerConeAngle", 20.0),
            outer_cone_deg=entry.get("outerConeAngle", 30.0),
            radius=entry.get("radius", 0.0),
            device=device,
        )
        for entry in data.get("lights", [])
    ]

    mesh_paths = []
    for entry in data.get("meshes", []):
        p = entry["path"]
        mesh_paths.append(p if os.path.isabs(p) else os.path.join(base, p))

    return Project(scene=scene, cameras=cameras, lights=lights, config=cfg,
                   asset_paths=asset_paths, mesh_paths=mesh_paths)
