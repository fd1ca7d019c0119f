"""Light sources (counterpart of ``vk_gaussian_splatting_tpu/scene/lights.py``).

Point, spot and directional lights with the reference's attenuation modes
(light_manager_vk.{h,cpp}; shaderio LightSource) and the energy-conserving
Phong model of wavefront.h.slang:122-232, 388-403, as tensor code over any
batch of shade points: the mesh rasterizer lights each vertex and each
face centre with them (render/mesh_raster.py). Each operation is the JAX
module's, in its order.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from vk_gaussian_splatting_tpu_torch.devices import resolve_device


class LightType(enum.IntEnum):
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2


class AttenuationMode(enum.IntEnum):
    NONE = 0
    LINEAR = 1
    QUADRATIC = 2
    PHYSICAL = 3


@dataclasses.dataclass
class LightSource:
    """One light as 0-d and (3,) tensors on one device."""

    type: torch.Tensor              # () int32 LightType
    position: torch.Tensor          # (3,)
    direction: torch.Tensor         # (3,)
    color: torch.Tensor             # (3,)
    intensity: torch.Tensor         # ()
    range: torch.Tensor             # ()
    attenuation_mode: torch.Tensor  # () int32 AttenuationMode
    inner_cone_deg: torch.Tensor    # ()
    outer_cone_deg: torch.Tensor    # ()
    radius: torch.Tensor            # () soft-shadow disk radius


def make_light(light_type: LightType = LightType.POINT, position=(0, 0, 0),
               direction=(0, 0, -1), color=(1, 1, 1), intensity=1.0, range=1e10,
               attenuation=AttenuationMode.NONE, inner_cone_deg=20.0, outer_cone_deg=30.0,
               radius=0.0, device: torch.device | str | None = None) -> LightSource:
    """A light on ``device`` (default: the card); tensor arguments keep their
    values (and graph) as float32."""
    device = resolve_device(device)

    def f(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    def i(v):
        return torch.tensor(int(v), dtype=torch.int32, device=device)

    return LightSource(type=i(light_type), position=f(position), direction=f(direction),
                       color=f(color), intensity=f(intensity), range=f(range),
                       attenuation_mode=i(attenuation), inner_cone_deg=f(inner_cone_deg),
                       outer_cone_deg=f(outer_cone_deg), radius=f(radius))


def headlight(camera_position: torch.Tensor) -> LightSource:
    """Camera-attached fallback light (wavefront.h.slang:106-119), on the
    camera position's device."""
    return make_light(LightType.POINT, position=camera_position, device=camera_position.device)


def _attenuation(mode, distance, rng):
    """The JAX ``jnp.select`` over the modes, as nested wheres in its order
    of precedence (LINEAR, QUADRATIC, PHYSICAL, else 1)."""
    return torch.where(mode == 1, torch.clamp(1.0 - distance / rng, min=0.0),
                       torch.where(mode == 2, 1.0 / (1.0 + distance * distance),
                                   torch.where(mode == 3, 1.0 / (distance * distance + 0.01),
                                               1.0)))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v), min=1e-12)


def compute_light(light: LightSource, world_pos: torch.Tensor,
                  world_nrm: torch.Tensor) -> torch.Tensor:
    """Diffuse irradiance term (computeLight, wavefront.h.slang:122-232):
    (..., 3) points and normals -> (..., 3)."""
    to_light = light.position - world_pos
    dist = torch.linalg.norm(to_light, dim=-1)
    l_pt = to_light / torch.clamp(dist, min=1e-12)[..., None]
    l_dir = -light.direction / torch.clamp(torch.linalg.norm(light.direction), min=1e-12)
    is_dir = light.type == LightType.DIRECTIONAL
    l_vec = torch.where(is_dir, l_dir, l_pt)

    ndotl = torch.clamp(torch.sum(world_nrm * l_vec, dim=-1), min=0.0)
    att = _attenuation(light.attenuation_mode, dist, light.range)
    att = torch.where(is_dir, 1.0, att * (dist <= light.range))

    # spot cone falloff (computeSpotLight :208-226)
    cos_theta = torch.sum(l_pt * (-_unit(light.direction)), dim=-1)
    inner = torch.cos(light.inner_cone_deg * (math.pi / 180))
    outer = torch.cos(light.outer_cone_deg * (math.pi / 180))
    spot = torch.clamp((cos_theta - outer) / torch.clamp(inner - outer, min=1e-6), 0.0, 1.0)
    spot = spot * spot * (3.0 - 2.0 * spot)  # smoothstep
    att = torch.where(light.type == LightType.SPOT, att * spot, att)

    return (light.color * light.intensity) * (ndotl * att)[..., None]


def light_direction_to(light: LightSource, world_pos: torch.Tensor):
    """(direction to the light (..., 3), distance (...)) for shadow rays
    (computeLightToSurfaceVector, wavefront.h.slang:33-70); a directional
    light is 1e10 away."""
    to_light = light.position - world_pos
    dist = torch.linalg.norm(to_light, dim=-1)
    l_pt = to_light / torch.clamp(dist, min=1e-12)[..., None]
    l_dir = -light.direction / torch.clamp(torch.linalg.norm(light.direction), min=1e-12)
    is_dir = light.type == LightType.DIRECTIONAL
    return torch.where(is_dir, l_dir, l_pt), torch.where(is_dir, 1e10, dist)


def compute_specular(specular, shininess, view_dir, light_dir, normal):
    """Energy-conserving Phong (wavefrontComputeSpecular,
    wavefront.h.slang:388-403)."""
    k_shin = torch.clamp(torch.as_tensor(shininess, dtype=torch.float32), min=4.0)
    energy = (2.0 + k_shin) / (2.0 * math.pi)
    v = -view_dir / torch.clamp(torch.linalg.norm(view_dir, dim=-1, keepdim=True), min=1e-12)
    r = -light_dir + 2.0 * torch.sum(light_dir * normal, dim=-1, keepdim=True) * normal
    spec = energy * torch.clamp(torch.sum(v * r, dim=-1), min=0.0) ** k_shin
    return specular * spec[..., None]
