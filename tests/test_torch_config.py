"""The PyTorch port's config equals the JAX package's, field for field."""

import dataclasses
import enum

import pytest
import torch

import vk_gaussian_splatting_tpu.config as jc
import vk_gaussian_splatting_tpu_torch.config as tc

torch.set_num_threads(2)

DATACLASSES = ["RasterConfig", "RtConfig", "RenderConfig"]
ENUMS = ["Pipeline", "ShFormat", "CameraType", "ShutterType", "SortMethod",
         "StochasticMode"]


def _plain(v):
    """Compare enums by (name, value) and nested configs field by field."""
    if isinstance(v, enum.Enum):
        return (v.name, int(v))
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    return v


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_and_defaults_match(name):
    j, t = getattr(jc, name), getattr(tc, name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _plain(t()) == _plain(j())
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_match(name):
    j, t = getattr(jc, name), getattr(tc, name)
    assert [(m.name, int(m)) for m in t] == [(m.name, int(m)) for m in j]


@pytest.mark.parametrize("w,h", [(800, 600), (1920, 1080), (121, 90), (16, 16)])
def test_tile_counts_match(w, h):
    assert tc.tiles_x(tc.RenderConfig(width=w, height=h)) == \
        jc.tiles_x(jc.RenderConfig(width=w, height=h))
    assert tc.tiles_y(tc.RenderConfig(width=w, height=h)) == \
        jc.tiles_y(jc.RenderConfig(width=w, height=h))


def test_replace_and_hash():
    cfg = tc.RenderConfig().replace(width=320)
    assert cfg.width == 320 and hash(cfg) == hash(tc.RenderConfig(width=320))
