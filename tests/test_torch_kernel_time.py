"""vk_gaussian_splatting_tpu_torch/kernel_time.py on the CPU: the bytes it
counts for each bandwidth kernel, with the kernels' wrappers replaced by
their plain versions (which return tensors of the same shapes), against the bytes a
splat moves by the kernels' own notes (csrc/sh_radiance.cu,
csrc/ewa_project.cu); and its refusal off the card. Its times come only
from a card."""

import pytest
import torch

from vk_gaussian_splatting_tpu_torch import kernel_time as kt
from vk_gaussian_splatting_tpu_torch.ops import projection as tproj
from vk_gaussian_splatting_tpu_torch.ops import sh as tsh

N = 200
# bytes a splat moves, each read or written once: SH 3 in f32 (sh, mean,
# colour; rgb) and the EWA projection (mean, cov, colour; xy .. valid)
PER_SPLAT = {"sh_radiance_fwd": 15 * 3 * 4 + 12 + 16 + 12,
             "sh_radiance_bwd": 15 * 3 * 4 + 12 + 16 + 12 + 15 * 3 * 4 + 12 + 16,
             "ewa_project_fwd": 12 + 24 + 16 + 8 + 12 + 4 + 8 + 4 + 1,
             "ewa_project_bwd": 12 + 24 + 16 + 8 + 12 + 4 + 4 + 12 + 24 + 16}


@pytest.fixture
def plain_kernels(monkeypatch):
    """The four wrappers replaced by their plain versions (the EWA forward by
    tensors of its outputs' shapes), and no timing."""
    monkeypatch.setattr(kt, "kernel_ms", lambda fn: 1.0)
    monkeypatch.setattr(tsh, "sh_radiance_fwd", lambda sh, means, color, pos, m, only:
                        tsh.sh_radiance_ref(sh, means, color, pos, 3, only))
    monkeypatch.setattr(tsh, "sh_radiance_bwd", lambda sh, means, color, pos, m, only, d_rgb:
                        tsh.sh_radiance_bwd_ref(sh, means, color, pos, 3, only, d_rgb))

    def ewa_fwd(means, *_):  # the forward wrapper's outputs, xy .. valid
        n, f32 = means.shape[0], means.new_empty
        return (f32((n, 2)), f32((n, 3)), f32((n,)), f32((n, 2)), f32((n,)),
                torch.empty((n,), dtype=torch.bool))

    monkeypatch.setattr(tproj, "ewa_project", ewa_fwd)
    monkeypatch.setattr(tproj, "ewa_project_bwd", tproj.project_splats_bwd_ref)


@pytest.mark.parametrize("pair", ["sh", "ewa"])
def test_kernel_time_counts_each_tensor_once(plain_kernels, pair):
    lines = getattr(kt, f"{pair}_readings")(torch.device("cpu"), N)
    assert [line["kernel"] for line in lines] == [f"{pair}_{k}" for k in (
        ("radiance_fwd", "radiance_bwd") if pair == "sh" else ("project_fwd", "project_bwd"))]
    for line in lines:
        assert line["splats"] == N
        assert line["bytes"] == N * PER_SPLAT[line["kernel"]], line
        assert line["bound_ms"] == pytest.approx(line["bytes"] / kt.HBM_BYTES_PER_S * 1e3)
        assert line["share_of_bound"] == pytest.approx(line["bound_ms"] / 1.0)


def test_kernel_time_needs_the_card():
    with pytest.raises(RuntimeError, match="only on a CUDA card"):
        kt.main("cpu")
