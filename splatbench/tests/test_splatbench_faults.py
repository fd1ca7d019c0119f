"""Whole runs on the CPU with the timed path sound, broken underneath, and
replaced by the control: ``correct`` must come out true only for the sound
one. The harness's look for a card is skipped; everything after it runs,
at the test size (conftest.small), against the cell's own limits, in every
cell's traffic (conftest.VIEW_CELLS, TRAIN_CELLS)."""

import pytest

from splatbench import checks, faults, workloads
from splatbench.tests.conftest import run_cell


def correct(out, traffic) -> bool:
    ok, _ = checks.judge(dict(out.numbers, failed=out.failed), traffic["limits"])
    return ok


def test_view_sound_run_is_correct(view_cell, cpu):
    out = run_cell(view_cell, 2147483701, cpu)
    assert out.attempted >= 1 and out.failed == 0
    assert correct(out, view_cell["traffic"])


def test_view_altered_answer_is_refused(view_cell, cpu):
    out = run_cell(view_cell, 2147483701, cpu,
                   program=workloads.Program(render=faults.altered_render))
    assert not correct(out, view_cell["traffic"])


def test_view_control_is_refused(view_cell, cpu):
    """The program's own bfloat16 tier (packed pairs) in its place."""
    view_cell["traffic"] = workloads.with_raster(view_cell["traffic"], pair_format="packed")
    out = run_cell(view_cell, 2147483702, cpu)
    assert not correct(out, view_cell["traffic"])


def test_view_overflow_fails(view_cell, cpu, monkeypatch):
    """A budget short of the frames' pairs truncates them: failed frames."""
    monkeypatch.setattr(workloads, "BUDGET_ROUND", 128)
    view_cell["traffic"]["budget_margin"] = 0.5
    out = run_cell(view_cell, 2147483703, cpu)
    assert out.failed > 0 and not correct(out, view_cell["traffic"])


def test_train_sound_run_is_correct(train_cell, cpu):
    out = run_cell(train_cell, 2147483711, cpu)
    assert out.attempted >= 1 and out.failed == 0
    assert correct(out, train_cell["traffic"])


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch_step"])
def test_train_fault_is_refused(train_cell, cpu, fault):
    out = run_cell(train_cell, 2147483711, cpu,
                   program=workloads.Program(train_step=getattr(faults, fault)))
    assert not correct(out, train_cell["traffic"])


def test_train_control_is_refused(train_cell, cpu):
    """The reference with bfloat16 storage in the program's place."""
    step = faults.reference_step(workloads.reference(train_cell["traffic"]))
    out = run_cell(train_cell, 2147483712, cpu, program=workloads.Program(train_step=step))
    assert out.failed == 0 and not correct(out, train_cell["traffic"])
