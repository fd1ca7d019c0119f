"""The probes P1-P3 of the PyTorch port (vk_gaussian_splatting_tpu_torch/probes)
on the CPU, where their wrappers run the plain twins, against the JAX
package's Pallas probes in scripts/ run in interpret mode
(``pl.pallas_call`` patched with ``interpret=True``).

Tolerance: none. The probes only compare, select and copy, so every twin
must equal its JAX script bit for bit.

JAX programs built here: P3 at eight (variant, stages, table) cases, P1
at two sizes, P2's copy kernel at W = 1 and 4 and its sort stage:
thirteen.
"""

import functools
import importlib.util
import runpy
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vk_gaussian_splatting_tpu_torch.probes import bench_radix_ab as pa
from vk_gaussian_splatting_tpu_torch.probes import bench_roll as pr
from vk_gaussian_splatting_tpu_torch.probes import bench_sort_stage as ps
from test_torch_cuda import duplicating, same_bits, with_keys

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX probes' Pallas kernels in interpret mode; sys.argv and
    sys.path restored afterwards (the scripts read the one and extend the
    other)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", list(sys.argv))


def load_script(name: str, argv: list[str]):
    """scripts/<name>.py as a fresh module, imported with ``argv``."""
    sys.argv = argv
    spec = importlib.util.spec_from_file_location(
        f"jax_probe_{name}_{'_'.join(argv[1:]).replace('-', '_')}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- P3: bench_sort_stage

@pytest.mark.parametrize("variant, n_stages", [("lane-iota", 55), ("lane-const", 55),
                                               ("sub8", 55), ("lane-iota", 20),
                                               ("lane-iota", 70)])
def test_sort_stages_match_jax(interpret, variant, n_stages):
    rows, tpt = 4, 2
    mod = load_script("bench_sort_stage", ["bench_sort_stage.py", variant, str(rows),
                                           str(n_stages), str(tpt)])
    mod.STEPS = 1
    x, m, sched = ps.inputs(variant, rows, n_stages, tpt, "cpu", seed=3)
    assert sched == mod.SCHED
    masks = mod.np_masks()
    assert np.array_equal(masks, ps.np_masks(sched))
    if variant == "sub8":
        masks = masks.reshape(2 * n_stages, 8, 128)
    want = np.asarray(jax.jit(mod.make_call(variant))(x.numpy(), masks))
    got = ps.sort_stages(x, m, variant, sched, rows - 1)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ps.sort_stages_by_index(x, m, variant, sched, rows - 1).numpy(), want)
    if n_stages == 55:  # the full schedule of 1024 sorts each tile by its key row
        flat = x.reshape(tpt, rows, 1024)
        order = torch.argsort(flat[:, rows - 1], dim=-1)
        assert torch.equal(got.reshape(tpt, rows, 1024),
                           torch.take_along_dim(flat, order[:, None], dim=-1))


# ---- the (key, index) form of P1 and P3: the network on (key, column
# index) pairs, then one gather of every row (what csrc/bench_roll.cu and
# csrc/bench_sort_stage.cu run), against the twins bit for bit

# id: (variant, rows, stages, tiles, keys, table, against the JAX script too)
INDEX_CASES = {
    "lane-iota": ("lane-iota", 4, 55, 2, None, None, False),
    "lane-const": ("lane-const", 4, 55, 2, None, None, False),
    "sub8": ("sub8", 4, 55, 2, None, None, False),
    "lane-iota-cut": ("lane-iota", 2, 20, 3, None, None, False),
    "lane-const-wrapped": ("lane-const", 4, 70, 2, None, None, False),
    "sub8-wrapped": ("sub8", 2, 70, 3, None, None, False),
    "lane-iota-equal-keys": ("lane-iota", 3, 55, 2, "equal", None, False),
    "lane-const-binary-keys": ("lane-const", 4, 55, 2, "binary", None, False),
    "sub8-binary-keys": ("sub8", 1, 55, 2, "binary", None, False),
    "lane-iota-zeros-nan": ("lane-iota", 4, 55, 2, "zeros_nan", None, True),
    "sub8-zeros-nan": ("sub8", 4, 70, 2, "zeros_nan", None, False),
    "lane-const-duplicating": ("lane-const", 4, 55, 2, None, "duplicating", True),
    "sub8-duplicating": ("sub8", 8, 40, 2, "binary", "duplicating", True),
    "roll-c128": ("roll", 3, 1, 128, None, None, False),
    "roll-c256-reps3-binary": ("roll", 5, 3, 256, "binary", None, False),
    "roll-c2-reps2": ("roll", 3, 2, 2, None, None, False),
    "roll-c64-reps2-zeros-nan": ("roll", 4, 2, 64, "zeros_nan", None, False),
}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_index_form_is_the_twin(interpret, case):
    variant, rows, stages, size, keys, table, jax_too = INDEX_CASES[case]
    if variant == "roll":   # P1: stages are reps, size the width C
        x = pr.tiles_of(4, rows, size, "cpu", seed=2)
        x = with_keys(x, 0, keys) if keys else x
        got = pr.bitonic_sort_by_index(x, stages)
        assert same_bits(got, pr.bitonic_sort_ref(x, stages))
        assert same_bits(got, pr.bitonic_sort(x, stages))
        return
    x, m, sched = ps.inputs(variant, rows, stages, size, "cpu", seed=6)
    if keys:
        x = with_keys(x, rows - 1, keys)
    if table == "duplicating":
        m = duplicating(m, sched)
    got = ps.sort_stages_by_index(x, m, variant, sched, rows - 1)
    assert same_bits(got, ps.sort_stages_ref(x, m, variant, sched, rows - 1))
    if table == "duplicating":   # some columns now hold the same input column twice
        flat = got.reshape(size, rows, 1024)
        assert any(len(torch.unique(flat[t, rows - 1])) < 1024 for t in range(size))
    if jax_too:
        mod = load_script("bench_sort_stage", ["bench_sort_stage.py", variant, str(rows),
                                               str(stages), str(size)])
        mod.STEPS = 1
        masks = mod.np_masks() if m is None else m.numpy()
        if variant == "sub8":
            masks = masks.reshape(2 * stages, 8, 128)
        want = np.asarray(jax.jit(mod.make_call(variant))(x.numpy(), masks))
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_schedule_cut_and_repeated():
    full = ps.full_schedule(1024)
    assert len(full) == 55 and len(ps.full_schedule(2048)) == 66
    assert full[:3] == [(2, 1), (4, 2), (4, 1)] and full[-1] == (1024, 1)
    assert ps.schedule(20) == full[:20]
    assert ps.schedule(70) == full + full[:15]
    assert ps.schedule(0) == []


def test_sub8_twin_is_lane_const_in_flat_order():
    x, m, sched = ps.inputs("lane-const", 8, 40, 3, "cpu", seed=5)
    flat = ps.sort_stages(x, m, "lane-const", sched, 7)
    sub8 = ps.sort_stages(x.reshape(3, 8, 8, 128), m.reshape(80, 8, 128), "sub8", sched, 7)
    assert torch.equal(sub8.reshape(3, 8, 1024), flat)


def test_taking_columns_counts_moves():
    x, _, sched = ps.inputs("lane-iota", 2, 55, 1, "cpu")
    assert ps.taking_columns(torch.ones_like(x), None, "lane-iota", sched, 1) == 0
    n = ps.taking_columns(x, None, "lane-iota", sched, 1)
    assert 0 < n < 55 * 1024
    assert n % 2 == 0  # the masks of every stage pair columns: both take or neither


@pytest.mark.parametrize("variant, shape, rows_key, match", [
    ("lane-fast", (1, 4, 1024), 3, "variant"),
    ("lane-iota", (1, 4, 512), 3, "tiles, rows"),
    ("lane-iota", (1, 4, 1024), 4, "key row"),
    ("lane-const", (1, 4, 1024), 3, "mask table"),
    ("sub8", (1, 3, 8, 128), 2, "registers"),
    ("sub8", (1, 4, 8, 128), 0, "registers"),
])
def test_sort_stages_reject_bad_inputs(variant, shape, rows_key, match):
    x = torch.zeros(shape)
    masks = torch.zeros((2, 8, 128)) if variant == "sub8" else None
    with pytest.raises(ValueError, match=match):
        ps.sort_stages(x, masks, variant, [(2, 1)], rows_key)


def test_sort_stages_reject_bad_stage_and_blocks():
    x = torch.zeros((1, 2, 1024))
    with pytest.raises(ValueError, match="power of two"):
        ps.sort_stages(x, None, "lane-iota", [(8, 3)], 1)
    with pytest.raises(ValueError, match="blocks"):
        ps.sort_stages(x, None, "lane-iota", [(2, 1)], 1, blocks=0)


# ---- P1: bench_roll

@pytest.mark.parametrize("r, c", [(4, 128), (16, 256)])
def test_bitonic_sort_matches_jax(interpret, r, c):
    sys.argv = ["bench_roll.py", str(r), str(c)]
    g = runpy.run_path(str(SCRIPTS / "bench_roll.py"))
    assert g["REPS"] == pr.REPS
    x = torch.from_numpy(np.array(g["x"]))
    got = pr.bitonic_sort(x[None].contiguous(), pr.REPS)[0]
    assert np.array_equal(got.numpy(), np.asarray(g["r"]))
    assert torch.equal(pr.bitonic_sort_by_index(x[None].contiguous(), pr.REPS)[0], got)
    assert torch.equal(got, x[:, torch.argsort(x[0])])


def test_bitonic_sort_reps_and_batch():
    x = pr.tiles_of(3, 5, 64, "cpu")
    once = pr.bitonic_sort(x, 1)
    assert torch.equal(once[:, 0], torch.sort(x[:, 0], dim=-1).values)
    assert torch.equal(pr.bitonic_sort(x, 3), pr.bitonic_sort(once, 2))
    assert torch.equal(pr.bitonic_sort(x, 0), x)
    for t in range(3):
        assert torch.equal(once[t], pr.bitonic_sort(x[t:t + 1].contiguous(), 1)[0])


@pytest.mark.parametrize("shape, reps, match", [((1, 4, 96), 1, "power of two"),
                                                ((4, 64), 1, "(T, R, C)"),
                                                ((1, 4, 64), -1, "reps")])
def test_bitonic_sort_rejects_bad_inputs(shape, reps, match):
    with pytest.raises(ValueError, match=match):
        pr.bitonic_sort(torch.zeros(shape), reps)


# ---- P2: bench_radix_ab

@pytest.fixture
def radix_script(interpret):
    return load_script("bench_radix_ab", ["bench_radix_ab.py"])


@pytest.mark.parametrize("w", [1, 4])
def test_copies_match_jax(radix_script, w):
    src = np.random.default_rng(w).standard_normal((2048, 16, 128)).astype(np.float32)
    want = np.asarray(radix_script.dma_bench_call(2, 9, w)(src))
    got = pa.dma_copies(torch.from_numpy(src), 2, 9, w)
    assert got.shape == (1, 16, 128)
    assert np.array_equal(got.numpy(), want)


def test_copies_twin_trace_and_ring():
    src = torch.randn((pa.SRC_BLOCKS, *pa.BLOCK), generator=torch.Generator().manual_seed(0))
    out, copies = pa.dma_copies(src, 3, 20, 4, trace=True)
    offs = pa.copy_offsets(3, 20)
    assert offs[:3] == [0, 1, 2] and offs[-1] == 59
    want = torch.stack([src[o:o + 4] for o in offs]).reshape(3, 20, 4, *pa.BLOCK)
    assert torch.equal(copies, want)
    assert torch.equal(out[0], src[2 * 20 + 16])   # the last copy into slot 0: i = 16
    assert torch.equal(pa.dma_copies(src, 40, 64, 1)[0], src[(39 * 64 + 56) % 1024])
    assert pa.ring_of(1) == (1, 1, 4, 4 * 8192, 1)
    assert (pa.ring_of(4, 1) == (4, 1, 7, 7 * 4 * 8192, 7)
            and pa.ring_of(64, 1) == (8, 8, 3, 3 * 8 * 8192, 3))


@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 16, 17, 64])
def test_ring_plan(w, per_sm):
    plan = pa.ring_of(w, per_sm)
    pieces = pa.pieces_of(w, plan.slot_blocks)
    assert len(pieces) == plan.pieces
    covered = [b for start, n in pieces for b in range(start, start + n)]
    assert covered == list(range(w))                       # every block once, in order
    sizes = [n for _, n in pieces]
    assert max(sizes) == plan.slot_blocks and max(sizes) - min(sizes) <= 1
    assert plan.ring_bytes == plan.depth * plan.slot_blocks * pa.BLOCK_BYTES
    assert 1 <= plan.depth <= (pa.MAX_SLOTS if per_sm == 1 else pa.CARD_DEPTH)
    assert plan.ring_bytes * per_sm <= 232448               # 227 KB: the SM's share for blocks
    # the fewest pieces: one piece fewer would need a larger slot than the plan allows
    most = (min(pa.ONE_PIECE_BLOCKS, pa.ring_budget(1) // pa.BLOCK_BYTES // pa.MIN_DEPTH)
            if per_sm == 1 else pa.CARD_PIECE_BLOCKS)
    assert plan.slot_blocks <= most
    assert plan.pieces == 1 or -(-w // (plan.pieces - 1)) > most
    if per_sm == 1:
        assert plan.depth >= pa.MIN_DEPTH
    # the lanes divide the slots, so one producer and one consumer lane own each
    assert plan.depth % plan.lanes == 0
    assert plan.lanes == 1 or (per_sm == 1 and plan.lanes <= pa.ONE_BLOCK_LANES)


def test_copies_reject_bad_inputs():
    with pytest.raises(ValueError, match="read 1026 blocks"):
        pa.dma_copies(torch.zeros((1025, 16, 128)), 256, 64, 3)
    with pytest.raises(ValueError, match="must be positive"):
        pa.dma_copies(torch.zeros((2048, 16, 128)), 1, 0, 1)
    with pytest.raises(ValueError, match="src must be"):
        pa.dma_copies(torch.zeros((2048, 8, 128)), 1, 1, 1)


def test_sort_stage_matches_jax(radix_script):
    # one slot per splat, no sentinel bucket (the script has neither)
    rng = np.random.default_rng(4)
    n = 8192
    bucket = np.where(rng.random(n) < 0.75, rng.integers(0, 8160, n),
                      rng.integers(8160, pa.N_BUCKETS - 1, n)).astype(np.int32)
    depth = (rng.permutation(n) / n).astype(np.float32)     # distinct depths
    rows = rng.standard_normal((pa.R_PAYLOAD, n)).astype(np.float32)
    jb, jrow = radix_script.sort_stage(bucket, depth, rows)
    b, row = pa.sort_stage(torch.from_numpy(bucket), torch.from_numpy(depth),
                           torch.from_numpy(rows), torch.arange(n, dtype=torch.int32))
    assert b.dtype == torch.int32
    assert np.array_equal(b.numpy(), np.asarray(jb))
    assert np.array_equal(row.numpy(), np.asarray(jrow))
    for chunk, shift in ((4096, 7), (4096, 0), (2048, 3)):
        assert pa.run_stats(torch.from_numpy(bucket), chunk, shift) == \
            radix_script.run_stats(bucket, chunk, shift)


def test_sort_stage_slots_and_sentinel():
    # as bucket_splats sorts: 4 slot-major slots per splat, the sentinel
    # bucket's slots at +inf depth in slot order, rows gathered by splat
    rng = np.random.default_rng(5)
    n = 1000
    bucket = torch.from_numpy(rng.integers(0, 40, 4 * n))   # many slots per bucket
    bucket[::7] = pa.N_BUCKETS - 1
    depth = torch.from_numpy(rng.random(n).astype(np.float32))
    rows = torch.from_numpy(rng.standard_normal((pa.R_PAYLOAD, n)).astype(np.float32))
    b, row = pa.sort_stage(bucket, depth, rows, torch.arange(n, dtype=torch.int32))
    dkey = np.where(bucket.numpy() < pa.N_BUCKETS - 1, np.tile(depth.numpy(), 4), np.inf)
    order = np.lexsort((np.arange(4 * n), dkey, bucket.numpy()))
    assert np.array_equal(b.numpy(), bucket.numpy()[order])
    assert np.array_equal(row.numpy(), rows[0].numpy()[order % n])


def test_make_keys_occupancy():
    bucket, depth = pa.make_keys(40000, "cpu", seed=2)
    assert bucket.dtype == torch.int64 and depth.dtype == torch.float32
    assert int(bucket.min()) >= 0 and int(bucket.max()) < 13000
    assert abs((bucket < 8160).float().mean().item() - 0.75) < 0.01   # 75 % fine buckets
    assert torch.equal(pa.make_keys(100, "cpu", seed=2)[0], pa.make_keys(100, "cpu", seed=2)[0])


# ---- the entry points

def test_probes_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run on it")
    for run in (pr.run, ps.run, pa.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_probe_entry_points_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(pr, "REPS", 2)
    monkeypatch.setattr(pr, "FRAME_TILES", 3)
    monkeypatch.setattr(ps, "STEPS", 2)
    monkeypatch.setattr(pa, "N_STEPS", 2)
    monkeypatch.setattr(pa, "N_COPIES", 9)
    monkeypatch.setattr(pa, "WIDTHS", (1, 4))
    res = pr.run(4, 64, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu") and "R=4 C=64" in lines[1]
    assert "21-stage sort" in lines[1] and "3 tiles" in lines[1] and res["frame_ms"] > 0
    for variant in ps.VARIANTS:
        res = ps.run(variant, 4, 10, 2, device="cpu")
        line = capsys.readouterr().out.splitlines()[-1]
        assert f"{variant} rows=4 stages=10 tpt=2" in line and "(2 blocks)" in line
        assert res["ms"] > 0
    res = pa.run([0.01], device="cpu")
    text = capsys.readouterr().out
    assert "4 piece(s) per copy: one block (ring 7 x 32 KB)" in text and "torch sort stage" in text
    assert text.count("passB(") == 3 and set(res["per_copy_ns"]) == {1, 4}
