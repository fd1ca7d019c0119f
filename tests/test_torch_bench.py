"""The port's benchmark sequencer and its utilities (bench/, utils/)
against the JAX package's, on the CPU.

The cfg is tests/data/benchmark_mini.cfg, in the reference viewer's
--sequencefile grammar (a first block "Load scene and common settings"
with --sequenceframes 1024, a bare --updateData, an end-of-line comment).
Both sequencers replay it at 64x48 on the same 200 splats (numpy from one
seed); their stdout must have the same lines with every digit run masked,
the same ParameterSequence and Scene memory lines, and screenshots whose
decoded 8-bit images hold the flip-aware render gate of
tests/test_torch_render.py (>= 99.9 % of channels within 5e-5, none beyond
1.2e-2) as truncation carries it to 8 bits: two values within e truncate
to levels at most ceil(255 e) apart, so >= 99.9 % within 1 level and none
beyond 4. The port's screenshot is written with Pillow blocked (the
stdlib PNG writer) and is the 8-bit image of its own ``render`` exactly.
The report's CSV must be the same string in both packages.
"""

import io
import math
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vk_gaussian_splatting_tpu_torch as gt
from vk_gaussian_splatting_tpu.bench import report as jax_report
from vk_gaussian_splatting_tpu.bench.sequencer import BenchmarkSequencer as JaxSequencer
from vk_gaussian_splatting_tpu.bench.sequencer import parse_sequence_file as jax_parse
from vk_gaussian_splatting_tpu.scene.cameras import look_at as jax_look_at
from vk_gaussian_splatting_tpu.scene.splat_set import SplatSet as JaxSplatSet
from vk_gaussian_splatting_tpu.utils.memstats import MemoryStatistics as JaxMemoryStatistics
from vk_gaussian_splatting_tpu_torch import interop
from vk_gaussian_splatting_tpu_torch.bench import report
from vk_gaussian_splatting_tpu_torch.bench.__main__ import main as bench_main
from vk_gaussian_splatting_tpu_torch.bench.sequencer import BenchmarkSequencer, parse_sequence_file
from vk_gaussian_splatting_tpu_torch.config import Pipeline, ShFormat
from vk_gaussian_splatting_tpu_torch.io import save_ply
from vk_gaussian_splatting_tpu_torch.render.pipelines import render
from vk_gaussian_splatting_tpu_torch.utils.memstats import MemoryStatistics, nbytes_of
from vk_gaussian_splatting_tpu_torch.utils.profiling import FrameTimers

torch.set_num_threads(2)

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "benchmark_mini.cfg")
W, H = 64, 48
MAX_PAIRS = 32768
IMG_ATOL, IMG_SHARE, IMG_MAX = 5e-5, 0.999, 1.2e-2
# the same gate on 8-bit images: truncation moves values within e at most ceil(255 e) levels
IMG8_ATOL, IMG8_MAX = math.ceil(255 * IMG_ATOL), math.ceil(255 * IMG_MAX)
# tests/test_bench.py's regexes for the reference grammar
TIMER_RE = re.compile(r'Timer\s+"([^"]+)"\s*;\s*GPU;\s*avg\s+(\d+);.*?CPU;\s*avg\s+(\d+);')
MEM_RE = re.compile(r"Memory (\w+); Host used\s+(\d+); Device Used\s+(\d+); "
                    r"Device Allocated\s+(\d+);")
REPORT_TEXT = (
    'ParameterSequence 0 "warmup" =\n'
    'BENCHMARK_ADV 0 {\n'
    ' Memory Scene; Host used \t10; Device Used \t20; Device Allocated \t30; (bytes)\n}\n'
    'ParameterSequence 1 "gs fp32" =\n'
    'Timer "GPU Dist"; GPU; avg 120; min 110; max 130; CPU; avg 121; min 111; max 131;\n'
    'Timer "GPU Sort"; GPU; avg 4500; min 4500; max 4500; CPU; avg 4500; min 4500; max 4500;\n'
    'Timer "Rasterization"; GPU; avg 9000; min 9000; max 9000; CPU; avg 9000; min 9000; '
    'max 9000;\n'
    'BENCHMARK_ADV 1 {\n'
    ' Memory Rasterization; Host used \t0; Device Used \t512; Device Allocated \t1024; '
    '(bytes)\n}\n'
    'ParameterSequence 2 "no timers" =\n')


def _arrays(n=200, seed=0):
    return interop.random_splat_arrays(seed, n, sh_degree=1, scale_range=(-2.5, -1.2))


def _cam():
    return gt.look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], W, H, device="cpu")


def _port_seq(lines, arrays=None, **kw):
    return BenchmarkSequencer(interop.splat_set_from_numpy(arrays or _arrays(), "cpu"), W, H,
                              _cam(), out=lines.append, max_pairs=MAX_PAIRS, device="cpu", **kw)


def test_parse_matches_jax():
    blocks = parse_sequence_file(CFG)
    assert blocks == jax_parse(CFG)
    assert blocks[0][0] == "Load scene and common settings"
    assert blocks[0][1]["sequenceframes"] == "1024"
    mesh16 = dict(blocks)["Mesh pipeline fp16"]
    assert mesh16 == {"pipeline": "1", "shformat": "1", "updateData": ""}
    kd = [b for _, b in blocks if "kernelDegree" in b]
    assert kd and kd[0]["kernelDegree"] == "4"  # comment stripped


def test_records_to_csv_matches_jax(tmp_path, monkeypatch):
    recs = report.parse_benchmark_output(REPORT_TEXT)
    assert recs == jax_report.parse_benchmark_output(REPORT_TEXT)
    assert recs[1]["timers"]["GPU Sort"] == 4500.0
    assert recs[1]["memory"]["Rasterization"] == (0, 512, 1024)
    csv_text = report.records_to_csv(recs, scene="bicycle")
    assert csv_text == jax_report.records_to_csv(recs, scene="bicycle")
    assert "bicycle,1,gs fp32" in csv_text
    report.write_report(REPORT_TEXT, str(tmp_path / "r.csv"), scene="bicycle",
                        chart_path=str(tmp_path / "r.png"))
    with open(tmp_path / "r.csv", newline="") as f:
        assert f.read() == csv_text
    assert (tmp_path / "r.png").stat().st_size > 0
    # no matplotlib (the card has none): the CSV and no chart
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert report.write_report(REPORT_TEXT, str(tmp_path / "s.csv"),
                               chart_path=str(tmp_path / "s.png")) == recs
    assert (tmp_path / "s.csv").exists() and not (tmp_path / "s.png").exists()


def test_timer_grammar_parsable_by_reference_regex():
    timers = FrameTimers("cpu")
    timers.add("GPU Dist", 0.00123)
    timers.add("Rasterization", 0.001)
    timers.add("Rasterization", 0.003)
    with timers.section("GPU Sort"):
        pass
    buf = io.StringIO()
    timers.print_timers(out=lambda s: buf.write(s + "\n"))
    text = buf.getvalue()
    found = {m.group(1): (int(m.group(2)), int(m.group(3))) for m in TIMER_RE.finditer(text)}
    assert found["GPU Dist"] == (1230, 1230)
    assert found["Rasterization"] == (2000, 2000)
    assert 'Timer "Rasterization"; GPU; avg 2000; min 1000; max 3000; CPU; avg 2000; ' \
           'min 1000; max 3000;' in text
    assert "GPU Sort" in found and timers.avg_us("GPU Sort") >= 0
    assert report.parse_benchmark_output('ParameterSequence 0 "x" =\n' + text)[0]["timers"] == {
        k: float(v[0]) for k, v in found.items()}


def test_benchmark_adv_grammar_is_jax_character_for_character():
    ours, theirs = MemoryStatistics(), JaxMemoryStatistics()
    for ms in (ours, theirs):
        ms.set("Scene", host_used=100, device_used=200)
        ms.set("Rasterization", device_used=512, device_alloc=1024)
    a, b = [], []
    ours.print_benchmark_adv(3, out=a.append)
    theirs.print_benchmark_adv(3, out=b.append)
    assert a == b
    assert a[0] == "BENCHMARK_ADV 3 {" and a[-1] == "}"
    m = MEM_RE.search("\n".join(a))
    assert m and m.group(1) == "Scene" and int(m.group(2)) == 100


@pytest.mark.parametrize("sh_format", list(ShFormat))
def test_scene_bytes_equal_jax(sh_format):
    d = _arrays()
    splats = interop.splat_set_from_numpy(d, "cpu")
    jax_splats = JaxSplatSet(**{k: jnp.asarray(v) for k, v in d.items()})
    ours, theirs = MemoryStatistics(), JaxMemoryStatistics()
    ours.account_scene(splats, splats.prepare(sh_format))
    theirs.account_scene(jax_splats, jax_splats.prepare(sh_format))
    a, b = ours.categories["Scene"], theirs.categories["Scene"]
    assert (a.host_used, a.device_used, a.device_alloc) == (b.host_used, b.device_used,
                                                            b.device_alloc)
    assert a.host_used == nbytes_of(d) == 200 * 23 * 4  # 3 + 3 + 4 + 1 + 3 + 3 x 3 f32


def _skeleton(lines):
    return [re.sub(r"\d+", "#", s) for s in lines]


def test_sequencer_matches_jax(tmp_path, monkeypatch):
    """Both sequencers on the mini cfg plus a screenshot block; the port's
    with Pillow blocked, so its PNG comes from the stdlib writer."""
    cfg = tmp_path / "run.cfg"
    cfg.write_text(open(CFG).read() + 'SEQUENCE "Screenshot"\n--pipeline 1\n'
                   f'--screenshot "{tmp_path}/port/shot.png"\n')
    ours, theirs = [], []
    seq = _port_seq(ours)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        seq.run(parse_sequence_file(str(cfg)))
    d = _arrays()
    cam = jax_look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], W, H)
    jseq = JaxSequencer(JaxSplatSet(**{k: jnp.asarray(v) for k, v in d.items()}), W, H, cam,
                        out=theirs.append, max_pairs=MAX_PAIRS)
    jseq.run([(n, {k: v.replace("/port/", "/jax/") for k, v in p.items()})
              for n, p in jax_parse(str(cfg))])
    assert _skeleton([s.replace("/port/", "/jax/") for s in ours]) == _skeleton(theirs)
    keep = re.compile(r"ParameterSequence|BENCHMARK_ADV| Memory Scene|^\}|Screenshot")
    assert [s.replace("/port/", "/jax/") for s in ours if keep.search(s)] == \
        [s for s in theirs if keep.search(s)]
    recs = report.parse_benchmark_output("\n".join(ours))
    measured = [r for r in recs if r["timers"]]
    assert [r["name"] for r in measured] == ["Mesh pipeline fp32", "Mesh pipeline fp16",
                                             "3DGUT uint8", "3DGRT kernel degree 4"]
    for r in measured:
        stage = "Raytracing" if r["name"].startswith("3DGRT") else "Rasterization"
        assert list(r["timers"]) == ["GPU Dist", "GPU Sort", stage, "Frame"]
        assert r["memory"]["Rasterization"][1] > 0
    assert measured[-1]["memory"]["Raytracing"] == measured[-1]["memory"]["Rasterization"]
    from PIL import Image

    got = np.asarray(Image.open(f"{tmp_path}/port/shot.png"))
    want = np.asarray(Image.open(f"{tmp_path}/jax/shot.png"))
    own = render(seq.prepared, seq.camera, seq.cfg, seq.max_pairs).image
    assert got.dtype == np.uint8 and got.shape == (H, W, 3) and want.shape == got.shape
    assert np.array_equal(got, (own.clamp(0, 1).numpy() * 255).astype(np.uint8))
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert (diff <= IMG8_ATOL).mean() >= IMG_SHARE and diff.max() <= IMG8_MAX, diff.max()
    assert got.std() > 2.5


def _explicit_bytes(t):
    return t.element_size() * t.numel()


@pytest.mark.parametrize("method", ["pairs", "bucket"])
def test_rasterization_bytes_are_the_port_tensors(method):
    """The Rasterization count is the summed bytes of the projected fields,
    the bins and the blend outputs, listed field by field."""
    lines = []
    seq = _port_seq(lines)
    seq.cfg = seq.cfg.replace(raster=seq.cfg.raster.__class__(
        method=method, bucket_caps=(256, 256, 256, 256)))
    seq.apply({"sequenceframes": "2", "sequenceaverages": "1"})
    seq.update_data()
    seq._measure()
    dist, sort, blend, _ = seq._stage_fns()
    proj = dist(seq.prepared, seq.camera)
    bins = sort(seq.prepared, proj)
    out, out_id = blend(bins, seq.camera)
    proj_b = sum(_explicit_bytes(getattr(proj, f)) for f in
                 ("xy", "conic", "depth", "radius", "color", "alpha", "valid"))
    if method == "pairs":
        bin_b = sum(_explicit_bytes(getattr(bins, f)) for f in
                    ("attrs", "pair_id", "pair_valid", "tile_start", "tile_count", "num_pairs",
                     "overflow"))
    else:
        bin_b = sum(_explicit_bytes(getattr(bins, f)) for f in
                    ("attrs", "ids", "bucket_starts", "num_valid", "overflow"))
    tiles = (W // 16) * (H // 16)
    assert _explicit_bytes(out) == tiles * 5 * 256 * 4 and _explicit_bytes(out_id) == tiles * 1024
    assert seq.memstats.categories["Rasterization"].device_used == (
        proj_b + bin_b + _explicit_bytes(out) + _explicit_bytes(out_id))


@pytest.mark.parametrize("pipeline", [Pipeline.MESH, Pipeline.RTX, Pipeline.MESH_3DGUT,
                                      Pipeline.HYBRID_3DGUT])
@pytest.mark.parametrize("packed", [False, True])
def test_sort_stage_bins_the_pipelines_rows(pipeline, packed):
    """The sort stage bins gut3d rows (15, or 10 packed) for pipelines 2, 4
    and 5 and gs2d rows (10, or 7 packed) otherwise."""
    seq = _port_seq([])
    seq.cfg = seq.cfg.replace(pipeline=pipeline)
    if packed:
        seq.cfg = seq.cfg.replace(raster=seq.cfg.raster.__class__(pair_format="packed"))
    seq.update_data()
    dist, sort, _, _ = seq._stage_fns()
    bins = sort(seq.prepared, dist(seq.prepared, seq.camera))
    gut = pipeline != Pipeline.MESH
    assert bins.attrs.shape[0] == {(False, False): 10, (False, True): 7, (True, False): 15,
                                   (True, True): 10}[(gut, packed)]


def test_ignored_and_unknown_parameters_are_noted():
    lines = []
    seq = _port_seq(lines)
    seq.apply({"useAABBs": "1", "compressBlas": "0", "frobnicate": "2"})
    seq.apply({"useTlasInstances": "1"})
    assert lines == ["note: ignoring Vulkan-only parameter --useAABBs "
                     "(this renderer builds no acceleration structures)",
                     "note: unknown parameter --frobnicate ignored"]


def test_cli_writes_the_report(tmp_path, capsys):
    ply = tmp_path / "scene.ply"
    save_ply(str(ply), interop.splat_set_from_numpy(_arrays(300), "cpu"))
    cfg = tmp_path / "b.cfg"
    cfg.write_text('SEQUENCE "setup"\n--sequenceframes 2 --sequenceaverages 1\n'
                   'SEQUENCE "gs"\n--pipeline 1\n--updateData\n')
    bench_main(["--size", str(W), str(H), "--sequencefile", str(cfg), "--maxSplats", "250",
                "--csv", str(tmp_path / "r.csv"), "--method", "bucket", "--device", "cpu",
                str(ply)])
    text = capsys.readouterr().out
    assert f"Loaded 250 splats from {ply}" in text
    assert "Device: cpu" in text
    rows = (tmp_path / "r.csv").read_text().splitlines()
    assert rows[0].startswith("scene,sequence_id,sequence,GPU Dist avg us")
    assert rows[2].startswith(f"{ply},1,gs,")
