"""Benchmark sequencer: replays the reference's SEQUENCE cfg files.

Speaks the exact grammar of the reference toolchain so its ``benchmark.py``
parser works on this stdout (SURVEY.md §3.5):

- cfg files: ``SEQUENCE "name"`` blocks of ``--param value`` lines
  (nvutils::ParameterSequencer, main.cpp:39-44; e.g. benchmark_3dgs.cfg)
- per block: apply params, render ``sequenceframes`` frames, print
  ``ParameterSequence {id} "{name}" =``, per-stage ``Timer`` lines
  (utils/profiling.py) and the ``BENCHMARK_ADV`` memory block
  (utils/memstats.py).

Recognized params (parameters.cpp:90-142 + UI registrations
gaussian_splatting_ui.cpp:63-83): pipeline, shformat, maxShDegree,
kernelDegree, sequenceframes/averages/resetframes, updateData, screenshot,
benchmark. Vulkan-only acceleration-structure switches (useAABBs,
useTlasInstances, compressBlas, extentProjection) are accepted and ignored —
this renderer builds no BLAS/TLAS (noted to stdout once).

The stages are plain functions of the port's pipeline: ``GPU Dist`` the
projection, ``GPU Sort`` the bin stage of the configured method over the
pipeline's own attribute rows, ``Rasterization`` (``Raytracing`` for the
RTX and hybrid pipelines) and ``Frame`` the whole ``render``. On a CUDA
device the Timer lines' GPU column comes from CUDA events around each stage
(utils/profiling.FrameTimers).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shlex
import time

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch.config import Pipeline, RenderConfig, ShFormat, SortMethod
from vk_gaussian_splatting_tpu_torch.devices import resolve_device
from vk_gaussian_splatting_tpu_torch.ops.projection import project_splats, ut_project_splats
from vk_gaussian_splatting_tpu_torch.render.pipelines import (
    bin_for_cfg,
    blend_bins,
    gs_attr_rows,
    gs_attr_rows_packed,
    gut_attr_rows,
    gut_attr_rows_packed,
    gut_statics,
    packed,
    raster_statics,
    render,
    sample_seed,
)
from vk_gaussian_splatting_tpu_torch.render.rays import build_tile_rays
from vk_gaussian_splatting_tpu_torch.utils.memstats import MemoryStatistics
from vk_gaussian_splatting_tpu_torch.utils.profiling import FrameTimers
from vk_gaussian_splatting_tpu_torch.viewer import save_png

GUT_PIPELINES = (Pipeline.RTX, Pipeline.MESH_3DGUT, Pipeline.HYBRID_3DGUT)
TRACED_PIPELINES = (Pipeline.RTX, Pipeline.HYBRID, Pipeline.HYBRID_3DGUT)


def parse_sequence_file(path: str) -> list[tuple[str, dict]]:
    """cfg -> [(name, {param: value})]."""
    blocks: list[tuple[str, dict]] = []
    current: dict | None = None
    name = ""
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.match(r'SEQUENCE\s+"([^"]*)"', line)
            if m:
                if current is not None:
                    blocks.append((name, current))
                name = m.group(1)
                current = {}
                continue
            if current is None:
                continue
            toks = shlex.split(line)
            i = 0
            while i < len(toks):
                if toks[i].startswith("--"):
                    key = toks[i][2:]
                    if i + 1 < len(toks) and not toks[i + 1].startswith("--"):
                        current[key] = toks[i + 1]
                        i += 2
                    else:
                        current[key] = ""
                        i += 1
                else:
                    i += 1
    if current is not None:
        blocks.append((name, current))
    return blocks


_IGNORED = {"useAABBs", "useTlasInstances", "compressBlas", "extentProjection",
            "vsync", "benchmark"}


def _to(obj, device: torch.device):
    """A SplatSet or Camera with every tensor field on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


class BenchmarkSequencer:
    """Executes SEQUENCE blocks against the render pipelines.

    splats (SplatSet) and camera are moved to ``device`` (default: the
    card), where every stage runs and is timed."""

    def __init__(self, splats, width: int, height: int, camera, out=print,
                 max_pairs: int | None = None, device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.splats = _to(splats, self.device)
        self.camera = _to(camera, self.device)
        self.out = out
        self.cfg = RenderConfig(width=width, height=height)
        self.max_pairs = max_pairs or max(4 * splats.num_splats, 1 << 20)
        self.frames = 128
        self.averages = 128
        self.reset_frames = 0
        self.prepared = None
        self.benchmark_id = 0
        self.memstats = MemoryStatistics()
        self._warned_ignored = False

    # -- parameter application (the sequencer's CLI re-parse) -----------
    def apply(self, params: dict):
        cfg = self.cfg
        for key, val in params.items():
            if key == "pipeline":
                cfg = cfg.replace(pipeline=Pipeline(int(val)))
            elif key == "shformat":
                cfg = cfg.replace(sh_format=ShFormat(int(val)))
            elif key == "maxShDegree":
                cfg = cfg.replace(sh_degree=int(val))
            elif key == "kernelDegree":
                cfg = cfg.replace(rt=dataclasses.replace(
                    cfg.rt, kernel_degree=int(val)))
            elif key == "sequenceframes":
                self.frames = int(val)
            elif key == "sequenceaverages":
                self.averages = int(val)
            elif key == "sequenceresetframes":
                self.reset_frames = int(val)
            elif key in ("updateData", "screenshot"):
                pass  # handled by run_block
            elif key in _IGNORED:
                if not self._warned_ignored:
                    self.out(f"note: ignoring Vulkan-only parameter --{key} "
                             "(this renderer builds no acceleration structures)")
                    self._warned_ignored = True
            else:
                self.out(f"note: unknown parameter --{key} ignored")
        self.cfg = cfg

    def update_data(self):
        """The --updateData trigger: re-prepare splats for the current
        sh format (SplatSetVk::initDataStorage re-run)."""
        self.prepared = self.splats.prepare(self.cfg.sh_format)
        self.memstats.account_scene(self.splats, self.prepared)

    def screenshot(self, path: str):
        """One ``render`` of the current config saved to ``path`` as an
        8-bit PNG (``viewer.save_png``)."""
        out = render(self.prepared if self.prepared is not None
                     else self.splats.prepare(self.cfg.sh_format),
                     self.camera, self.cfg, self.max_pairs)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_png(path, out.image)
        self.out(f'Screenshot saved to "{path}"')

    # -- measured run ----------------------------------------------------
    def run_block(self, idx: int, name: str, params: dict):
        self.out(f'ParameterSequence {idx} "{name}" =')
        self.apply(params)
        if "updateData" in params:
            self.update_data()
            self._measure()
        if "screenshot" in params and params["screenshot"]:
            self.screenshot(params["screenshot"])
        self.memstats.print_benchmark_adv(self.benchmark_id, self.out)
        self.benchmark_id += 1

    def _stage_fns(self):
        """(dist, sort, blend, frame) of the current config: the projection,
        the bin stage (TileBins or BucketBins of ``bin_for_cfg``), one blend
        of its bins ((out, out_id), sample 0) and the whole ``render``."""
        cfg = self.cfg
        max_pairs = self.max_pairs
        gut = cfg.pipeline in GUT_PIPELINES
        proj_fn = ut_project_splats if gut else project_splats
        st = raster_statics(cfg)
        if gut:
            kw = (dict(alpha_clamp=cfg.rt.alpha_clamp, min_transmittance=cfg.rt.min_transmittance)
                  if cfg.pipeline == Pipeline.RTX else {})
            st = gut_statics(st, cfg, **kw)

        def dist(prepared, cam):
            return proj_fn(prepared, cam, cfg)

        # the sort stage uses the PIPELINE'S real attribute rows — the gut3d
        # layouts carry 15 / 10 rows against gs2d's 10 / 7, and the sort stage
        # is payload-bound, so timing the gs rows for pipelines 2/4/5 would
        # misreport exactly the tables the reference benchmarks
        def sort(prepared, proj):
            if gut:
                rows, ids = (gut_attr_rows_packed if packed(cfg)
                             else gut_attr_rows)(prepared, proj, cfg)
            else:
                rows, ids = (gs_attr_rows_packed if packed(cfg) else gs_attr_rows)(proj)
            return bin_for_cfg(proj, rows, ids, cfg, max_pairs, st)

        def blend(bins, cam):
            pix_ctx = build_tile_rays(cam, cfg, sample_id=0) if gut else None
            return blend_bins(bins, cfg, st, pix_ctx, sample_seed(0))

        def frame(prepared, cam):
            return render(prepared, cam, cfg, max_pairs)

        return dist, sort, blend, frame

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _measure(self):
        timers = FrameTimers(self.device)
        dist, sort, blend, frame = self._stage_fns()
        prepared, cam = self.prepared, self.camera
        host_sort = self.cfg.raster.sort_method == SortMethod.HOST

        # warmup / reset frames, then one pass of the stages whose tensors
        # the Rasterization bytes count (one blend launch of its own)
        for _ in range(max(self.reset_frames, 1)):
            frame(prepared, cam)
        proj = dist(prepared, cam)
        bins = sort(prepared, proj)
        blend_out = blend(bins, cam)
        self._sync()

        n = max(min(self.frames, 1024) // max(self.averages, 1), 1)
        stage_name = ("Raytracing" if self.cfg.pipeline in TRACED_PIPELINES
                      else "Rasterization")
        for _ in range(n):
            with timers.section("GPU Dist"):
                proj_n = dist(prepared, cam)
            if host_sort:
                # the async CPU sorting path (SplatSorterAsync,
                # splat_sorter_async.cpp:92-138): plane distances + argsort
                # on the host
                with timers.section("CPU Dist"):
                    depth_h = proj_n.depth.cpu().numpy()
                with timers.section("CPU Sort"):
                    np.argsort(depth_h, kind="stable")
            with timers.section("GPU Sort"):
                sort(prepared, proj_n)
            with timers.section(stage_name):
                frame(prepared, cam)
        # the stages are measured independently; the whole frame also as
        # a run of back-to-back frames on the host clock
        t0 = time.perf_counter()
        reps = max(n, 3)
        for _ in range(reps):
            frame(prepared, cam)
        self._sync()
        timers.add("Frame", (time.perf_counter() - t0) / reps)
        self.memstats.account_raster(proj, bins, blend_out)
        if self.cfg.pipeline in TRACED_PIPELINES:
            self.memstats.account_raytracing(
                self.memstats.categories["Rasterization"].device_used)
        timers.print_timers(self.out)

    def run(self, blocks: list[tuple[str, dict]]):
        for idx, (name, params) in enumerate(blocks):
            self.run_block(idx, name, params)
