"""Scene loading and host-side sorting on worker threads (PlyLoaderAsync,
SplatSorterAsync): counterpart of ``vk_gaussian_splatting_tpu/io/async_loader.py``.

- :class:`AsyncSceneLoader`: file loading on a worker thread with status,
  progress and cancel (the ply_loader_async.h loadScene / getStatus /
  consume protocol), so a viewer or a training loop keeps running while a
  large file parses.
- :class:`AsyncHostSorter`: the reference's CPU sorting path
  (splat_sorter_async.{h,cpp}; ``SortMethod.HOST``): view-plane distance
  keys and an argsort on a worker thread, a lazy restart when the camera
  moves while a sort runs, a double-buffered consume. The order feeds
  ``render_3dgs(host_order=...)``, which blends in it, trading the
  device's depth sort for an order that may be one camera move stale, as
  the reference's CPU sort mode does. The means come to the host once, at
  construction; the worker touches numpy arrays only, never a CUDA tensor,
  and the caller moves the int32 order to the card.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from vk_gaussian_splatting_tpu_torch import native


class LoadStatus:
    IDLE = 0
    LOADING = 1
    READY = 2
    FAILED = 3
    CANCELLED = 4


class AsyncSceneLoader:
    """Background file loader (the PlyLoaderAsync protocol): ``load_scene``
    starts a worker, ``get_status`` polls (status, progress), ``consume``
    takes the SplatSet once READY (or raises what the worker raised).
    ``device``: where the loaded splats land (default: the card)."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = device
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._status = LoadStatus.IDLE
        self._progress = 0.0
        self._result = None
        self._error: Exception | None = None
        self._cancel = False

    def load_scene(self, path: str) -> bool:
        """Start loading ``path``; False if a load is running already."""
        with self._lock:
            if self._status == LoadStatus.LOADING:
                return False
            self._status = LoadStatus.LOADING
            self._progress = 0.0
            self._result = None
            self._error = None
            self._cancel = False
        self._thread = threading.Thread(target=self._inner_load, args=(path,), daemon=True)
        self._thread.start()
        return True

    def _inner_load(self, path: str):
        from vk_gaussian_splatting_tpu_torch.io import load_scene
        try:
            with self._lock:
                self._progress = 0.1
            result = load_scene(path, device=self.device)
            with self._lock:
                if self._cancel:
                    self._status = LoadStatus.CANCELLED
                else:
                    self._result = result
                    self._progress = 1.0
                    self._status = LoadStatus.READY
        except Exception as e:  # surfaced by consume
            with self._lock:
                self._error = e
                self._status = LoadStatus.FAILED

    def get_status(self) -> tuple[int, float]:
        with self._lock:
            return self._status, self._progress

    def cancel(self):
        """Drop the running load's result when it finishes (CANCELLED)."""
        with self._lock:
            self._cancel = True

    def consume(self):
        """The loaded SplatSet once READY (the loader then turns IDLE), else
        None; raises the worker's exception once FAILED."""
        if self._thread is not None:
            if self.get_status()[0] == LoadStatus.LOADING:
                return None
            self._thread.join()
            self._thread = None
        with self._lock:
            if self._status == LoadStatus.FAILED:
                err = self._error
                self._status = LoadStatus.IDLE
                raise err
            if self._status != LoadStatus.READY:
                return None
            out = self._result
            self._result = None
            self._status = LoadStatus.IDLE
            return out


def sort_order(means: np.ndarray, view_dir: np.ndarray) -> np.ndarray:
    """(N,) int32 order of the splats by view-plane distance ``means @
    view_dir`` in f32 (splat_sorter_async.cpp:118-125), ascending and
    stable: the native radix sort (``native.radix_argsort_f32``), or
    numpy's stable argsort where the library did not build (the two
    differ only in how they place -0 against +0 and negative NaNs)."""
    dist = means @ np.asarray(view_dir).astype(np.float32)
    if native.available():
        return native.radix_argsort_f32(dist)
    return np.argsort(dist, kind="stable").astype(np.int32)


class AsyncHostSorter:
    """The reference's CPU sorting path (SplatSorterAsync).

    ``sort_async(view_dir)`` sorts on a worker thread (``sort_order``); it
    is lazy: a request while a sort runs is remembered, the latest one
    only, and started when the running sort finishes (h:84-113).
    ``consume()`` returns (order, view_dir) of the newest finished sort
    once, else None; ``join()`` waits until no sort runs or waits.

    means: (N, 3) splat centres, a numpy array or a tensor (copied to host
    memory here, once)."""

    def __init__(self, means):
        if isinstance(means, torch.Tensor):
            means = means.detach().cpu().numpy()
        self.means = np.ascontiguousarray(means, np.float32)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._pending_dir = None
        self._running = False
        self._result: np.ndarray | None = None
        self._result_dir = None

    def sort_async(self, view_dir) -> None:
        view_dir = np.asarray(view_dir, np.float64)
        with self._lock:
            if self._running:
                self._pending_dir = view_dir
                return
            self._running = True
            self._start(view_dir)

    def _start(self, view_dir):
        """Start a sort of ``view_dir``. The caller holds the lock, so
        ``join`` never sees a thread that has not started."""
        self._thread = threading.Thread(target=self._inner_sort, args=(view_dir,), daemon=True)
        self._thread.start()

    def _inner_sort(self, view_dir):
        order = sort_order(self.means, view_dir)
        with self._lock:
            self._result = order
            self._result_dir = view_dir
            if self._pending_dir is not None:
                restart, self._pending_dir = self._pending_dir, None
                self._start(restart)
            else:
                self._running = False

    def consume(self):
        """(order, view_dir) of the most recent finished sort, or None."""
        with self._lock:
            if self._result is None:
                return None
            out = self._result, self._result_dir
            self._result = None
            return out

    def join(self):
        """Wait for the running sort and every restart it makes."""
        while True:
            with self._lock:
                t = self._thread
            if t is not None:
                t.join()
            with self._lock:
                if not self._running or self._thread is t:
                    return
