"""Tracing and profiling hooks.

Port of ``celebrity_image_denoiser_tpu/utils/profiling.py``: ``trace:23``
(here ``torch.profiler`` over the CPU and, where there is one, the card,
written as a Chrome trace, with every thread's host events), ``debug_nans:34``
(here autograd's anomaly mode with its NaN check) and ``StepTimer:44``
(wall-clock per-step timing with items/s, fenced on a result).

``span(name)`` marks a stage of the program's own work (``SPANS`` names
every one) in whatever profiler records, on the same clock as the kernels
and copies it launches, so an idle gap of the card can be put down to the
stage the host was in.  With no profiler a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import profiler as autograd_profiler

from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.profiling")

# Every span the program enters, in the order a request meets them.
# ``cid.request`` is ``ServeState.denoise_image``; its stages, in order on
# the request's thread: ``prepare`` (the padding and the crop box; the
# uint8 image as a tensor), ``upload`` (the uint8 image to the device),
# inside it ``to_domain`` (``_to_domain``: the zero padding on the device
# and the map through the family's 256-entry table, once a request),
# ``forward`` (the forward's launches and the uint8 output map, or the
# micro-batcher's call when it takes the request), ``download`` (the uint8
# output to the host, into pages zeroed while the card computes; it waits
# for the card), ``finish`` (the crop).
# ``cid.batch.forward`` is the batched dispatch of a coalesced batch,
# ``cid.batch.fence`` its copy to the host
# (``serve/batching.py::default_fence``).
# Inside Restormer's forward (``models/restormer.py``):
# ``cid.restormer.attention`` is one MDTA block from its LayerNorm to the
# projection and residual add (44 a forward at the published depths),
# ``cid.restormer.ffn`` one GDFN block likewise (44), and
# ``cid.restormer.resample`` one down or up step with its skip concatenation
# and 1×1 reduction (6).
SPANS = ("cid.request", "cid.request.prepare", "cid.request.upload",
         "cid.request.to_domain", "cid.request.forward",
         "cid.request.download", "cid.request.finish", "cid.batch.forward",
         "cid.batch.fence", "cid.restormer.attention", "cid.restormer.ffn",
         "cid.restormer.resample")
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    no-op context.  The test is ``autograd.profiler._is_profiler_enabled``,
    a module global set on every thread while ``torch.profiler.profile``
    runs (``torch._C._autograd._profiler_enabled()`` is thread-local and
    reads False on a thread the profiler was not started on)."""
    if autograd_profiler._is_profiler_enabled:
        return autograd_profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the body, the host events of every thread
    included (by default it records only the thread that started it); on
    exit a Chrome trace ``trace_<pid>_<ns>.json`` in ``log_dir`` (open it in
    Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # every launched kernel in the trace
        prof.stop()
        path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Anomaly mode with its NaN check: a backward that produces a NaN
    raises with the traceback of the forward op at fault; the previous
    mode is restored on exit."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class StepTimer:
    """Wall-clock per-step timing with items/s.  ``stop(fence_array)``
    reads one element of the first tensor in ``fence_array`` (a tensor or
    a dict, list or tuple of them) to the host first, a barrier behind the
    work that produced it."""

    def __init__(self):
        self.history: list = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, fence_array=None, items: int = 0) -> float:
        if fence_array is not None:
            t = _first_tensor(fence_array)
            if t is not None:
                t.detach().reshape(-1)[0].item()
        dt = time.perf_counter() - self._t0
        self.history.append((dt, items))
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.history:
            return {}
        total = sum(t for t, _ in self.history)
        items = sum(n for _, n in self.history)
        return {
            "steps": len(self.history),
            "total_s": total,
            "mean_ms": total / len(self.history) * 1e3,
            "items_per_s": items / total if total else 0.0,
        }
