"""Tracing and profiling hooks.

Port of ``celebrity_image_denoiser_tpu/utils/profiling.py``: ``trace:23``
(here ``torch.profiler`` over the CPU and, where there is one, the card,
written as a Chrome trace), ``debug_nans:34`` (here autograd's anomaly mode
with its NaN check) and ``StepTimer:44`` (wall-clock per-step timing with
items/s, fenced on a result).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.profiling")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the body; on exit a Chrome trace
    ``trace_<pid>_<ns>.json`` in ``log_dir`` (open it in Perfetto or
    chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
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
