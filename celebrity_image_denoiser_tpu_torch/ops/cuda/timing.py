"""Device-clock timing of kernel launches, shared by ``chip_smoke.py`` and
``ops/cuda/ablation.py``.  Needs one CUDA card and ``nvidia-smi``."""

from __future__ import annotations

import functools
import subprocess
import time

import torch

SLEEP_S = 0.05  # what the card sleeps while the host enqueues


@functools.cache
def max_sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` gives it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi clocks.max.sm failed: "
                           f"{smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def device_ms(fn, reps: int = 50) -> float:
    """Mean device time of ``fn`` over ``reps`` calls with no host time
    between them: the card first sleeps (``torch.cuda._sleep``) while the
    host enqueues every call behind it, so the events time the kernels
    back to back on the device's clock.  Raises if enqueueing took more
    than half the sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_S * max_sm_clock_hz()))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    end.synchronize()
    if host > 0.5 * SLEEP_S:
        raise RuntimeError(f"enqueueing {reps} calls took {host * 1e3:.1f} "
                           f"ms of the card's {SLEEP_S * 1e3:.0f} ms sleep: "
                           "not a device time")
    return start.elapsed_time(end) / reps
