"""The traced window: ``torch.profiler`` over the cell's own loop, in the
run's own process (its first and only use of the profiler), read into the
numbers the per-layer metrics take.

The pattern is the port's ``chip_smoke.py::profiled`` (copied): a
synchronise and a short host sleep after the profiler opens, so that its
start-up lands before the window, and each hand-written kernel's device
records held against the port's launch counters over the window: a window
whose trace names fewer records than were launched is refused, since every
share read from it would be wrong.

The Chrome trace is written to a temporary file under ``TMPDIR``, read and
deleted; the window is bounded by the traffic's ``trace_seconds``.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

import torch

# Each hand-written kernel's device functions (``csrc/``), by the port's
# wrapper module whose launch counter counts them
KERNEL_RECORDS = {
    "K2": ("conv3x3_wgmma_kernel", "conv3x3_narrow_kernel",
           "conv3x3_f32_narrow_kernel", "conv3x3_tf32_kernel"),
    "K3": ("double_conv3x3_wgmma_kernel", "double_conv3x3_tf32_kernel"),
    "K4": ("noise_batch_kernel",),
    "K5": ("conv3x3_s8_wgmma_kernel", "conv3x3_s8_narrow_kernel"),
    "K6": ("convt2x2_s8_kernel",),
}
_KERNEL_OF = {name: k for k, names in KERNEL_RECORDS.items()
              for name in names}
# a name as it stands in a demangled record, never a suffix of a longer one
_RECORD_NAME = re.compile(r"(?:^|[\s:])(" + "|".join(_KERNEL_OF)
                          + r")\s*[<(]")
LEAD_S = 0.2
WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
SHORT_GAP_US = 10


class RecordsMissing(RuntimeError):
    pass


def kernel_of(name: str):
    """The hand-written kernel (K2...K6) a device record belongs to."""
    m = _RECORD_NAME.search(name)
    return _KERNEL_OF[m.group(1)] if m else None


def launch_counters() -> dict:
    """The port's launch counters now, by kernel."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import (
        conv3x3,
        conv3x3_s8,
        convt2x2_s8,
        double_conv,
        noise,
    )

    return {"K2": conv3x3.LAUNCHES, "K3": double_conv.LAUNCHES,
            "K4": noise.LAUNCHES + noise.GAUSSIAN_LAUNCHES,
            "K5": conv3x3_s8.LAUNCHES, "K6": convt2x2_s8.LAUNCHES}


def check_records(records: dict, launches: dict) -> None:
    """Raise where the trace names another count of a kernel's records than
    its launches over the window."""
    bad = {k: (records.get(k, 0), launches.get(k, 0))
           for k in KERNEL_RECORDS
           if records.get(k, 0) != launches.get(k, 0)}
    if bad:
        raise RecordsMissing(
            "kernel records / launches in the traced window: " + ", ".join(
                f"{k} {r}/{n}" for k, (r, n) in bad.items()))


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _short(name: str, n: int = 96) -> str:
    name = " ".join(str(name).split())
    return name if len(name) <= n else name[:n - 3] + "..."


def summarize(events: list, launches: dict) -> dict:
    """The window's numbers from a Chrome trace's events (times in us):
    busy and window seconds, device seconds by hand-written kernel, by copy
    direction and in all kernels, each kernel's record count, and the
    breakdown (top device ops, idle gaps by what the host was doing)."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("ph") == "X"]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = spans[0]["ts"]
    w1 = w0 + spans[0]["dur"]
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s, d = e["ts"], e.get("dur", 0)
            if s + d > w0 and s < w1:
                dev.append((e, max(s, w0), min(s + d, w1)))
    merged = _union([(s, t) for _, s, t in dev])
    busy = sum(t - s for s, t in merged)
    records = {k: 0 for k in KERNEL_RECORDS}
    kernel_s = {k: 0.0 for k in KERNEL_RECORDS}
    copy_s = {"HtoD": 0.0, "DtoH": 0.0, "other": 0.0}
    by_name = {}
    kernel_total = 0.0
    for e, s, t in dev:
        d = (t - s) / 1e6
        name = str(e.get("name"))
        by_name[_short(name)] = by_name.get(_short(name), 0.0) + d
        if e["cat"] == "kernel":
            kernel_total += d
            k = kernel_of(name)
            if k:
                records[k] += 1
                kernel_s[k] += d
        elif e["cat"] == "gpu_memcpy":
            key = ("HtoD" if "HtoD" in name else
                   "DtoH" if "DtoH" in name else "other")
            copy_s[key] += d
    check_records(records, launches)
    # idle gaps inside the window, each named by the innermost host span or
    # op that covers its middle
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("ph") == "X" and e.get("name") != WINDOW_SPAN]
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    longest = max((e["dur"] for e in host), default=0)
    idle = {}
    for s, t in gaps:
        if t - s < SHORT_GAP_US:
            name = f"between launches (gaps under {SHORT_GAP_US} us)"
            idle[name] = idle.get(name, 0.0) + (t - s) / 1e6
            continue
        mid = (s + t) / 2
        cover = []
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0 and starts[j] >= mid - longest:
            if starts[j] + host[j]["dur"] >= mid:
                cover.append(host[j])
            j -= 1
        if cover:
            inner = min(cover, key=lambda e: e["dur"])
            name = _short(inner["name"], 64)
            ann = [e for e in cover if e["cat"] == "user_annotation"]
            if ann and ann[0] is not inner:
                name = _short(min(ann, key=lambda e: e["dur"])["name"],
                              32) + " / " + name
        else:
            name = "host outside any op"
        idle[name] = idle.get(name, 0.0) + (t - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "records": records, "launches": launches, "kernel_s": kernel_s,
            "kernel_total_s": kernel_total, "copy_s": copy_s,
            "breakdown": {"device_ops": [[n, v] for n, v in top],
                          "idle_gaps": [[n, v] for n, v in gaps_top]}}


def traced(window_fn) -> tuple:
    """``window_fn()`` under the profiler, inside a ``WINDOW_SPAN`` span
    that ends after a synchronise.  Returns (its result, the summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    before = launch_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(LEAD_S)
        with record_function(WINDOW_SPAN):
            out = window_fn()
            torch.cuda.synchronize()
    after = launch_counters()
    launches = {k: after[k] - before[k] for k in KERNEL_RECORDS}
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, summarize(events, launches)
