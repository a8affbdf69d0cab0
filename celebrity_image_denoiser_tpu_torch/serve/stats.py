"""In-process serving metrics for the `/stats` and `/healthz` routes.

Framework addition (the reference backend has no observability surface at
all — its only signals are uvicorn access logs, backend/app.py): per-model
request counters, error counts, latency quantiles over a sliding window,
and compute-backend routing counts (int8/float × plain/tiled/sharded — the
`compute=` field of the per-request stage-timing log line, aggregated).

Thread-safe: the stdlib server handles each request on its own thread and
the FastAPI variant uses a threadpool, so all mutation happens under one
lock.  Latencies keep a bounded deque per model (last ``window`` requests)
— O(1) memory, and quantiles over the recent window are what an operator
actually wants on a long-lived process.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict


def _safe_key(model) -> str:
    """Bound and sanitize an attacker-controlled model string before it
    becomes a counter key / metric label: truncate, strip everything
    outside a conservative charset (kills Prometheus label injection via
    quotes/newlines/backslashes; '+' is allowed — the compute-backend
    labels are 'int8+tiled'-shaped), lowercase (so pre-run_enhance errors
    counted from the raw query param share the canonical series — e.g.
    'DENOISE:400' and 'denoise:400' must be one counter), and map empty
    to 'unknown'."""
    cleaned = "".join(c for c in str(model)[:40]
                      if c.isalnum() or c in "._:-+").lower()
    return cleaned or "unknown"


class ServeStats:
    # distinct error keys are capped: unknown ?model= strings are attacker-
    # controlled, and an unbounded dict on a long-lived server is a slow
    # memory leak.  Overflow lands in one 'other' bucket.
    MAX_ERROR_KEYS = 64

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._window = window
        self._requests: Dict[str, int] = collections.defaultdict(int)
        self._errors: Dict[str, int] = collections.defaultdict(int)
        self._latency: Dict[str, collections.deque] = {}
        self._backends: Dict[str, int] = collections.defaultdict(int)

    def record(self, model: str, latency_s: float, backend: str) -> None:
        model = _safe_key(model)
        with self._lock:
            self._requests[model] += 1
            self._backends[_safe_key(backend)] += 1
            dq = self._latency.get(model)
            if dq is None:
                dq = self._latency[model] = collections.deque(
                    maxlen=self._window)
            dq.append(latency_s)

    def record_error(self, model: str, status: int) -> None:
        key = f"{_safe_key(model)}:{int(status)}"
        with self._lock:
            if key not in self._errors and len(self._errors) >= \
                    self.MAX_ERROR_KEYS:
                key = f"other:{int(status)}"
            self._errors[key] += 1

    @staticmethod
    def _quantile(sorted_vals, q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
        return sorted_vals[i]

    def prometheus(self) -> str:
        """Prometheus text exposition format (`GET /metrics`) — the same
        aggregates as ``snapshot()`` in the shape a standard scraper
        ingests; quantiles are over the sliding window, labeled per model,
        backends/errors as labeled counters."""
        s = self.snapshot()
        lines = [
            "# HELP cid_uptime_seconds Process uptime.",
            "# TYPE cid_uptime_seconds gauge",
            f"cid_uptime_seconds {s['uptime_s']}",
            "# HELP cid_requests_total Successful /enhance requests.",
            "# TYPE cid_requests_total counter",
        ]
        for model, n in sorted(s["requests"].items()):
            lines.append(f'cid_requests_total{{model="{model}"}} {n}')
        lines += ["# HELP cid_errors_total Failed /enhance requests.",
                  "# TYPE cid_errors_total counter"]
        for key, n in sorted(s["errors"].items()):
            model, _, status = key.rpartition(":")
            lines.append(
                f'cid_errors_total{{model="{model}",status="{status}"}} {n}')
        lines += ["# HELP cid_request_latency_seconds Sliding-window "
                  "/enhance latency quantiles.",
                  "# TYPE cid_request_latency_seconds summary"]
        for model, lat in sorted(s["latency"].items()):
            for q, k in (("0.5", "p50_ms"), ("0.95", "p95_ms")):
                lines.append(
                    f'cid_request_latency_seconds{{model="{model}",'
                    f'quantile="{q}"}} {lat[k] / 1e3}')
        # window sizes as their OWN uninterrupted group (interleaving them
        # inside the summary group violates the exposition format — strict
        # parsers like promtool reject it)
        lines += ["# HELP cid_request_latency_window Samples currently in "
                  "each model's sliding latency window.",
                  "# TYPE cid_request_latency_window gauge"]
        for model, lat in sorted(s["latency"].items()):
            lines.append(
                f'cid_request_latency_window{{model="{model}"}} '
                f'{lat["window"]}')
        lines += ["# HELP cid_compute_backend_total Requests per compute "
                  "routing (int8/float x plain/tiled/sharded).",
                  "# TYPE cid_compute_backend_total counter"]
        for backend, n in sorted(s["compute_backends"].items()):
            lines.append(
                f'cid_compute_backend_total{{backend="{backend}"}} {n}')
        return "\n".join(lines) + "\n"

    def uptime_s(self) -> float:
        """Cheap uptime for the liveness path: no lock, no quantile work —
        /healthz probes poll every few seconds and must not contend with
        request threads recording into the latency windows."""
        return round(time.time() - self._t0, 1)

    def snapshot(self) -> dict:
        with self._lock:
            lat = {}
            for model, dq in self._latency.items():
                vals = sorted(dq)
                lat[model] = {
                    "window": len(vals),
                    "p50_ms": round(self._quantile(vals, 0.50) * 1e3, 1),
                    "p95_ms": round(self._quantile(vals, 0.95) * 1e3, 1),
                    "max_ms": round(vals[-1] * 1e3, 1) if vals else 0.0,
                }
            return {
                "uptime_s": self.uptime_s(),
                "requests": dict(self._requests),
                "errors": dict(self._errors),
                "latency": lat,
                "compute_backends": dict(self._backends),
            }
