"""Request micro-batching: concurrent same-shape requests share one forward.

Port of ``celebrity_image_denoiser_tpu/serve/batching.py``.  Each request is
a batch-1 forward; coalescing concurrent ones into one device batch lets
the card do one launch per layer where it would do many.

* Requests queue per (model, padded shape) key.  The thread that makes the
  queue non-empty becomes the *leader*: it waits up to ``window_ms``
  (returning at once when a full batch has arrived), takes a device slot,
  drains everything queued and runs it in chunks of ``max_batch``; the
  others (*followers*) wait for their result.
* Batches pad to the next power of two (1, 2, 4, 8, …, capped at
  ``max_batch``), repeating the last request, so a server warms
  O(log max_batch) batch sizes per shape instead of one per occupancy.
* One chunk's failure fails only that chunk's waiters; a ``BaseException``
  in the forward marks the chunk's waiters failed before they wake, and a
  leader that dies outside ``_run`` fails everything it was responsible
  for.  Nothing is retried elsewhere.
* Off by default (no added latency): ``ServeState(microbatch_window_ms=...)``
  or ``cli.serve --microbatch-ms``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from celebrity_image_denoiser_tpu_torch.utils.profiling import span


def _pow2_at_least(n: int, cap: int) -> int:
    p = 1
    while p < n and p < cap:
        p *= 2
    return min(p, cap)


def default_fence(ys):
    """Fence and fetch: the finished batch as host numpy, by one
    device-to-host copy of the whole (uint8) output.

    PyTorch launches asynchronously: without a fence the leader returns as
    soon as the batch is queued, no queue of requests ever builds, and the
    window is the only way two requests meet.  Copying the output inside
    the device slot blocks the leader until the batch is done, so arrivals
    pile up in ``pending`` meanwhile and the next leader takes them all:
    the batch size adapts to the service time.  The copy is the bytes the
    waiters need anyway, as one transfer instead of one per request.  Runs
    in the span ``cid.batch.fence``."""
    with span("cid.batch.fence"):
        if isinstance(ys, torch.Tensor):
            return ys.cpu().numpy()
        return ys  # a test's fake forward


class MicroBatcher:
    """Coalesce concurrent single-image forwards into device batches.

    ``fn(xs)`` must take a batch along axis 0 and treat its samples
    independently (true of an eval-mode forward).  Call with ``x`` of shape
    (1, H, W, C), a tensor; returns the (1, ...) slice of the batch's
    output (host numpy behind the default fence)."""

    def __init__(self, fn: Callable, window_ms: float = 3.0,
                 max_batch: int = 16,
                 slot: Optional[threading.Semaphore] = None,
                 fence: Optional[Callable] = None):
        # validated here: waiters block without a deadline on the leader, so
        # a leader must never fail for a configuration reason
        if not (window_ms >= 0):
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.fn = fn
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        # ``slot`` bounds the batches in flight (shared across a pool) and
        # ``fence`` blocks on completion inside it: the backpressure that
        # makes the batch size follow the load.  The leader takes the slot
        # BEFORE draining, so what arrived while the previous batch ran
        # rides this one.
        self.slot = slot
        self.fence = fence
        self.lock = threading.Lock()
        self.pending = []  # boxes: {x, ev, y | err}
        self._full = threading.Event()  # set while a full batch waits
        self.batches_run = 0
        self.requests_served = 0

    def __call__(self, x):
        box = {"x": x, "ev": threading.Event()}
        with self.lock:
            self.pending.append(box)
            leader = len(self.pending) == 1
            if len(self.pending) >= self.max_batch:
                self._full.set()
        if leader:
            batch = []
            try:
                self._full.wait(self.window_s)
                with self.slot or contextlib.nullcontext():
                    with self.lock:
                        batch = self.pending
                        self.pending = []
                        self._full.clear()
                    self._run(batch)
            except BaseException as e:
                # fail what this leader was responsible for: its drained
                # batch or, if it died before draining, the pending epoch
                # (only here: in normal flow a successor leader may already
                # own the new pending list)
                with self.lock:
                    stranded = batch or self.pending
                    if not batch:
                        self.pending = []
                    self._full.clear()
                for b in stranded:
                    if not b["ev"].is_set():
                        b["err"] = e
                        b["ev"].set()
                raise
        # no deadline: the leader sets every event, and a first launch at a
        # new batch shape may build the kernels (nvcc) first
        box["ev"].wait()
        if "err" in box:
            raise box["err"]
        return box["y"]

    def _run(self, batch):
        for start in range(0, len(batch), self.max_batch):
            chunk = batch[start:start + self.max_batch]
            try:
                n = len(chunk)
                padded = _pow2_at_least(n, self.max_batch)
                xs = torch.cat([b["x"] for b in chunk]
                               + [chunk[-1]["x"]] * (padded - n), dim=0)
                ys = self.fn(xs)
                if self.fence is not None:
                    ys = self.fence(ys)
                with self.lock:
                    self.batches_run += 1
                    self.requests_served += n
                for i, b in enumerate(chunk):
                    b["y"] = ys[i:i + 1]
            except Exception as e:  # this chunk's waiters only: earlier
                # chunks' results are computed and valid
                for b in chunk:
                    b["err"] = e
            finally:
                for b in chunk:
                    # a BaseException in fn skips the handler above; a
                    # waiter woken with neither result would KeyError
                    if "y" not in b and "err" not in b:
                        b["err"] = RuntimeError(
                            "micro-batch chunk aborted by BaseException "
                            "in the batched forward")
                    b["ev"].set()


class BatcherPool:
    """One ``MicroBatcher`` per (model, input shape) key, all sharing one
    device slot: ``max_inflight`` batches at a time (default 2: one running
    while the next is prepared, without undoing the backpressure)."""

    def __init__(self, window_ms: float, max_batch: int = 16,
                 max_inflight: int = 2):
        # validated when the server starts, not on a first request, where
        # the handler would turn it into 500s
        if not (window_ms >= 0):
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.window_ms = window_ms
        self.max_batch = max_batch
        self._slot = threading.BoundedSemaphore(max_inflight)
        self._lock = threading.Lock()
        self._batchers: Dict[Tuple, MicroBatcher] = {}

    def get(self, key: Tuple, fn: Callable) -> MicroBatcher:
        with self._lock:
            b = self._batchers.get(key)
            if b is None:
                b = self._batchers[key] = MicroBatcher(
                    fn, self.window_ms, self.max_batch,
                    slot=self._slot, fence=default_fence)
            return b

    def stats(self) -> dict:
        with self._lock:
            return {
                str(k): {"batches": b.batches_run,
                         "requests": b.requests_served}
                for k, b in self._batchers.items()
            }
