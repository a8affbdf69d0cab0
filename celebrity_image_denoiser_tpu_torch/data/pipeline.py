"""Host→device input pipeline with prefetch overlap.

Port of ``celebrity_image_denoiser_tpu/data/pipeline.py::DataPipeline``
(:92-196): the same batching, ``default_rng(seed + epoch)`` shuffle,
drop-last top-up of skipped samples and bounded producer thread.  Where the
JAX pipeline stages batches with ``jax.device_put``, this one copies from
**pinned** host memory with ``non_blocking=True`` on a side stream, so batch
k+1 copies while step k runs; an event recorded after the copy makes the
consumer's stream wait for it, and the pinned buffer is kept until that event
has passed.  The native C++ batch assembly is not ported (``use_native``
raises if asked for).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device

_STOP = object()


class DataPipeline:
    """Iterates batches resident on ``device``.

    dataset: indexable returning sample | (a, b, ...) | None (skipped).
    Samples are numpy arrays; batches are stacked, then copied to the
    device into a bounded prefetch queue."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 device="cuda", use_native: Optional[bool] = None):
        if use_native:
            raise NotImplementedError(
                "the native C++ batch assembly is not ported yet "
                "(ROADMAP.md queue 1 item 10)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self._epoch = 0
        self._copy_stream = None  # made on first use, on the card only

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    # -- host-side batch assembly -------------------------------------------
    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _load_batch(self, indices: Sequence[int]):
        samples = []
        for i in indices:
            s = self.dataset[int(i)]
            if s is not None:  # warn-and-skip: the dataset already logged it
                samples.append(s)
        if not samples:
            return None
        if self.drop_last and len(samples) < len(indices):
            # keep the batch size fixed: top up skipped slots by repeating
            # loaded samples
            k = 0
            while len(samples) < len(indices):
                samples.append(samples[k % len(samples)])
                k += 1
        if isinstance(samples[0], tuple):
            return tuple(np.stack([s[j] for s in samples])
                         for j in range(len(samples[0])))
        return np.stack(samples)

    def _put(self, batch):
        """numpy batch (or tuple) → (device batch, copy-done event or None,
        pinned host buffers)."""
        arrays = batch if isinstance(batch, tuple) else (batch,)
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if self.device.type == "cpu":
            dev, event, pinned = host, None, []
        else:
            pinned = [t.pin_memory() for t in host]
            with torch.cuda.stream(self._copy_stream):
                dev = [t.to(self.device, non_blocking=True) for t in pinned]
                event = torch.cuda.Event()
                event.record(self._copy_stream)
        out = tuple(dev) if isinstance(batch, tuple) else dev[0]
        return out, event, pinned

    # -- iteration ------------------------------------------------------------
    def __iter__(self) -> Iterator:
        idx = self._indices()
        self._epoch += 1
        n = len(idx)
        bounds = []
        for start in range(0, n, self.batch_size):
            end = min(start + self.batch_size, n)
            if end - start < self.batch_size and self.drop_last:
                break
            bounds.append(idx[start:end])
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in bounds:
                    batch = self._load_batch(b)
                    if batch is None:
                        continue
                    # copy here, so H2D for batch k+1 overlaps step k
                    if not offer(self._put(batch)):
                        return
            except Exception as e:  # surfaced on the consumer side
                offer(e)
            finally:
                offer(_STOP)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        in_flight = []  # (event, pinned buffers) of copies not yet done
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, event, pinned = item
                if event is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(event)
                    for b in (batch if isinstance(batch, tuple) else (batch,)):
                        b.record_stream(current)
                    in_flight = [(e, p) for e, p in in_flight
                                 if not e.query()]
                    in_flight.append((event, pinned))
                yield batch
        finally:
            stop.set()  # a consumer that stops early releases the producer
            t.join(timeout=30)
            for event, _ in in_flight:
                event.synchronize()
