"""Host→device input pipeline with prefetch overlap.

Port of ``celebrity_image_denoiser_tpu/data/pipeline.py::DataPipeline``
(:92-196): the same batching, ``default_rng(seed + epoch)`` shuffle,
drop-last top-up of skipped samples and bounded producer thread.  Where the
JAX pipeline stages batches with ``jax.device_put``, this one copies from
**pinned** host memory with ``non_blocking=True`` on a side stream, so batch
k+1 copies while step k runs; an event recorded after the copy makes the
consumer's stream wait for it, and the pinned buffer is kept until that event
has passed.

With ``use_native`` the batches are assembled by the port's C++ stage
(``data/native.py``), as in JAX: ``num_threads`` Python threads decode
(``dataset.raw``), then the library resizes and assembles each side of the
dataset's ``raw_batch_spec`` in its own thread pool — a float32 side
normalised to ``(x/255 - mean)/std``, or a uint8 side (mean None, the
clean images of the on-the-fly path) with ``native.resize_u8``'s rounding.

``rank`` of ``world`` is the counterpart of the JAX pipeline's
``sharding=`` (:48, :151), where the loader is the data-parallel boundary:
every rank shuffles with the same seed and assembles only its share of
each global batch of ``batch_size`` — samples ``rank·b .. (rank+1)·b − 1``
with ``b = batch_size / world`` — through the same stage (the native
assembly too), so the ranks' shares make up the global batch the
single-process pipeline yields.  A sample that fails to load is replaced
from the rank's own share (the single-process pipeline tops up from the
whole batch), so the two differ only where a file is unreadable.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data import native
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.data.pipeline")

_STOP = object()


class DataPipeline:
    """Iterates batches resident on ``device``.

    dataset: indexable returning sample | (a, b, ...) | None (skipped).
    Samples are numpy arrays; batches are stacked, then copied to the
    device into a bounded prefetch queue."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 device="cuda", num_threads: int = 2,
                 use_native: Optional[bool] = None, rank: int = 0,
                 world: int = 1):
        """``use_native``: assemble batches in the C++ stage when the
        dataset advertises a ``raw_batch_spec``.  None (the default) is
        auto: on when the library builds, with a log line naming the stage
        taken; True raises here, before the first batch, when the dataset
        has no spec (``ValueError``) or the library does not build
        (``RuntimeError``); False keeps the python path, whose resize is
        Pillow's bit for bit (the C++ bicubic stands within about 2 counts
        of it).  ``rank`` of ``world``: yield only this rank's share of
        each global batch of ``batch_size`` (which ``world`` must divide;
        ``drop_last`` only)."""
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if world > 1 and (batch_size % world or not drop_last):
            raise ValueError(f"a batch of {batch_size} shared by {world} "
                             "ranks must divide evenly, with drop_last")
        self.rank, self.world = rank, world
        self._spec = getattr(dataset, "raw_batch_spec", None)
        if use_native is None:
            use_native = self._spec is not None and native.available()
            logger.info("batch assembly: %s", "native C++ stage"
                        if use_native else "python")
        elif use_native:
            if self._spec is None:
                raise ValueError(
                    "use_native=True but the dataset exposes no "
                    "raw_batch_spec (needs raw() and fixed sizes)")
            try:
                native.load()
            except RuntimeError as e:
                raise RuntimeError(f"use_native=True but {e}") from e
        self.use_native = bool(use_native)
        self.num_threads = max(1, num_threads)
        self._pool = None  # the decode threads, made on first use
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

    @staticmethod
    def _top_up(samples: list, n: int) -> None:
        """Keep the batch size fixed: fill skipped slots by repeating loaded
        samples."""
        k = 0
        while len(samples) < n:
            samples.append(samples[k % len(samples)])
            k += 1

    def _load_batch_native(self, indices: Sequence[int]):
        """Decode in ``num_threads`` python threads, then resize and assemble
        each side in the C++ stage."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.num_threads)
        raws = [r for r in self._pool.map(
            lambda i: self.dataset.raw(int(i)), indices) if r is not None]
        if not raws:
            return None
        if self.drop_last and len(raws) < len(indices):
            self._top_up(raws, len(indices))
        sides = []
        for j, (hw, mean, std) in enumerate(self._spec):
            imgs = [(r[j] if isinstance(r, tuple) else r) for r in raws]
            if mean is None:
                sides.append(native.assemble_batch_u8(
                    imgs, hw, threads=self.num_threads))
            else:
                sides.append(native.assemble_batch(
                    imgs, hw, mean=mean, std=std, threads=self.num_threads))
        return tuple(sides) if len(sides) > 1 else sides[0]

    def _load_batch(self, indices: Sequence[int]):
        if self.use_native:
            return self._load_batch_native(indices)
        samples = []
        for i in indices:
            s = self.dataset[int(i)]
            if s is not None:  # warn-and-skip: the dataset already logged it
                samples.append(s)
        if not samples:
            return None
        if self.drop_last and len(samples) < len(indices):
            self._top_up(samples, len(indices))
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
            share = (end - start) // self.world
            bounds.append(idx[start + self.rank * share:
                              start + (self.rank + 1) * share])
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
