"""Coalesced batches through the server's batched dispatch, back to back.

What ``serve/batching.py``'s micro-batcher runs once a batch has formed:
``ServeState._batched_dispatch(family)`` (the forward and the uint8 output
map on the card) and ``default_fence`` (one device-to-host copy of the
batch's uint8 output), one batch after the other.  The inputs are a pool of
distinct float batches on the device, in the serving domain, cycled in
order.

Traffic keys: ``batch``, ``size``, ``pool`` (distinct batches), ``sigma``
(noise in [0, 1]), ``keep_share`` (the share of batches whose output is
kept for the comparison, drawn from the seed; the first and the last are
always kept), ``warm_batches``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import compare, gen


class State:
    def __init__(self, cell):
        from celebrity_image_denoiser_tpu_torch.serve.batching import (
            default_fence,
        )

        cfg, tr = cell.config, cell.traffic
        self.cell = cell
        self.server = cell.make_server()
        family = cfg["family"]
        dispatch = self.server._batched_dispatch(family)
        cell.check_rung(self.server)
        # the timed call: one batch through the dispatch and the fence, each
        # in a span of its own for the traced window

        def call(xs):
            with record_function("bench.dispatch"):
                ys = dispatch(xs)
            with record_function("bench.fence"):
                return default_fence(ys)
        self.call = call
        b, n = tr["batch"], tr["pool"]
        self.u8 = gen.noisy_u8(cell.seed, n * b, tr["size"], tr["sigma"],
                               cell.device)
        self.pool = [gen.served_domain(self.u8[i * b:(i + 1) * b],
                                       cfg["domain"]) for i in range(n)]
        rng = np.random.default_rng([cell.seed, 1])
        self.keep_draws = rng.random(1 << 20) < tr["keep_share"]
        for i in range(tr["warm_batches"]):
            self.call(self.pool[i % n])
        self.kept = {}

    def window(self, seconds: float) -> dict:
        """Batches back to back until ``seconds`` have passed."""
        n = len(self.pool)
        b = self.cell.traffic["batch"]
        done = failed = 0
        last = None
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            k = i % n
            try:
                y = self.call(self.pool[k])
            except Exception as e:  # counted; the run is then not correct
                self.cell.note_failure(e)
                failed += b
            else:
                done += b
                if i == 0 or self.keep_draws[i % len(self.keep_draws)]:
                    self.kept.setdefault(k, []).append(y)
                last = (k, y)
            i += 1
            if time.perf_counter() >= deadline:
                break
        wall = time.perf_counter() - t0
        if last is not None and not any(y is last[1]
                                        for y in self.kept.get(last[0], [])):
            self.kept.setdefault(last[0], []).append(last[1])
        return {"attempted": done + failed, "failed": failed,
                "wall_s": wall, "images": done,
                "metrics": {"images_per_s": done / wall}}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.server = self.call = self.pool = None

    def _by_blocks(self, fn, k: int) -> torch.Tensor:
        """``fn`` over pool batch ``k``'s uint8 images, in blocks of the
        traffic's ``reference_block``."""
        b = self.cell.traffic["batch"]
        block = self.cell.traffic.get("reference_block", b)
        src = self.u8[k * b:(k + 1) * b]
        return torch.cat([fn(src[j:j + block]) for j in range(0, b, block)])

    def substitute(self, fn) -> None:
        """``fn`` (uint8 NHWC images -> served uint8) in place of the timed
        call, on the uint8 images of the batch it is handed."""
        index = {id(x): k for k, x in enumerate(self.pool)}
        self.call = lambda xs: self._by_blocks(fn, index[id(xs)]).cpu() \
            .numpy()

    def compare(self, reference) -> dict:
        tally = compare.ImageTally()
        for k in sorted(self.kept):
            ref = self._by_blocks(reference, k)
            for y in self.kept[k]:
                tally.add(torch.as_tensor(np.asarray(y)).to(ref.device), ref)
        return tally.numbers()
