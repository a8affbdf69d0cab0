"""Requests arriving at a fixed rate (an open loop), each answered by the
server's request entry.

A generator hands one request every ``1 / rate_per_s`` seconds to a pool
of ``workers`` threads, as a threaded front end gives each upload a thread
of its own; a request that finds every worker busy waits for one.  Each
request calls ``ServeState.denoise_image(image, family)`` on a decoded
uint8 upload: the whole request path (the host's domain conversion, the
upload, the forward, the uint8 output map, the download and the host's
final uint8).  Its latency runs from the moment it was due to the uint8
result in host memory, so a stall counts against every request it delays.
Every seed has the same arrivals; the seed draws the images and their
order from a pool of distinct images.

Traffic keys: ``rate_per_s``, ``workers``, ``size``, ``pool`` (distinct
images), ``sigma`` (noise in [0, 1]), ``warm_requests`` (rounds of one
request per worker, after the server's own warm-up at the traffic's size).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import compare, gen


class State:
    def __init__(self, cell):
        cfg, tr = cell.config, cell.traffic
        self.cell = cell
        self.server = cell.make_server()
        family = cfg["family"]
        self.server.warmup(sizes=((tr["size"], tr["size"]),),
                           models=(family,))
        cell.check_rung(self.server)
        self.call = lambda image: self.server.denoise_image(image, family)
        self.u8 = gen.noisy_u8(cell.seed, tr["pool"], tr["size"],
                               tr["sigma"], cell.device)
        self.images = list(self.u8.cpu().numpy())
        self.order = np.random.default_rng([cell.seed, 2]).permutation(
            len(self.images))
        self.answers = []  # (pool index, served uint8 image)
        for _ in range(tr["warm_requests"]):
            now = time.perf_counter()
            self._serve([(now, int(i)) for i in self.order[:tr["workers"]]],
                        keep=False)

    def _serve(self, due, keep: bool) -> tuple:
        """Serve ``due``, a list of (due time, pool index) in time order, on
        the worker pool; returns (latencies, failures, the last answer's
        time)."""
        tasks = queue.Queue()
        lat, ends, failed = [], [], [0]
        lock = threading.Lock()

        def worker():
            while True:
                item = tasks.get()
                if item is None:
                    return
                t_due, idx = item
                try:
                    with record_function("client.request"):
                        y = self.call(self.images[idx])
                except Exception as e:  # counted; the run is not correct
                    self.cell.note_failure(e)
                    with lock:
                        failed[0] += 1
                    continue
                t = time.perf_counter()
                with lock:
                    lat.append(t - t_due)
                    ends.append(t)
                    if keep:
                        self.answers.append((idx, y))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.cell.traffic["workers"])]
        for t in threads:
            t.start()
        for t_due, idx in due:
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            tasks.put((t_due, idx))
        for _ in threads:
            tasks.put(None)
        for t in threads:
            t.join()
        return lat, failed[0], max(ends, default=time.perf_counter())

    def window(self, seconds: float) -> dict:
        """Requests due every 1 / rate seconds for ``seconds``."""
        rate = self.cell.traffic["rate_per_s"]
        n = max(1, int(seconds * rate))
        t0 = time.perf_counter() + 0.01
        due = [(t0 + k / rate, int(self.order[k % len(self.order)]))
               for k in range(n)]
        lat, failed, t_end = self._serve(due, keep=True)
        ms = np.asarray(lat) * 1e3
        # what was completed over the whole window, the wait for the last
        # answers included: below the rate where the server falls behind
        metrics = {"images_per_s": len(lat) / (t_end - t0)}
        if len(lat):
            metrics["latency_p50_ms"] = float(np.percentile(ms, 50))
            metrics["latency_p95_ms"] = float(np.percentile(ms, 95))
        return {"attempted": n, "failed": failed, "wall_s": t_end - t0,
                "images": len(lat), "requests": len(lat),
                "metrics": metrics}

    def release(self) -> None:
        self.server = self.call = None

    def substitute(self, fn) -> None:
        """``fn`` (uint8 NHWC images -> served uint8) in place of the timed
        call, one request at a time: a reference may set global state (as
        cuDNN's TF32 switch) for the length of its call."""
        lock = threading.Lock()
        device = self.cell.device

        def call(image):
            with lock:
                x = torch.from_numpy(image).unsqueeze(0).to(device)
                return fn(x)[0].cpu().numpy()
        self.call = call

    def compare(self, reference) -> dict:
        tally = compare.ImageTally()
        by_image = {}
        for idx, y in self.answers:
            by_image.setdefault(idx, []).append(y)
        for idx in sorted(by_image):
            ref = reference(self.u8[idx:idx + 1])
            got = torch.as_tensor(np.stack(by_image[idx])).to(ref.device)
            tally.add(got, ref.expand_as(got))
        return tally.numbers()
