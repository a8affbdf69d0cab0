#!/usr/bin/env python3
"""Restormer's benchmark cell on one NVIDIA card: the planted faults through
the benchmark's own run, and the cell's rate sweep.

    python3 scripts/restormer_card.py faults|sweep [options]

from the repo root, on a machine with one CUDA card.  The kernels' checks
and times are ``chip_smoke.py``'s phase 4g (``--restormer-only``).

* ``faults`` — ``harness.run`` of ``restormer.requests1024`` with each
  planted fault of ``models/restormer_faults.py`` in the served model (the
  temperature left out, k's normalisation left out, GELU in its tanh form,
  one head's attention on another head's v, LayerNorm's row scale left out
  of the 1×1 convs that fold it), each of which must read
  ``correct: false``; and the sound program, which must read ``correct:
  true``.  Exits 1 where one does not.
* ``sweep`` — the cell's request loop at each of ``--rates`` for
  ``--seconds``: completed requests a second, p50 and p95, peak memory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

WORKLOAD = "restormer.requests1024"


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def phase_faults(args) -> int:
    from celebrity_image_denoiser_tpu_torch.models import restormer_faults
    from port_bench import harness

    say(f"{card_line()}; {WORKLOAD} for {args.seconds} s a run, overrides "
        f"{args.overrides}")
    overrides = json.loads(args.overrides)
    server = []

    def one_server(cell):
        if not server:
            server.append(cell.make_server())
        cell.make_server = lambda: server[0]

    failed = 0
    for i, name in enumerate([None, *restormer_faults.FAULTS]):
        with restormer_faults.planted(name):
            r = harness.run(WORKLOAD, args.seed + i, args.seconds, False,
                            time.perf_counter(), overrides=overrides,
                            prepare=one_server)
        ok = r["correct"] is (name is None)
        failed += not ok
        say(f"  {'ok  ' if ok else 'FAIL'} {name or 'sound'}: correct "
            f"{r['correct']}, worst_image_mad "
            f"{r['_numbers']['worst_image_mad']:.6g} (limit "
            f"{r['_checks']['worst_image_mad']['limit']}), "
            f"{r['_numbers']['images_compared']} images, failed "
            f"{r['failed']}")
    return 1 if failed else 0


def phase_sweep(args) -> int:
    from port_bench import harness

    say(f"{card_line()}; {WORKLOAD}, {args.seconds} s a rate")
    cell = harness.Cell(harness.load_benchmark(), WORKLOAD, args.seed, "cuda")
    state = cell.loop().State(cell)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell.traffic["rate_per_s"] = rate
        state.answers = []
        torch.cuda.reset_peak_memory_stats()
        work = state.window(args.seconds)
        m = work["metrics"]
        say(json.dumps({"rate_per_s": rate, "completed_per_s":
                        m["images_per_s"], "p50_ms": m.get("latency_p50_ms"),
                        "p95_ms": m.get("latency_p95_ms"),
                        "requests": work["requests"],
                        "failed": work["failed"],
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("phase", choices=("faults", "sweep"))
    p.add_argument("--seed", type=int, default=2 ** 31 + 1234)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--rates", default="3,4,5,6,7")
    p.add_argument("--overrides", default='{"pool": 8}')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        say("no CUDA device")
        return 2
    return {"faults": phase_faults, "sweep": phase_sweep}[args.phase](args)


if __name__ == "__main__":
    sys.exit(main())
