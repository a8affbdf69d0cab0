#!/usr/bin/env python3
"""How many kernel records a ``torch.profiler`` window names, by how long
its process has profiled (one NVIDIA card).

    python3 profile_records_probe.py        (from the repo root, ~5 min)

One bf16 bench step of the denoise U-Net (batch 256, 128², random weights)
is profiled at 0, 30, 60, 120 and 240 s after the process's first profiler
session: bare (the step and a synchronise), padded (a synchronise and a
0.2 s host sleep on both sides of it), and bare in a fresh process.  Each
line gives the window's kernel records against its launch calls (the CUDA
runtime's records, which none of the windows lost) and the launch indexes
whose kernel record is missing.  ``chip_smoke.py`` runs its checked windows
in fresh processes because of what this shows (``PERF.md`` §6).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile


def records(prof) -> str:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"}
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "Launch" in str(e.get("name"))),
                      key=lambda e: e["ts"])
    missing = [i for i, e in enumerate(launches)
               if e["args"].get("correlation") not in kernels]
    return (f"{len(launches) - len(missing)} kernel records of "
            f"{len(launches)} launch calls; missing {missing}")


def window(step, pad_s: float) -> str:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad_s:
            torch.cuda.synchronize()
            time.sleep(pad_s)
        step()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
            torch.cuda.synchronize()
    return records(prof)


def main() -> int:
    from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
        DenoiseGenerator,
        serve_step,
    )
    from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        print("profile_records_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    _build.library()
    model = DenoiseGenerator(generator=torch.Generator().manual_seed(0))
    model = model.to(device="cuda").eval().to(torch.bfloat16)
    x = torch.randint(0, 256, (256, 128, 128, 3), dtype=torch.uint8,
                      device="cuda")

    def step():
        serve_step(model, x)

    step()
    torch.cuda.synchronize()
    if sys.argv[1:] == ["--fresh"]:
        print(window(step, 0.0), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    for at in (0, 30, 60, 120, 240):
        time.sleep(max(0.0, t0 + at - time.perf_counter()))
        print(f"{at:4d} s bare:   {window(step, 0.0)}", flush=True)
        print(f"{at:4d} s padded: {window(step, 0.2)}", flush=True)
        fresh = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--fresh"], capture_output=True, text=True)
        print(f"{at:4d} s a fresh process: {fresh.stdout.strip()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
