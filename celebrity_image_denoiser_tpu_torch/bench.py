"""Benchmark of the port: 128×128 face denoises/sec on one card.

    python -m celebrity_image_denoiser_tpu_torch.bench

Port of the repo's top-level ``bench.py`` for its bf16 step (:118-124): the
flagship serving step — uint8 → [-1,1] → U-Net → [0,1] → round → uint8,
``models.denoise_unet.serve_step`` — timed on a device-resident uint8 batch
of random pixels through a randomly initialised U-Net (seeded), with the
iterations chained (each consumes the previous output, :166-173) and the
run fenced by ``torch.cuda.synchronize()``.  The int8 rungs of the JAX
bench are not ported yet, and the unit string says so.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"};
``vs_baseline`` is against the same ``TARGET`` the JAX bench names.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseGenerator,
    serve_step,
)

METRIC = "128x128_denoises_per_sec_per_chip"
TARGET = 10_000.0  # the north-star constant of the JAX bench.py:39
BATCH = 2048  # the JAX bench's batch (bench.py:40)
N_ITERS = 12
SIZE = 128
SEED = 0


def run(batch: int = BATCH, device="cuda") -> dict:
    """Time ``N_ITERS`` chained bf16 serving steps at ``batch`` × 128²."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures the card: device must be CUDA")
    model = DenoiseGenerator(generator=torch.Generator().manual_seed(SEED))
    model = model.to(device=dev, dtype=torch.bfloat16).eval()
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(0, 256, size=(batch, SIZE, SIZE, 3),
                                      dtype=np.uint8)).to(dev)
    serve_step(model, x, device=dev)  # warm-up: kernel build and caches
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cur = x
    for _ in range(N_ITERS):
        cur = serve_step(model, cur, device=dev)  # chained: no elision
    torch.cuda.synchronize(dev)
    rate = N_ITERS * batch / (time.perf_counter() - t0)
    return {
        "metric": METRIC,
        "value": round(rate, 1),
        "unit": (f"images/sec [bf16 serving step, batch {batch}, "
                 f"{torch.cuda.get_device_name(dev)}; int8 not yet ported]"),
        "vs_baseline": round(rate / TARGET, 3),
    }


def main(batch: int = BATCH) -> dict:
    result = run(batch=batch)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
