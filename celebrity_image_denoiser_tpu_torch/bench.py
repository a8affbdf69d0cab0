"""Benchmark of the port: 128×128 face denoises/sec on one card.

    python -m celebrity_image_denoiser_tpu_torch.bench

Port of the repo's top-level ``bench.py`` (:105-209): the flagship serving
step — uint8 → [-1,1] → U-Net → [0,1] → round → uint8 — timed on a
device-resident uint8 batch of random pixels through a randomly initialised
U-Net (seeded), with the iterations chained (each consumes the previous
output, :166-173) and the run fenced by ``torch.cuda.synchronize()``.

The bf16 step (``models.denoise_unet.serve_step``) is measured always.  Then
the int8 rungs, in order — ``int8-s8skip`` (``ops/quant_unet.py``, the s8
skip-storage program) and ``int8-generic`` (``ops/quant.py`` with bias
correction) — each calibrated on ``data/synthetic.py::calibration_batch``
(the served program's recipe) and each behind the serving quality bar: its
u8 pixels must agree with the bf16 step's on ``x[:8]`` at ≥ 40 dB.  The
first rung that passes is measured, and the line reports the faster of it
and bf16; the unit names the rung, its dB and the bf16 rate, as the JAX
bench's note does.  A rung's builder may refuse the model (``ValueError``,
the next rung is tried); a kernel error propagates.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"};
``vs_baseline`` is against the same ``TARGET`` the JAX bench names.
"""

from __future__ import annotations

import copy
import json
import math
import time

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    calibration_batch,
)
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    _BF16_2_OVER_255,
    DenoiseGenerator,
    serve_step,
)
from celebrity_image_denoiser_tpu_torch.ops import quant, quant_unet

METRIC = "128x128_denoises_per_sec_per_chip"
TARGET = 10_000.0  # the north-star constant of the JAX bench.py:39
BATCH = 2048  # the JAX bench's batch (bench.py:40)
N_ITERS = 12
SIZE = 128
SEED = 0
GATE_DB = 40.0  # u8 agreement with the bf16 step (bench.py:147-164)
PROBE = 8  # images of the agreement probe


@torch.inference_mode()
def int8_step(qapply, x_uint8: torch.Tensor) -> torch.Tensor:
    """The JAX bench's int8 step (:126-138): uint8 NHWC → bf16 [-1, 1] →
    the int8 forward → clip(y·0.5+0.5) → round → uint8 NHWC."""
    x = x_uint8.to(torch.bfloat16) * _BF16_2_OVER_255 - 1.0
    y = qapply(x)
    y01 = torch.clamp(y * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(y01 * 255.0).to(torch.uint8)


def agreement_db(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return 10.0 * math.log10(255.0 ** 2 / max(mse, 1e-9))


def measure(step, x: torch.Tensor) -> float:
    """images/s of ``N_ITERS`` chained steps after one warm-up step."""
    step(x)
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    cur = x
    for _ in range(N_ITERS):
        cur = step(cur)  # chained: no elision
    torch.cuda.synchronize(x.device)
    return N_ITERS * x.shape[0] / (time.perf_counter() - t0)


def run(batch: int = BATCH, device="cuda"):
    """Measure the bf16 step and the int8 ladder at ``batch`` × 128².
    Returns (the JSON line's dict, one record per rung tried)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures the card: device must be CUDA")
    model = DenoiseGenerator(generator=torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()  # f32 master weights: calibration
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(0, 256, size=(batch, SIZE, SIZE, 3),
                                      dtype=np.uint8)).to(dev)

    def bf16_step(t):
        return serve_step(model_bf16, t, device=dev)

    probe = x[:PROBE]
    y_ref = bf16_step(probe)
    rate_bf16 = measure(bf16_step, x)

    calib = calibration_batch(True).to(dev)  # the served program's batch
    builders = (
        ("int8-s8skip",
         lambda: quant_unet.quantize_apply_denoise_unet(model, calib)),
        ("int8-generic",
         lambda: quant.quantize_apply(model, calib, bias_correct=True)))
    rungs = []
    chosen = None
    for name, build in builders:
        try:
            qapply = build()
        except ValueError as e:
            rungs.append({"rung": name, "built": False, "error": str(e)})
            continue
        db = agreement_db(int8_step(qapply, probe), y_ref)
        rec = {"rung": name, "built": True, "db": db, "rate": None}
        rungs.append(rec)
        if db >= GATE_DB:
            rec["rate"] = measure(lambda t, q=qapply: int8_step(q, t), x)
            chosen = rec
            break

    if chosen is not None and chosen["rate"] > rate_bf16:
        rate = chosen["rate"]
        note = (f"{chosen['rung']} ({chosen['db']:.0f} dB vs bf16; bf16 "
                f"{rate_bf16:.0f}/s)")
    elif chosen is not None:
        rate = rate_bf16
        note = (f"bf16 ({chosen['rung']} slower: {chosen['rate']:.0f}/s, "
                f"{chosen['db']:.0f} dB)")
    else:
        rate = rate_bf16
        note = "bf16 (" + "; ".join(
            f"{r['rung']}: " + (f"gate FAILED {r['db']:.0f} dB" if r["built"]
                                else "builder failed")
            for r in rungs) + ")"
    result = {
        "metric": METRIC,
        "value": round(rate, 1),
        "unit": (f"images/sec [{note}; batch {batch}, "
                 f"{torch.cuda.get_device_name(dev)}]"),
        "vs_baseline": round(rate / TARGET, 3),
    }
    rungs.insert(0, {"rung": "bf16", "built": True, "db": None,
                     "rate": rate_bf16})
    return result, rungs


def main(batch: int = BATCH):
    result, rungs = run(batch=batch)
    print(json.dumps(result), flush=True)
    return result, rungs


if __name__ == "__main__":
    main()
