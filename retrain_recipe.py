#!/usr/bin/env python3
"""Retrain the perceptual tower and dncnn at their shipped recipes with the
port, on the card, and hold the dncnn result against the shipped weights.

    python3 retrain_recipe.py --out runs/recipe \\
        [--tower-steps 1500] [--dncnn-steps 20000]

1. ``cli.train_serving_weights --family perceptual`` at the script's
   defaults and the shipped tower's 1500 steps: its ``final_mse`` beside
   ``weights/perceptual``'s;
2. ``cli.train_serving_weights --family dncnn`` at the shipped recipe
   (batch 32, 128², lr 2e-4, 20,000 steps);
3. the retrained and the shipped ``weights/dncnn`` on the same held-out
   draw (``train/qat.py::evaluate``: 16 images, seed 77, blind σ): the
   retrained gain must be at least ``SHIP_FRACTION`` (0.85) of the
   shipped one's.

Prints the card's name and power limit, then one JSON line (the last) with
each run's steps/s and wall time; exits 1 when the dncnn ratio is below
the fraction.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from celebrity_image_denoiser_tpu_torch.cli import train_serving_weights
from celebrity_image_denoiser_tpu_torch.core.config import default_weights_dir
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.train import qat


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"


def timed(argv) -> dict:
    t0 = time.perf_counter()
    res = train_serving_weights.run(argv)
    wall = time.perf_counter() - t0
    steps = res["meta"]["steps"]
    train_s = sum(c["seconds"] for c in res["chunks"])
    return {"meta": res["meta"], "steps": steps, "wall_s": wall,
            "steps_per_s": steps / train_s,
            "images_per_s": sum(c["images_per_s"] for c in res["chunks"])
            / len(res["chunks"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--tower-steps", type=int, default=1500)
    ap.add_argument("--dncnn-steps", type=int, default=20000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    common = ["--out", args.out, "--device", str(dev)]
    tower = timed(["--family", "perceptual", "--steps",
                   str(args.tower_steps)] + common)
    with open(os.path.join(default_weights_dir(), "perceptual",
                           "meta.json")) as f:
        shipped_tower = json.load(f)
    dncnn = timed(["--family", "dncnn", "--steps", str(args.dncnn_steps),
                   "--batch", "32", "--size", "128", "--lr", "2e-4"]
                  + common)
    gains = {}
    for name, src in (("retrained", os.path.join(args.out, "dncnn")),
                      ("shipped", os.path.join(default_weights_dir(),
                                               "dncnn"))):
        gen, _ = qat.load_generator("dncnn", src, dev)
        gains[name] = qat.evaluate("dncnn", gen, 128)
    ratio = gains["retrained"]["gain_db"] / gains["shipped"]["gain_db"]
    line = {"card": card, "torch": torch.__version__,
            "tower": {"final_mse": tower["meta"]["final_mse"],
                      "shipped_final_mse": shipped_tower["final_mse"],
                      **{k: tower[k] for k in ("steps", "steps_per_s",
                                               "images_per_s", "wall_s")}},
            "dncnn": {"heldout": gains, "ratio": ratio,
                      "ship_fraction": qat.SHIP_FRACTION,
                      "fixture_gain_db": dncnn["meta"]["fixture_gain_db"],
                      **{k: dncnn[k] for k in ("steps", "steps_per_s",
                                               "images_per_s", "wall_s")}}}
    print(json.dumps(line), flush=True)
    return 0 if ratio >= qat.SHIP_FRACTION else 1


if __name__ == "__main__":
    sys.exit(main())
