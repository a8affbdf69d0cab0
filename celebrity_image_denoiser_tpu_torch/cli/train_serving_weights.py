"""Train the serving checkpoints on the card: the port's counterpart of
``scripts/train_serving_weights.py``, with its flags and defaults.

    python -m celebrity_image_denoiser_tpu_torch.cli.train_serving_weights \\
        --family dncnn --steps 20000 --out runs/weights
    python -m celebrity_image_denoiser_tpu_torch.cli.train_serving_weights \\
        --family perceptual --steps 1500 --out runs/weights
    python -m celebrity_image_denoiser_tpu_torch.cli.train_serving_weights \\
        --family srgan --batch 16 --perceptual runs/weights/perceptual \\
        --out runs/weights

``--family perceptual`` trains the perceptual tower
(``train/serving.py::train_perceptual``), ``--qat-steps N`` fine-tunes an
existing checkpoint (``train/qat.py::qat_finetune``, as ``cli.qat``), and
anything else trains the family from scratch (``train_family``), writing
``<out>/<family>``.  ``--out`` has no default, so a run never overwrites
the shipped ``weights/`` unless it is named.  ``--device cpu`` is the only
way onto the host.
"""

from __future__ import annotations

import argparse
import os

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.train import qat, serving


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train the serving checkpoints on synthetic data")
    ap.add_argument("--family", required=True,
                    choices=["denoise", "dncnn", "srgan", "esrgan",
                             "perceptual"])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--pretrain-steps", type=int, default=None,
                    help="srgan only: pixel-MSE SRResNet pretrain steps "
                         "before the perceptual+adversarial stage; default "
                         "3x --steps for srgan, 0 otherwise")
    ap.add_argument("--pixel-anchor", type=float, default=1.0,
                    help="srgan stage-2 only: weight of the pixel-MSE term "
                         "added to the perceptual content loss (0 = the "
                         "reference's pure perceptual+adv loss)")
    ap.add_argument("--finetune-lr", type=float, default=None,
                    help="srgan stage-2 learning rate (default --lr / 4)")
    ap.add_argument("--pretrain-ckpt", default=None,
                    help="srgan only: cache dir for the stage-1 weights — "
                         "loaded when present, else trained and saved there")
    ap.add_argument("--ema", type=float, default=0.0,
                    help="srgan stage-2 only: EMA decay for an averaged copy "
                         "of G (e.g. 0.995); raw and EMA weights are both "
                         "evaluated and the better-PSNR one ships. 0 = off")
    ap.add_argument("--qat-steps", type=int, default=0,
                    help="quantization-aware fine-tune of the EXISTING "
                         "checkpoint instead of normal training")
    ap.add_argument("--qat-lr", type=float, default=2e-5,
                    help="QAT fine-tune learning rate")
    ap.add_argument("--qat-agree", type=float, default=2.0,
                    help="weight of the fakequant-vs-float agreement term")
    ap.add_argument("--init-from", default=None,
                    help="checkpoint dir the QAT fine-tune starts from "
                         "(default: <out>/<family>)")
    ap.add_argument("--chunk", type=int, default=50,
                    help="optimizer steps between host reads")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True,
                    help="weights directory the result is written into, as "
                         "<out>/<family>")
    ap.add_argument("--perceptual", default=None,
                    help="trained perceptual tower checkpoint dir (srgan; "
                         "default the shipped weights/perceptual)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when no card is present) or "
                         "cpu")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv`` and train; returns the trainer's result (the written
    meta, the chunk records and, for a family, the held-out reports)."""
    args = build_parser().parse_args(argv)
    if args.pretrain_steps is None:
        args.pretrain_steps = 3 * args.steps if args.family == "srgan" else 0
    if args.family == "perceptual":
        return serving.train_perceptual(args, resolve_device(args.device))
    if args.qat_steps > 0:
        qat.check_family(args.family)
        return qat.qat_finetune(
            family=args.family,
            init_from=args.init_from or os.path.join(args.out, args.family),
            out=args.out, qat_steps=args.qat_steps, qat_lr=args.qat_lr,
            qat_agree=args.qat_agree, chunk=args.chunk, batch=args.batch,
            size=args.size, seed=args.seed,
            device=resolve_device(args.device))
    return serving.train_family(args, resolve_device(args.device))


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
