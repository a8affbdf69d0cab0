"""Quantization-aware fine-tune CLI (``train/qat.py``): the port's
counterpart of ``scripts/train_serving_weights.py --qat-steps``.

    python -m celebrity_image_denoiser_tpu_torch.cli.qat --family esrgan \\
        --qat-steps 3000 --init-from weights/esrgan --out runs/qat

writes ``<out>/<family>`` (``arrays.npz`` and ``meta.json``) unless the
ship guard refuses, then records the served fixture gain there.  ``--out``
has no default: the caller names it.
"""

from __future__ import annotations

import argparse
import os

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.train import qat


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Quantization-aware fine-tune of a trained generator")
    p.add_argument("--family", required=True,
                   choices=["denoise", "dncnn", "srgan", "esrgan", "cgan"])
    p.add_argument("--qat-steps", type=int, default=3000)
    p.add_argument("--qat-lr", type=float, default=2e-5,
                   help="fine-tune learning rate (gentle: the goal is "
                        "re-conditioning, not re-learning)")
    p.add_argument("--qat-agree", type=float, default=2.0,
                   help="weight of the fakequant-vs-float agreement term")
    p.add_argument("--init-from", default=None,
                   help="checkpoint dir to start from (default: "
                        "<out>/<family>)")
    p.add_argument("--chunk", type=int, default=50,
                   help="optimizer steps between host reads")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True,
                   help="weights directory the result is written into, as "
                        "<out>/<family>")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is present) or "
                        "cpu")
    return p


def run(argv=None) -> dict:
    """Parse ``argv`` and fine-tune; returns ``qat_finetune``'s result."""
    args = build_parser().parse_args(argv)
    qat.check_family(args.family)
    device = resolve_device(args.device)
    return qat.qat_finetune(
        family=args.family,
        init_from=args.init_from or os.path.join(args.out, args.family),
        out=args.out, qat_steps=args.qat_steps, qat_lr=args.qat_lr,
        qat_agree=args.qat_agree, chunk=args.chunk, batch=args.batch,
        size=args.size, seed=args.seed, device=device)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
