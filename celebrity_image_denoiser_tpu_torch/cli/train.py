"""Training CLI of the port (counterpart of
``celebrity_image_denoiser_tpu/cli/train.py``).

  # on-the-fly noise over a clean dataset, on the card
  python -m celebrity_image_denoiser_tpu_torch.cli.train --model denoise \\
      --clean-dir Clean_dataset --image-size 256 256 --batch-size 16 \\
      --num-epochs 20

  # resume from the newest checkpoint under --checkpoint-dir
  python -m celebrity_image_denoiser_tpu_torch.cli.train ... --resume

The flags are those of the JAX CLI that this slice can honour.  Flags whose
machinery is not ported (``--no-on-the-fly``, ``--tensor-cache``,
``--extra-metrics``, ``--profile-dir``, ``--vgg-pth``, ``--remat``,
``--sr-scale``, ``--graph-dir``, data parallelism) are absent rather than
accepted and ignored; ROADMAP.md queue 1 items 9-14 list them.
"""

from __future__ import annotations

import argparse

import torch

from celebrity_image_denoiser_tpu_torch.core.config import TrainConfig
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data.datasets import CleanImageDataset
from celebrity_image_denoiser_tpu_torch.data.pipeline import DataPipeline
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseDiscriminator,
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
    FAMILIES,
    GANTrainer,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a GAN family on an NVIDIA card")
    p.add_argument("--model", default="denoise", choices=list(FAMILIES))
    p.add_argument("--clean-dir", default="Clean_dataset")
    p.add_argument("--num-epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--checkpoint-dir", default="checkpoint")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-variant", type=int, default=None,
                   choices=[1, 2, 3],
                   help="default: the variant the reference uses for the "
                        "model family (v1 for denoise); 2 and 3 are not "
                        "ported yet")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 (default): model forward and backward in "
                        "bf16 with float32 accumulation; parameters, "
                        "optimiser state, losses and metrics stay float32. "
                        "float32: the reference's numeric behaviour")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is present) or "
                        "cpu")
    return p


def build_trainer(args) -> GANTrainer:
    """The trainer that ``run`` and ``main`` train."""
    device = resolve_device(args.device)
    cfg = TrainConfig(
        model=args.model,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        image_size=tuple(args.image_size),
        lr=args.lr,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        on_the_fly_noise=True,
        noise_variant=args.noise_variant,
        compute_dtype=args.compute_dtype,
    )
    if args.model != "denoise":
        raise NotImplementedError(
            f"the {args.model} family is not ported yet (ROADMAP.md queue 1 "
            "item 11)")
    dataset = CleanImageDataset(
        args.clean_dir, image_size=cfg.image_size,
        test_split=cfg.test_split, split_seed=cfg.split_seed)
    pipeline = DataPipeline(dataset, cfg.batch_size, shuffle=True,
                            seed=cfg.seed, drop_last=True, device=device)
    init = torch.Generator().manual_seed(cfg.seed)
    trainer = GANTrainer(DenoiseGenerator(generator=init),
                         DenoiseDiscriminator(generator=init), pipeline, cfg,
                         family=args.model, device=device)
    if args.resume:
        trainer.resume()
    return trainer


def run(argv=None) -> GANTrainer:
    """Parse ``argv``, train, and return the trainer."""
    trainer = build_trainer(build_parser().parse_args(argv))
    trainer.train()
    return trainer


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
