"""Training CLI of the port (counterpart of
``celebrity_image_denoiser_tpu/cli/train.py``).

  # on-the-fly noise over a clean dataset, on the card
  python -m celebrity_image_denoiser_tpu_torch.cli.train --model denoise \\
      --clean-dir Clean_dataset --image-size 256 256 --batch-size 16 \\
      --num-epochs 20

  # srgan ×4: 256² HR crops, 64² LR inputs, the shipped VGG tower
  python -m celebrity_image_denoiser_tpu_torch.cli.train --model srgan \\
      --clean-dir Clean_dataset --image-size 256 256 --sr-scale 4

  # resume from the newest checkpoint under --checkpoint-dir
  python -m celebrity_image_denoiser_tpu_torch.cli.train ... --resume

Every family trains: denoise, srgan, esrgan, cgan (the Keras generator and
discriminator, Keras Adam) and dncnn (no discriminator; the blind-σ
Gaussian unless ``--noise-variant`` is given).  srgan's content loss runs
on a torchvision VGG16 ``--vgg-pth``, else the shipped tower
(``weights/perceptual``), else random features with a loud warning.  The
flags are those of the JAX CLI that the port can honour.  Flags whose
machinery is not ported (``--no-on-the-fly``, ``--tensor-cache``,
``--extra-metrics``, ``--profile-dir``, ``--remat``, ``--graph-dir``, data
parallelism) are absent rather than accepted and ignored; ROADMAP.md queue
1 items 4-8 list them.
"""

from __future__ import annotations

import argparse

import torch

from celebrity_image_denoiser_tpu_torch.core.config import TrainConfig
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data.datasets import CleanImageDataset
from celebrity_image_denoiser_tpu_torch.data.pipeline import DataPipeline
from celebrity_image_denoiser_tpu_torch.metrics import PerceptualDistance
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
    FAMILIES,
    GANTrainer,
)
from celebrity_image_denoiser_tpu_torch.train.losses import (
    make_vgg_perceptual,
)
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.cli.train")


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
                        "model family (v1 denoise, v2 srgan/cgan, v3 "
                        "esrgan; dncnn: the blind-sigma Gaussian)")
    p.add_argument("--sr-scale", type=int, default=4,
                   help="srgan upscale factor (LR = image-size / scale)")
    p.add_argument("--vgg-pth", default=None,
                   help="torchvision vgg16 .pth for the srgan perceptual "
                        "loss; default: the shipped trained tower "
                        "(weights/perceptual) when present, else random "
                        "features with a loud warning")
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


def perceptual_loss(vgg_pth=None):
    """srgan's content loss (``cli/train.py:270-293`` of the JAX CLI): the
    torchvision tower of ``vgg_pth``, else ``PerceptualDistance.default()``
    (the shipped tower, else random features, with a warning)."""
    if vgg_pth:
        pd = PerceptualDistance.from_torchvision_pth(vgg_pth)
        logger.info("perceptual: torchvision VGG16 from %s", vgg_pth)
    else:
        pd = PerceptualDistance.default()
        if pd.pretrained:
            logger.info("perceptual: shipped trained tower "
                        "(weights/perceptual)")
        else:
            logger.warning(
                "perceptual: NO trained weights found — SRGAN's content "
                "loss will use RANDOM VGG features (pass --vgg-pth or ship "
                "weights/perceptual)")
    # the shipped tower was trained on [0, 1]; torchvision and random
    # towers keep the reference's unshifted feed
    return make_vgg_perceptual(pd.net, to_unit=pd.input_domain == "unit")


def build_modules(family, image_size, *, sr_scale=4, vgg_pth=None,
                  generator=None):
    """``(generator, discriminator or None, perceptual loss or None)`` of
    ``family`` at full width, as the JAX CLI builds them (:240-297): no
    discriminator for dncnn, esrgan's and cgan's sized for ``image_size``
    (their Linear widths depend on it), srgan ×``sr_scale`` with its
    content loss (``perceptual_loss``).  ``generator`` is the
    ``torch.Generator`` the initialisers draw from."""
    if family == "srgan":
        g = registry.build_generator("srgan", scale_factor=sr_scale,
                                     generator=generator)
    else:
        g = registry.build_generator(family, generator=generator)
    if family == "dncnn":
        d = None
    elif family in ("esrgan", "cgan"):
        d = registry.build_discriminator(family, input_hw=tuple(image_size),
                                         generator=generator)
    else:
        d = registry.build_discriminator(family, generator=generator)
    perceptual = perceptual_loss(vgg_pth) if family == "srgan" else None
    return g, d, perceptual


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
    dataset = CleanImageDataset(
        args.clean_dir, image_size=cfg.image_size,
        test_split=cfg.test_split, split_seed=cfg.split_seed)
    pipeline = DataPipeline(dataset, cfg.batch_size, shuffle=True,
                            seed=cfg.seed, drop_last=True, device=device)
    gen, disc, perceptual = build_modules(
        args.model, cfg.image_size, sr_scale=args.sr_scale,
        vgg_pth=args.vgg_pth,
        generator=torch.Generator().manual_seed(cfg.seed))
    trainer = GANTrainer(gen, disc, pipeline, cfg, family=args.model,
                         perceptual=perceptual, device=device)
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
