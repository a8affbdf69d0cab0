"""Export a trained checkpoint to the reference's formats (counterpart of
``celebrity_image_denoiser_tpu/cli/export.py``; ``ckpt/export.py`` is the
library layer): a ``.pth`` under ``{key: state_dict}`` that the reference's
loaders read, or, for the Keras cGAN, a Keras 3 ``.keras`` zip.

    python -m celebrity_image_denoiser_tpu_torch.cli.export --model denoise \\
        --checkpoint checkpoint/denoise_epoch_19 --out denoise_epoch_499.pth
    python -m celebrity_image_denoiser_tpu_torch.cli.export --model cgan \\
        --checkpoint checkpoint/best/cgan_epoch_3 --format keras \\
        --out cgan.keras

The format rules are the JAX CLI's: ``.keras`` is the cGAN's format only,
and the Keras cGAN exports as ``.keras`` only (``--model cgan_torch`` is
the torch-layout cGAN).  Two refusals the JAX CLI lacks: a checkpoint whose
generator tree does not match ``--model``, and a model with BatchNorm whose
checkpoint has no ``generator_state`` section, each end in ``SystemExit``
before any file is written (the JAX CLI writes a ``.pth`` that the
reference's tolerant loader random-inits, or one with fresh BatchNorm
statistics).
"""

from __future__ import annotations

import argparse
import os

import torch

from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as ckpt_lib
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.ckpt import export as export_lib
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.cli.export")

_FAMILIES = ["denoise", "srgan", "esrgan", "dncnn", "cgan", "cgan_torch"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a native checkpoint to .pth / .keras")
    p.add_argument("--model", required=True, choices=_FAMILIES)
    p.add_argument("--checkpoint", required=True,
                   help="native npz checkpoint dir (a 'generator' section; "
                        "cli.train / cli.qat output)")
    p.add_argument("--out", required=True, help="output .pth / .keras path")
    p.add_argument("--format", default=None, choices=["pth", "keras"],
                   help="default: by --out extension (.pth / .keras)")
    p.add_argument("--key", default="generator",
                   choices=["generator", "state_dict", "G"],
                   help=".pth dict key (any of the reference loader's "
                        "accepted keys)")
    return p


def load_generator(model: str, checkpoint: str) -> torch.nn.Module:
    """The ``model`` generator with the checkpoint's weights, strictly:
    ``SystemExit`` for a missing section or a tree that does not fit."""
    sections, _ = ckpt_lib.load_checkpoint(checkpoint)
    if "generator" not in sections:
        raise SystemExit(f"{checkpoint} has no 'generator' section "
                         f"(found: {sorted(sections)})")
    module = registry.build_generator(model)
    has_bn = any(isinstance(m, torch.nn.BatchNorm2d)
                 for m in module.modules())
    if has_bn and not sections.get("generator_state"):
        raise SystemExit(
            f"{checkpoint} has no 'generator_state' section, and the "
            f"{model} generator has BatchNorm: its running statistics would "
            "be exported fresh (mean 0, var 1)")
    try:
        convert.load_jax_trees(module, sections["generator"],
                               sections.get("generator_state"))
    except (KeyError, ValueError) as e:
        raise SystemExit(f"{checkpoint} does not hold the {model} "
                         f"generator: {e}") from None
    return module


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    fmt = args.format or ("keras" if args.out.endswith(".keras") else "pth")
    if fmt == "keras" and args.model != "cgan":
        raise SystemExit(".keras export is the cGAN generator's format "
                         "(the reference only ever saves cgan as .keras); "
                         "use --format pth for the torch families")
    if fmt == "pth" and args.model == "cgan":
        raise SystemExit("the Keras cGAN exports as .keras only; for a "
                         "torch-loadable cGAN use --model cgan_torch")
    module = load_generator(args.model, args.checkpoint)
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    if fmt == "keras":
        export_lib.export_keras_cgan(module, args.out)
    else:
        export_lib.save_pth(module, args.out, key=args.key)
    logger.info("exported %s -> %s (%s)", args.checkpoint, args.out, fmt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
