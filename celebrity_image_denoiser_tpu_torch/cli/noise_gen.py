"""Noisy-dataset renderer of the port (counterpart of
``celebrity_image_denoiser_tpu/cli/noise_gen.py``).

  python -m celebrity_image_denoiser_tpu_torch.cli.noise_gen \\
      --clean-dir Clean_dataset --out-dir Dataset_Noise --variant 1

Walks ``--clean-dir`` (a tree of ``<person>/<img>``), resizes each image to
``--image-size`` with Pillow's bicubic (``imageio.imread_rgb``, bit-exact),
applies every noise type of the chosen variant and writes
``<out-dir>/<noise_type>/<person>/<img>`` with the source's relative path
and extension, each pixel ``clip(x·255, 0, 255)`` truncated to uint8 as the
JAX renderer writes it.  With ``--lr-size`` (srgan's layout) the noisy side
is downscaled to the LR size by ``ops/resize.py``'s antialiased bicubic
(``jax.image.resize``'s function) and clean HR copies go to
``<out-dir>/clean_hr``.  Undecodable files are skipped with a warning,
never deleted.

The noise runs on the card: each (batch, type) is one launch of the noise
kernel (``ops/cuda/noise.py::noise_batch``) with every sample of that kind,
the uint8 batch in and the noisy batch on [0, 1] out, its stream's seed
drawn from the renderer's generator (seeded ``--seed``) on the device.
Variant 3's poisson takes the reference's per-image scale instead
(``data/noise.py::poisson_v3_exact``, ``torch.poisson`` per image), as the
JAX renderer does (:81-91).  ``--device cpu`` runs the kernel's plain
version.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data import imageio, noise
from celebrity_image_denoiser_tpu_torch.ops.cuda import noise as noise_kernel
from celebrity_image_denoiser_tpu_torch.ops.resize import resize
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.cli.noise_gen")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Render a noisy dataset to disk")
    p.add_argument("--clean-dir", default="Clean_dataset")
    p.add_argument("--out-dir", default="Dataset_Noise")
    p.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--variant", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("--types", nargs="+", default=list(noise.NOISE_TYPES),
                   choices=list(noise.NOISE_TYPES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr-size", type=int, nargs=2, default=None,
                   help="srgan mode (sr_ganNoise.py:45-104): write noisy "
                        "images downscaled to this LR size and clean HR "
                        "copies at --image-size into <out-dir>/clean_hr")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is present) or "
                        "cpu")
    return p


def _u8(x01: torch.Tensor) -> np.ndarray:
    """float [0, 1] → uint8 as the JAX renderer writes it:
    ``clip(x·255, 0, 255)`` truncated."""
    return torch.clamp(x01 * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()


def _write(out_dir: str, rel: str, img: np.ndarray) -> None:
    dst = os.path.join(out_dir, rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    imageio.imwrite(dst, img)


def render_type(gen: torch.Generator, batch_u8: torch.Tensor, kind: str,
                variant: int) -> torch.Tensor:
    """The noisy batch of one ``kind`` on [0, 1], float32 NHWC: one launch
    of ``noise_batch`` (every sample ``kind``, the seed drawn from ``gen``),
    or for variant 3's poisson ``poisson_v3_exact`` image by image."""
    dev = batch_u8.device
    if variant == 3 and kind == "poisson":
        img01 = batch_u8.to(torch.float32) / 255.0
        return torch.stack([noise.poisson_v3_exact(gen, img)
                            for img in img01])
    kinds = torch.zeros(batch_u8.shape[0], dtype=torch.int64, device=dev)
    noisy, _ = noise_kernel.noise_batch(kinds, noise.stream_seed(gen, dev),
                                        batch_u8, (kind,), variant, "unit")
    return noisy


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    paths = imageio.list_images(args.clean_dir)
    if not paths:
        logger.error("no images under %s", args.clean_dir)
        return 1
    gen = torch.Generator(device).manual_seed(args.seed)
    wh = (args.image_size[1], args.image_size[0])
    lr: Optional[tuple] = (None if args.lr_size is None
                           else tuple(args.lr_size))
    for start in range(0, len(paths), args.batch):
        imgs, rels = [], []
        for p in paths[start:start + args.batch]:
            try:
                imgs.append(imageio.imread_rgb(p, wh))
            except Exception as e:  # warn-and-skip; never delete sources
                logger.warning("skipping %s: %s", p, e)
                continue
            rels.append(os.path.relpath(p, args.clean_dir))
        if not imgs:
            continue
        host = np.stack(imgs)
        batch = torch.from_numpy(host).to(device)
        for kind in args.types:
            noisy = render_type(gen, batch, kind, args.variant)
            if lr is not None:
                noisy = resize(noisy, lr, "bicubic")
            for img, rel in zip(_u8(noisy), rels):
                _write(os.path.join(args.out_dir, kind), rel, img)
        if lr is not None:  # clean HR copies, as the JAX renderer makes them
            clean = np.clip(imageio.to_float01(host) * 255, 0, 255)
            for img, rel in zip(clean.astype(np.uint8), rels):
                _write(os.path.join(args.out_dir, "clean_hr"), rel, img)
        logger.info("processed %d/%d", min(start + args.batch, len(paths)),
                    len(paths))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
