"""End-to-end quickstart of the port: synthetic faces → train → evaluate →
one denoised image → a ``.pth`` to serve.  The counterpart of
``examples/quickstart.py``; tiny sizes, so it takes seconds on the card.

    python -m celebrity_image_denoiser_tpu_torch.examples.quickstart \\
        --workdir runs/quickstart [--device cpu]

The five steps, in the JAX walkthrough's order:

1. 16 synthetic 64² "faces" (smooth 8×8 blocks) written as PNGs;
2. the denoise GAN trained for ``--epochs`` on them, the noise drawn on the
   device each step (``CleanImageDataset`` → ``DataPipeline`` →
   ``GANTrainer``), its history plotted (one warning without
   matplotlib);
3. the PSNR of the held-out split (the dataset's 20%) with variant-1 noise;
4. one denoised image written to disk;
5. the generator exported as ``weights/denoise_epoch_499.pth``, the file
   ``cli.serve --weights-dir`` loads.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.ckpt.export import save_pth
from celebrity_image_denoiser_tpu_torch.cli.train import plot_history
from celebrity_image_denoiser_tpu_torch.core.config import TrainConfig
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
from celebrity_image_denoiser_tpu_torch.data.datasets import CleanImageDataset
from celebrity_image_denoiser_tpu_torch.data.pipeline import DataPipeline
from celebrity_image_denoiser_tpu_torch.metrics import psnr
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseDiscriminator,
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import GANTrainer

SIZE = 64


def write_faces(clean_dir: str, n: int = 16) -> None:
    """``n`` smooth 64² images (8×8 random blocks, seed 0) as PNGs."""
    os.makedirs(clean_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        low = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        img = np.asarray(np.kron(low, np.ones((8, 8, 1))), dtype=np.uint8)
        imageio.imwrite(os.path.join(clean_dir, f"face{i}.png"), img)


def run(workdir: str, epochs: int = 2, device="cuda") -> dict:
    """The five steps; returns the history, the steps taken, the held-out
    PSNR and the written files."""
    dev = resolve_device(device)
    clean_root = os.path.join(workdir, "Clean_dataset")
    write_faces(os.path.join(clean_root, "person0"))
    print(f"[1/5] wrote 16 synthetic faces under {clean_root}/person0")

    ds = CleanImageDataset(clean_root, image_size=(SIZE, SIZE))
    cfg = TrainConfig(model="denoise", num_epochs=epochs, batch_size=4,
                      image_size=(SIZE, SIZE), on_the_fly_noise=True,
                      checkpoint_dir=os.path.join(workdir, "checkpoint"),
                      graph_dir=os.path.join(workdir, "graphs"),
                      test_image_dir=os.path.join(workdir, "testImage"))
    gen = torch.Generator().manual_seed(0)
    trainer = GANTrainer(DenoiseGenerator(generator=gen),
                         DenoiseDiscriminator(generator=gen),
                         DataPipeline(ds, cfg.batch_size, device=dev), cfg,
                         device=dev)
    history = trainer.train()
    plot_history(history, cfg.graph_dir)
    print(f"[2/5] trained {epochs} epochs; PSNR history: "
          f"{[round(p, 2) for p in history['psnr']]}")

    test = np.stack([ds.get_test(i) for i in range(min(4, len(
        ds.test_paths)))])
    noisy01, clean01, _ = noise_lib.random_noise_batch(
        torch.Generator(device=dev).manual_seed(1),
        torch.from_numpy(test).to(dev), variant=1, domain="unit")
    fake = torch.from_numpy(trainer.generate(
        (noisy01 * 2 - 1).cpu().numpy())).to(dev)
    f01 = (fake * 0.5 + 0.5).clamp(0, 1)
    held_out = float(psnr(f01, clean01, data_range=1.0).mean())
    print(f"[3/5] held-out denoised PSNR: {held_out:.2f} dB")

    image = os.path.join(workdir, "denoised_example.png")
    imageio.imwrite(image, (f01[0].cpu().numpy() * 255).astype(np.uint8))
    print(f"[4/5] wrote {image}")

    weights_dir = os.path.join(workdir, "weights")
    os.makedirs(weights_dir, exist_ok=True)
    pth = os.path.join(weights_dir, "denoise_epoch_499.pth")
    save_pth(trainer.generator, pth, key="generator")
    print(f"[5/5] serve it: python -m celebrity_image_denoiser_tpu_torch."
          f"cli.serve --weights-dir {weights_dir} --port 8000   # then open "
          "/ui")
    return {"history": history, "steps": trainer.steps, "psnr": held_out,
            "image": image, "pth": pth, "weights_dir": weights_dir}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when no card is present) or "
                         "cpu")
    args = ap.parse_args(argv)
    run(args.workdir, args.epochs, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
