"""Batch / iterative inference CLI (counterpart of
``celebrity_image_denoiser_tpu/cli/eval.py``).

* batch mode (the reference's ``denoisegan_eval.py:62-103``): load a
  checkpoint, walk a directory, resize each image to ``--image-size``
  (Pillow's bicubic, bit for bit), normalise, forward, denormalise, save;
* ``--iterations N`` (``denoise_eavl_iter.py:62-114``): feed the output back
  through the generator N times, saving every intermediate as
  ``<stem>_iter<k><ext>``;
* ``--clean-dir``: PSNR/SSIM of the last output against the clean image of
  the same relative path (``metrics/psnr_ssim.py``, on [0, 1]).

The checkpoint is a ``.pth`` (read as the server reads one: keys that fit
load, the rest keep their initialisation with a warning), a native npz
directory, or, without ``--checkpoint``, the shipped one
(``serve/handlers.py::_CKPT_CANDIDATES`` under ``default_weights_dir``); with
none of these a loud warning says the outputs are random-init noise.
Families: denoise, srgan, esrgan and dncnn.  The forward is the
generator's ``route="kernel"``: on the card the hand-written conv kernels
carry every 3×3 conv (K3 for the pairs, K2 for the single convs).

    python -m celebrity_image_denoiser_tpu_torch.cli.eval --model denoise \\
        --input-dir noisy/ --output-dir out/ --clean-dir clean/
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.ckpt.convert import (
    load_npz_state_dict,
    load_pth_state_dict,
)
from celebrity_image_denoiser_tpu_torch.core.config import (
    default_weights_dir,
)
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.metrics import psnr, ssim
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.cli.eval")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batch denoise a directory")
    p.add_argument("--model", default="denoise",
                   choices=["denoise", "srgan", "esrgan", "dncnn"])
    p.add_argument("--checkpoint", required=False,
                   help=".pth or native npz checkpoint dir (default: the "
                        "shipped weights/ checkpoint for the model; a loud "
                        "warning fires if none exists)")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--clean-dir", help="optional: compute PSNR/SSIM vs this")
    p.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--iterations", type=int, default=1,
                   help=">1 = iterative denoising, saves intermediates")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is present) or "
                        "cpu")
    return p


def _discover_checkpoint(name: str) -> Optional[str]:
    """The shipped checkpoint of ``name``, in the serving layout: the
    reference ``.pth`` name, else the native ``weights/<name>/`` npz dir."""
    from celebrity_image_denoiser_tpu_torch.serve.handlers import (
        _CKPT_CANDIDATES,
    )

    wd = default_weights_dir()
    fname = _CKPT_CANDIDATES.get(name, (None, None))[0]
    if fname and os.path.exists(os.path.join(wd, fname)):
        return os.path.join(wd, fname)
    npz_dir = os.path.join(wd, name)
    if os.path.isdir(npz_dir):
        return npz_dir
    return None


def load_model(name: str, checkpoint: Optional[str]) -> torch.nn.Module:
    """The ``name`` generator (seeded init) with the weights of
    ``checkpoint`` or the shipped ones, in eval mode on the CPU."""
    model = registry.build_generator(
        name, generator=torch.Generator().manual_seed(0))
    if not checkpoint:
        checkpoint = _discover_checkpoint(name)
        if checkpoint:
            logger.info("--checkpoint not given; using shipped %s",
                        checkpoint)
        else:
            logger.warning(
                "NO CHECKPOINT: --checkpoint not given and no shipped "
                "weights found for %r — outputs will be RANDOM-INIT noise, "
                "not denoised images.", name)
    if checkpoint:
        own = model.state_dict()
        if checkpoint.endswith(".pth"):
            sd = load_pth_state_dict(checkpoint)
        else:
            sd = load_npz_state_dict(checkpoint, module=model)
        fit = {k: v for k, v in sd.items()
               if k in own and own[k].shape == v.shape}
        for k in sorted(set(sd) - set(fit)):
            logger.warning("[%s] skipping %s from %s", name, k, checkpoint)
        model.load_state_dict(fit, strict=False)
    return model.eval()


def run(argv=None) -> Dict[str, object]:
    """Parse ``argv`` and evaluate; returns the outputs written, the mean
    PSNR/SSIM (None without ``--clean-dir``), the forwards run and the
    seconds spent in them."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = load_model(args.model, args.checkpoint).to(device)
    os.makedirs(args.output_dir, exist_ok=True)
    normalize = args.model in ("denoise", "srgan")

    paths = imageio.list_images(args.input_dir)
    psnrs, ssims, written, forwards, fwd_s = [], [], [], 0, 0.0
    for p in paths:
        try:
            arr = imageio.to_float01(imageio.imread_rgb(
                p, (args.image_size[1], args.image_size[0])))
        except Exception as e:
            logger.warning("skipping %s: %s", p, e)
            continue
        x = arr * 2 - 1 if normalize else arr
        rel = os.path.relpath(p, args.input_dir)
        stem, ext = os.path.splitext(rel)
        out01 = None
        for it in range(args.iterations):
            t0 = time.perf_counter()
            with torch.inference_mode():
                xt = torch.from_numpy(np.ascontiguousarray(x[None])).to(device)
                y = model(xt.permute(0, 3, 1, 2), route="kernel")
                y = y.permute(0, 2, 3, 1)[0].cpu().numpy()
            fwd_s += time.perf_counter() - t0
            forwards += 1
            out01 = (np.clip(y * 0.5 + 0.5, 0, 1) if normalize
                     else np.clip(y, 0, 1))
            suffix = f"_iter{it + 1}" if args.iterations > 1 else ""
            dst = os.path.join(args.output_dir,
                               f"{stem}{suffix}{ext or '.png'}")
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            imageio.imwrite(dst, (out01 * 255).astype(np.uint8))
            written.append(dst)
            x = out01 * 2 - 1 if normalize else out01
        if args.clean_dir:
            cpath = os.path.join(args.clean_dir, rel)
            if os.path.exists(cpath):
                clean = torch.from_numpy(imageio.to_float01(
                    imageio.imread_rgb(cpath, (out01.shape[1],
                                               out01.shape[0]))))
                o = torch.from_numpy(out01)
                psnrs.append(float(psnr(o, clean, data_range=1.0)))
                ssims.append(float(ssim(o, clean, data_range=1.0)))
    logger.info("wrote %d outputs to %s", len(paths), args.output_dir)
    result = {"outputs": written, "forwards": forwards,
              "forward_seconds": fwd_s, "psnr": None, "ssim": None}
    if psnrs:
        result.update(psnr=float(np.mean(psnrs)), ssim=float(np.mean(ssims)))
        logger.info("PSNR %.3f  SSIM %.4f (n=%d)", result["psnr"],
                    result["ssim"], len(psnrs))
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
