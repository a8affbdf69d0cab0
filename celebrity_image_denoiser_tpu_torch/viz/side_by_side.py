"""Per-epoch visual spot-checks.

Port of ``celebrity_image_denoiser_tpu/viz/side_by_side.py``:
``combine_test_images:14`` (the reference's ``training.py:301-320``: noisy
and denoised side by side on a white canvas under "Noisy" / "Denoised"
labels, a PIL image) and ``triptych:42`` (the noisy / generated / clean
panels the esrgan and cgan trainers save, through matplotlib).  PIL and
matplotlib are imported on use.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def combine_test_images(noisy: np.ndarray, denoised: np.ndarray,
                        output_size: Tuple[int, int] = (256, 256)):
    """noisy / denoised: uint8 HWC arrays (or PIL images); returns a PIL
    image."""
    from PIL import Image, ImageDraw, ImageFont

    def to_pil(x):
        if isinstance(x, np.ndarray):
            return Image.fromarray(np.asarray(x, np.uint8))
        return x

    noisy_img = to_pil(noisy).resize(output_size, Image.Resampling.BICUBIC)
    denoised_img = to_pil(denoised).resize(output_size,
                                           Image.Resampling.BICUBIC)
    combined = Image.new("RGB", (output_size[0] * 2, output_size[1] + 30),
                         (255, 255, 255))
    combined.paste(noisy_img, (0, 30))
    combined.paste(denoised_img, (output_size[0], 30))
    draw = ImageDraw.Draw(combined)
    try:
        font = ImageFont.truetype("arial.ttf", 20)
    except Exception:
        font = ImageFont.load_default()
    draw.text((output_size[0] // 4, 5), "Noisy", fill=(0, 0, 0), font=font)
    draw.text((output_size[0] + output_size[0] // 4, 5), "Denoised",
              fill=(0, 0, 0), font=font)
    return combined


def triptych(noisy: np.ndarray, generated: np.ndarray, clean: np.ndarray,
             path: str) -> None:
    """Noisy / generated / clean 3-panel PNG at ``path``; inputs float
    [0, 1] HWC."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 3, figsize=(7.5, 2.5))
    for ax, img, title in zip(axs, (noisy, generated, clean),
                              ("Noisy", "Generated", "Clean")):
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    plt.tight_layout()
    fig.savefig(path)
    plt.close(fig)
