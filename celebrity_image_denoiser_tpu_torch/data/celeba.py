"""CelebA-domain preprocessing of the port (counterpart of
``celebrity_image_denoiser_tpu/data/celeba.py``).

The reference's data domain is celebrity face crops (its tree is
``Clean_dataset/<person>/<img>`` of pre-cropped faces).  These helpers make
that tree from raw CelebA-style images: the aligned CelebA frame is
178×218, and the usual face crop takes the centre 178×178 and resizes it to
the model's resolution with Pillow's bicubic (``imageio.resize_u8``, bit
for bit; no Pillow needed for PNG files).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.data.celeba")


def center_face_crop(img: np.ndarray) -> np.ndarray:
    """Centre-square crop (the 178×218 → 178×178 CelebA convention, for any
    aspect ratio)."""
    h, w = img.shape[:2]
    side = min(h, w)
    top = (h - side) // 2
    left = (w - side) // 2
    return img[top:top + side, left:left + side]


def prepare_clean_dataset(raw_dir: str, out_dir: str,
                          image_size: Tuple[int, int] = (256, 256),
                          person_from_parent: bool = True,
                          limit: Optional[int] = None) -> int:
    """Raw images → ``<out_dir>/<person>/<img>.png`` at the model's
    resolution (centre face crop, then bicubic resize to ``image_size`` =
    (h, w)).  ``person_from_parent`` keeps the immediate parent directory as
    the identity folder; files directly under ``raw_dir`` (and every file
    without it) land under ``person0``.  A name taken already gets ``_1``,
    ``_2``, … (face.jpg and face.png must not collide).  Undecodable files
    are skipped with a warning.  Returns the number of images written."""
    paths = imageio.list_images(raw_dir)
    if limit is not None:
        paths = paths[:limit]
    count = 0
    size = (image_size[1], image_size[0])
    for p in paths:
        try:
            img = imageio.imread_rgb(p)
        except Exception as e:  # skip-and-report
            logger.warning("skipping %s: %s", p, e)
            continue
        img = center_face_crop(img)
        person = (os.path.basename(os.path.dirname(p))
                  if person_from_parent else "person0")
        if os.path.abspath(os.path.dirname(p)) == os.path.abspath(raw_dir):
            person = "person0"
        stem = os.path.splitext(os.path.basename(p))[0]
        dst = os.path.join(out_dir, person, f"{stem}.png")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        k = 1
        while os.path.exists(dst):
            dst = os.path.join(out_dir, person, f"{stem}_{k}.png")
            k += 1
        imageio.imwrite(dst, imageio.resize_u8(img, size, "bicubic"))
        count += 1
    logger.info("prepared %d face crops under %s", count, out_dir)
    return count
