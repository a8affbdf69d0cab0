"""Datasets and splits of the port (counterpart of
``celebrity_image_denoiser_tpu/data/datasets.py``).

``train_test_split_pairs`` is the same code: the 80/20 split with
``random_state=42`` through sklearn when it is installed, else an equivalent
shuffled numpy split.  ``CleanImageDataset`` is the clean-only dataset of the
on-the-fly path; in the port it yields **uint8 HWC**, because normalisation
and noise injection happen on the device (``data/noise.py``) and a uint8
batch is a quarter of the float32 bytes on the way there.  Bad files follow
the warn-and-skip contract: ``__getitem__`` returns ``None`` and the pipeline
filters it.

Resizing is not ported (``ops/resize.py``, ROADMAP.md queue 1 item 9): a file
whose size differs from ``image_size`` raises.  ``PairedImageDataset``
(pre-rendered noisy files) waits with item 10.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.data")

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")


def list_images(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def train_test_split_pairs(pairs: List, test_split: float = 0.2,
                           seed: int = 42):
    """80/20 split; sklearn with ``random_state=seed`` when present (bit-exact
    with the reference), otherwise an equivalent shuffled split."""
    if not pairs:
        raise ValueError("No valid image pairs found. Check dataset paths "
                         "and files.")
    try:
        from sklearn.model_selection import train_test_split

        return train_test_split(pairs, test_size=test_split,
                                random_state=seed)
    except ImportError:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(pairs))
        n_test = int(round(len(pairs) * test_split))
        test = [pairs[i] for i in idx[:n_test]]
        train = [pairs[i] for i in idx[n_test:]]
        return train, test


class SizeMismatch(ValueError):
    """A file's size differs from the dataset's ``image_size``."""


class CleanImageDataset:
    """Clean images only, as uint8 HWC RGB — noise is injected on the device
    per batch (``data.noise.random_noise_batch``)."""

    def __init__(self, clean_dir: str,
                 image_size: Optional[Tuple[int, int]] = (256, 256),
                 test_split: float = 0.2, split_seed: int = 42):
        paths = list_images(clean_dir)
        if not paths:
            raise ValueError(f"No images found under {clean_dir}")
        self.train_paths, self.test_paths = train_test_split_pairs(
            paths, test_split, split_seed)
        self.image_size = None if image_size is None else tuple(image_size)

    def __len__(self):
        return len(self.train_paths)

    def _load(self, path: str) -> np.ndarray:
        with open(path, "rb") as f:
            arr = imageio.imread_rgb(f.read())
        if self.image_size is not None \
                and tuple(arr.shape[:2]) != self.image_size:
            raise SizeMismatch(
                f"{path}: image is {arr.shape[0]}x{arr.shape[1]} but "
                f"image_size is {self.image_size[0]}x{self.image_size[1]}; "
                "resizing is not ported yet (ops/resize.py, ROADMAP.md queue "
                "1 item 9) — resize the files or pass their size")
        return arr

    def __getitem__(self, idx: int):
        try:
            return self._load(self.train_paths[idx])
        except SizeMismatch:
            raise
        except Exception as e:  # warn-and-skip contract
            logger.warning("Error loading %s: %s", self.train_paths[idx], e)
            return None

    def get_test(self, idx: int) -> np.ndarray:
        return self._load(self.test_paths[idx])
