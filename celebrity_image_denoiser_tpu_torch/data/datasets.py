"""Dataset pairing and splits of the port (counterpart of
``celebrity_image_denoiser_tpu/data/datasets.py``).

The same disk layout contract (``Dataset_Noise/<noise_type>/<person>/<img>``
paired with ``Clean_dataset/<person>/<img>``, ``collect_pairs``), the same
splits (the 80/20 ``train_test_split_pairs`` with ``random_state=42``, the
cGAN trainer's 80/10/10 ``train_val_test_split``; through sklearn when it
is installed, else an equivalent shuffled numpy split) and the same two
datasets:

* ``PairedImageDataset``: pre-rendered noisy files and their clean
  partners, float32 HWC in [-1, 1] (or on [0, 1] unnormalised), each side
  resized to its own size (srgan's LR noisy / HR clean); what the trainer's
  ``(noisy, clean)`` path takes.
* ``CleanImageDataset``: clean files only, for the on-the-fly path.  In the
  port it yields **uint8 HWC**, resized to ``image_size`` with Pillow's
  bicubic (``imageio.imread_rgb``, bit-exact): the uint8 the JAX dataset
  holds before ``to_float01``.  Normalisation and noise injection happen
  on the device (``data/noise.py``), and a uint8 batch is a quarter of the
  float32 bytes on the way there.

Both expose ``raw(idx)`` (decoded, not resized) and ``raw_batch_spec`` for
the pipeline's native batch assembly (``data/native.py``): one ``(hw,
mean, std)`` per side, float32 ``(x/255 - mean)/std`` out, as in JAX; the
clean dataset's side is ``(hw, None, None)``, a uint8 batch.  Bad files
follow the warn-and-skip contract: ``__getitem__`` and ``raw`` return
``None`` and the pipeline filters it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data.noise import NOISE_TYPES
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.data")


def collect_pairs(noisy_base_dir: str, clean_dir: str,
                  noise_types: Sequence[str]) -> List[Tuple[str, str]]:
    """All (noisy_path, clean_path) pairs across noise types, walked as the
    reference's DenoiseDataset walks them (``collect_pairs:30``)."""
    all_pairs: List[Tuple[str, str]] = []
    for noise_type in noise_types:
        noise_dir = os.path.join(noisy_base_dir, noise_type)
        if not os.path.exists(noise_dir):
            logger.warning("Noise directory %s does not exist.", noise_dir)
            continue
        for person_dir in sorted(os.listdir(noise_dir)):
            person_noise_dir = os.path.join(noise_dir, person_dir)
            person_clean_dir = os.path.join(clean_dir, person_dir)
            if not (os.path.isdir(person_noise_dir)
                    and os.path.exists(person_clean_dir)):
                continue
            for filename in sorted(os.listdir(person_noise_dir)):
                if filename.lower().endswith(imageio.IMAGE_EXTS):
                    clean_path = os.path.join(person_clean_dir, filename)
                    if os.path.exists(clean_path):
                        all_pairs.append(
                            (os.path.join(person_noise_dir, filename),
                             clean_path))
    return all_pairs


def train_test_split_pairs(pairs: List, test_split: float = 0.2,
                           seed: int = 42):
    """80/20 split; sklearn with ``random_state=seed`` when present (bit-exact
    with the reference), otherwise an equivalent shuffled split."""
    if not pairs:
        raise ValueError("No valid image pairs found. Check dataset paths "
                         "and files.")
    try:
        from sklearn.model_selection import train_test_split
    except ImportError:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(pairs))
        n_test = int(round(len(pairs) * test_split))
        test = [pairs[i] for i in idx[:n_test]]
        train = [pairs[i] for i in idx[n_test:]]
        return train, test
    return train_test_split(pairs, test_size=test_split, random_state=seed)


def train_val_test_split(items: List, train_split: float = 0.8,
                         val_split: float = 0.1, seed: Optional[int] = None):
    """80/10/10 three-way split, the cGAN trainer's ``split_dataset``
    (``train_val_test_split:75``): an 80/20 first cut, then the remainder
    split val against test at ``val_split / (1 - train_split)``.  The
    reference passes ``random_state=None`` (another split every run); pass
    a seed to repeat one."""
    if not items:
        raise ValueError("Dataset is empty. Cannot split.")
    try:
        from sklearn.model_selection import train_test_split as _tts
    except ImportError:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(items))
        n_tr = int(round(len(items) * train_split))
        n_val = int(round(len(items) * val_split))
        pick = lambda sl: [items[i] for i in sl]  # noqa: E731
        return (pick(idx[:n_tr]), pick(idx[n_tr:n_tr + n_val]),
                pick(idx[n_tr + n_val:]))
    train, temp = _tts(items, train_size=train_split, random_state=seed)
    val, test = _tts(temp, train_size=val_split / (1 - train_split),
                     random_state=seed)
    return train, val, test


def _wh(hw: Optional[Tuple[int, int]]):
    """(h, w) → PIL's (w, h), None stays None."""
    return None if hw is None else (hw[1], hw[0])


class PairedImageDataset:
    """Noisy/clean pairs from disk (``PairedImageDataset:101``), float32 HWC
    in [-1, 1], or on [0, 1] with ``normalize=False``.

    ``image_size`` resizes both sides; srgan's LR/HR layout takes distinct
    ``noisy_size`` / ``clean_size``; None loads a side as it is.
    ``__getitem__`` returns ``(noisy, clean)`` or None on a decode error."""

    def __init__(self, noisy_base_dir: str, clean_dir: str,
                 noise_types: Sequence[str] = NOISE_TYPES,
                 image_size: Optional[Tuple[int, int]] = None,
                 noisy_size: Optional[Tuple[int, int]] = None,
                 clean_size: Optional[Tuple[int, int]] = None,
                 test_split: float = 0.2, split_seed: int = 42,
                 normalize: bool = True):
        pairs = collect_pairs(noisy_base_dir, clean_dir, noise_types)
        self.image_pairs, self.test_image_pairs = train_test_split_pairs(
            pairs, test_split, split_seed)
        logger.info("Loaded %d training image pairs and %d test image pairs.",
                    len(self.image_pairs), len(self.test_image_pairs))
        self.noisy_size = noisy_size or image_size
        self.clean_size = clean_size or image_size
        self.normalize = normalize

    def __len__(self):
        return len(self.image_pairs)

    def _load(self, path: str, hw) -> np.ndarray:
        arr = imageio.to_float01(imageio.imread_rgb(path, _wh(hw)))
        return imageio.normalize(arr) if self.normalize else arr

    def _pair(self, pair):
        noisy_path, clean_path = pair
        return (self._load(noisy_path, self.noisy_size),
                self._load(clean_path, self.clean_size))

    def __getitem__(self, idx: int):
        try:
            return self._pair(self.image_pairs[idx])
        except Exception as e:  # warn-and-skip contract
            logger.warning("Error loading images: %s. Error: %s",
                           self.image_pairs[idx], e)
            return None

    @property
    def raw_batch_spec(self):
        """Per side ``(hw, mean, std)`` for the native assembly; None (the
        python path) unless both sides have a fixed size."""
        if self.noisy_size is None or self.clean_size is None:
            return None
        m, s = (0.5, 0.5) if self.normalize else (0.0, 1.0)
        return [(tuple(self.noisy_size), m, s), (tuple(self.clean_size), m, s)]

    def raw(self, idx: int):
        """The decoded uint8 HWC pair (no resize, no normalisation), or
        None."""
        noisy_path, clean_path = self.image_pairs[idx]
        try:
            return (imageio.imread_rgb(noisy_path),
                    imageio.imread_rgb(clean_path))
        except Exception as e:  # warn-and-skip contract
            logger.warning("Error loading images: %s, %s. Error: %s",
                           noisy_path, clean_path, e)
            return None

    def get_test(self, idx: int):
        return self._pair(self.test_image_pairs[idx])


class CleanImageDataset:
    """Clean images only, as uint8 HWC RGB resized to ``image_size`` (None:
    as stored) — noise is injected on the device per batch
    (``data.noise.random_noise_batch``)."""

    def __init__(self, clean_dir: str,
                 image_size: Optional[Tuple[int, int]] = (256, 256),
                 test_split: float = 0.2, split_seed: int = 42):
        paths = imageio.list_images(clean_dir)
        if not paths:
            raise ValueError(f"No images found under {clean_dir}")
        self.train_paths, self.test_paths = train_test_split_pairs(
            paths, test_split, split_seed)
        self.image_size = None if image_size is None else tuple(image_size)

    def __len__(self):
        return len(self.train_paths)

    def _load(self, path: str) -> np.ndarray:
        return imageio.imread_rgb(path, _wh(self.image_size), "bicubic")

    def __getitem__(self, idx: int):
        try:
            return self._load(self.train_paths[idx])
        except Exception as e:  # warn-and-skip contract
            logger.warning("Error loading %s: %s", self.train_paths[idx], e)
            return None

    @property
    def raw_batch_spec(self):
        """One uint8 side at ``image_size`` for the native assembly; None
        (the python path) when files load as they are."""
        if self.image_size is None:
            return None
        return [(self.image_size, None, None)]

    def raw(self, idx: int):
        """The decoded uint8 HWC image (no resize), or None."""
        try:
            return imageio.imread_rgb(self.train_paths[idx])
        except Exception as e:  # warn-and-skip contract
            logger.warning("Error loading %s: %s", self.train_paths[idx], e)
            return None

    def get_test(self, idx: int) -> np.ndarray:
        return self._load(self.test_paths[idx])
