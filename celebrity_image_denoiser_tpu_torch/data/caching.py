"""Tensorized dataset caches of the port (counterpart of
``celebrity_image_denoiser_tpu/data/caching.py``, the same layouts, so each
package reads the other's caches).

The reference's two offline caching pipelines:

* ESRGAN .pt pairs (esrgan_preprocessing.py:12-54 saves each (noisy, clean)
  tensor pair; esrgan_train.py:18-36 walks them sorted): here
  ``build_tensor_cache`` writes one ``.npz`` per pair under
  ``<cache>/<noise>/pairs/``, and ``TensorPairDataset`` loads them sorted —
  same contract, numpy format.
* cGAN tf.data cache (DataP2.py:26-108: pair images, report unmatched,
  shuffle, ``tf.data.Dataset.save``): ``pair_with_report`` reproduces the
  pairing + unmatched-files report; ``build_tensor_cache`` is the cache
  writer.  The reference's deletion of corrupt/unpaired files
  (sr_ganpreprocess.py:34-41,116-133) is reproduced ONLY behind the
  explicit ``validate_dataset(delete_corrupt=True)`` opt-in; every default
  path skips and reports, never unlinks.

The reference's own caches are read too: the ESRGAN ``.pt`` tree
(``TorchTensorPairDataset``, ``torch.load(weights_only=True)``) and the cGAN
``tf.data`` cache (``TFDataCacheDataset``, tensorflow imported inside its
constructor only).  ``open_tensor_cache`` picks the reader by layout.
Items are numpy (noisy, clean) HWC float32 pairs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.data import datasets, imageio
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.data.caching")


def pair_with_report(
    noisy_dir: str, clean_dir: str
) -> Tuple[List[Tuple[str, str]], Dict[str, List[str]]]:
    """Pair files by relative path; report unmatched on both sides
    (DataP2.py:26-90's matched/unmatched accounting)."""
    noisy = {os.path.relpath(p, noisy_dir): p
             for p in imageio.list_images(noisy_dir)}
    clean = {os.path.relpath(p, clean_dir): p
             for p in imageio.list_images(clean_dir)}
    matched = sorted(set(noisy) & set(clean))
    report = {
        "unmatched_noisy": sorted(set(noisy) - set(clean)),
        "unmatched_clean": sorted(set(clean) - set(noisy)),
    }
    if report["unmatched_noisy"] or report["unmatched_clean"]:
        logger.warning(
            "pairing report: %d unmatched noisy, %d unmatched clean",
            len(report["unmatched_noisy"]), len(report["unmatched_clean"]))
    return [(noisy[k], clean[k]) for k in matched], report


def validate_dataset(
    noisy_dir: str,
    clean_dir: str,
    *,
    delete_corrupt: bool = False,
    delete_unmatched: bool = False,
) -> Dict[str, List[str]]:
    """The TF loader's dataset hygiene pass (sr_ganpreprocess.py:34-41,
    116-133): find undecodable and unpaired files.  The reference DELETES
    both kinds from disk; here each destructive scope is a separate explicit
    opt-in — ``delete_corrupt`` removes undecodable pairs only,
    ``delete_unmatched`` removes files with no partner — and the default only
    reports.  Destroying user data silently is the one reference behavior
    not worth parity by default; pass both flags for full reference parity.

    Returns {"corrupt": [...], "unmatched_noisy": [...],
    "unmatched_clean": [...], "deleted": [...]}."""
    pairs, report = pair_with_report(noisy_dir, clean_dir)
    corrupt: List[str] = []
    broken_pairs: List[str] = []  # both members of a pair with a bad side
    for np_, cp_ in pairs:
        bad = False
        for p in (np_, cp_):
            try:
                imageio.imread_rgb(p)
            except Exception as e:
                logger.warning("corrupt image %s: %s", p, e)
                corrupt.append(p)
                bad = True
        if bad:
            broken_pairs.extend((np_, cp_))
    report = dict(report, corrupt=sorted(set(corrupt)), deleted=[])
    to_delete: List[str] = []
    if delete_corrupt:
        # deleting a corrupt member also removes its partner — otherwise the
        # partner becomes a fresh orphan and the pass would need re-running
        to_delete += sorted(set(broken_pairs))
    if delete_unmatched:
        to_delete += [os.path.join(noisy_dir, r)
                      for r in report["unmatched_noisy"]]
        to_delete += [os.path.join(clean_dir, r)
                      for r in report["unmatched_clean"]]
    if to_delete:
        for p in to_delete:
            try:
                os.remove(p)
                report["deleted"].append(p)
                logger.warning("deleted %s (reference cleanup behavior, "
                               "sr_ganpreprocess.py:34-41)", p)
            except OSError as e:
                logger.warning("could not delete %s: %s", p, e)
    return report


def build_tensor_cache(
    noisy_dir: str,
    clean_dir: str,
    cache_dir: str,
    image_size: Tuple[int, int] = (256, 256),
    normalize: bool = False,
    resize_method: str = "bicubic",
) -> int:
    """Decode, resize, tensorize each pair to ``<cache>/pairs/NNNNNN.npz``
    with float32 arrays (``noisy``/``clean`` keys), [0,1] domain (the
    ESRGAN convention) or [-1,1] when ``normalize``.  ``resize_method``:
    "bicubic" (reference default), "lanczos" (the TF cleanup path,
    sr_ganpreprocess.py:26-27), or "cv2-linear" (the cGAN cache stage's
    cv2.resize INTER_LINEAR, DataP2.py:19-20).  Returns pair count."""
    pairs, _ = pair_with_report(noisy_dir, clean_dir)
    out_dir = os.path.join(cache_dir, "pairs")
    os.makedirs(out_dir, exist_ok=True)
    import json

    with open(os.path.join(cache_dir, "meta.json"), "w") as f:
        json.dump({"normalize": bool(normalize),
                   "image_size": list(image_size),
                   "resize_method": resize_method}, f)
    size = (image_size[1], image_size[0])
    count = 0
    for noisy_path, clean_path in pairs:
        try:
            n = imageio.to_float01(
                imageio.imread_rgb(noisy_path, size, method=resize_method))
            c = imageio.to_float01(
                imageio.imread_rgb(clean_path, size, method=resize_method))
        except Exception as e:  # skip-and-report; never delete sources
            logger.warning("skipping pair %s: %s", noisy_path, e)
            continue
        if normalize:
            n, c = n * 2 - 1, c * 2 - 1
        np.savez(os.path.join(out_dir, f"{count:06d}.npz"), noisy=n, clean=c)
        count += 1
    logger.info("cached %d tensor pairs under %s", count, out_dir)
    return count


class TensorPairDataset:
    """Loads cached pairs in sorted order (TensorPairDataset contract,
    esrgan_train.py:18-36)."""

    def __init__(self, cache_dir: str):
        import json

        pair_dir = os.path.join(cache_dir, "pairs")
        # domain metadata: None for pre-meta caches (domain unknown).
        # domain_recorded distinguishes meta.json-RECORDED metadata from a
        # reader-side assumption (TorchTensorPairDataset) — a declared
        # --tensor-cache-domain may override an assumption, but contradicting
        # recorded metadata is an error.
        self.normalized = None
        self.domain_recorded = False
        meta_path = os.path.join(cache_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self.normalized = bool(json.load(f).get("normalize", False))
            self.domain_recorded = True
        self.files = sorted(
            os.path.join(pair_dir, f)
            for f in os.listdir(pair_dir)
            if f.endswith(".npz")
        )
        if not self.files:
            raise ValueError(f"no cached pairs under {pair_dir}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int):
        try:
            with np.load(self.files[idx]) as z:
                return z["noisy"], z["clean"]
        except Exception as e:
            logger.warning("bad cache entry %s: %s", self.files[idx], e)
            return None


class TorchTensorPairDataset:
    """Reads the reference's actual ``.pt`` tensor-pair caches.

    The reference ESRGAN workflow materializes
    ``Pre_dataset/<noise>/{noisy_tensor,clean_tensor}/<rel>.pt`` — one CHW
    float [0,1] tensor per file (esrgan_preprocessing.py:12-54) — and trains
    by walking ``noisy_tensor`` recursively, sorted, loading the clean
    partner by the same relative path (esrgan_train.py:18-36).  This reader
    accepts either a single ``<dir>/{noisy_tensor,clean_tensor}`` pair or a
    whole ``Pre_dataset`` root (every ``<noise>/`` subdir concatenated,
    sorted by noise type then rel path), converts CHW→HWC, and returns
    ``None`` for undecodable entries (the skip-and-collate contract).  torch
    is needed only to unpickle; items come back as numpy.
    """

    # torchvision ToTensor domain assumption (esrgan_preprocessing.py uses
    # ToTensor, which is [0,1]) — NOT recorded metadata; an explicit
    # `cli.train --tensor-cache-domain` overrides it
    normalized = False
    domain_recorded = False

    def __init__(self, root: str):
        self.pairs: List[Tuple[str, str]] = []
        roots = []
        if os.path.isdir(os.path.join(root, "noisy_tensor")):
            roots.append(root)
        else:
            roots.extend(
                os.path.join(root, d)
                for d in sorted(os.listdir(root))
                if os.path.isdir(os.path.join(root, d, "noisy_tensor")))
        for r in roots:
            nd = os.path.join(r, "noisy_tensor")
            cd = os.path.join(r, "clean_tensor")
            rels = []
            for walk_root, _, files in os.walk(nd):
                for f in files:
                    if f.endswith(".pt"):
                        rels.append(os.path.relpath(
                            os.path.join(walk_root, f), nd))
            # the reference sorts (esrgan_train.py:28)
            for rel in sorted(rels):
                cp = os.path.join(cd, rel)
                if os.path.isfile(cp):
                    self.pairs.append((os.path.join(nd, rel), cp))
                else:
                    logger.warning("no clean partner for %s; skipping", rel)
        if not self.pairs:
            raise ValueError(
                f"no .pt pairs under {root} (expected "
                "<dir>/{{noisy_tensor,clean_tensor}}/*.pt or "
                "Pre_dataset/<noise>/ subdirs of that shape)")

    @staticmethod
    def _load(path: str) -> np.ndarray:
        t = torch.load(path, map_location="cpu", weights_only=True)
        a = np.asarray(t.detach().numpy() if hasattr(t, "detach") else t,
                       np.float32)
        if a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[0] < a.shape[-1]:
            a = np.transpose(a, (1, 2, 0))  # CHW (torchvision) -> HWC
        return a

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int):
        np_, cp_ = self.pairs[idx]
        try:
            return self._load(np_), self._load(cp_)
        except Exception as e:
            logger.warning("bad .pt cache entry %s: %s", np_, e)
            return None


class TFDataCacheDataset:
    """Reads the reference's actual cGAN ``tf.data`` cache.

    ``DataP2.py:92-108`` builds the cGAN training cache as
    ``from_generator → shuffle(5000) → tf.data.Dataset.save(cache_dir)``;
    the trainer reloads it with ``tf.data.Dataset.load``
    (training5Pbar.py:230-235) and then materializes the whole dataset in
    RAM anyway (``list(dataset)``, training5Pbar.py:133).  This reader does
    the same: one ``Dataset.load`` pass at construction, elements held as
    numpy (noisy, clean) HWC float32 pairs, no TF work per step.

    TF is imported lazily and only here (the card machine has none); without
    tensorflow this reader raises with a clear message and every other
    cache flavor keeps working.
    """

    # the DataP2 preprocessing pins the domain by construction:
    # (x - 127.5) / 127.5 → [-1, 1]  (DataP2.py:21-22)
    normalized = True
    domain_recorded = True

    def __init__(self, path: str):
        try:
            import tensorflow as tf  # noqa: PLC0415 — optional, reader-only
        except ImportError as e:
            raise RuntimeError(
                f"{path} is a tf.data cache (tf.data.Dataset.save layout); "
                "reading it requires tensorflow, which is not installed. "
                "Rebuild the cache with build_tensor_cache, or install TF."
            ) from e
        self.items: List[Tuple[np.ndarray, np.ndarray]] = []
        for element in tf.data.Dataset.load(path):
            if not (isinstance(element, tuple) and len(element) == 2):
                raise ValueError(
                    f"{path}: expected (noisy, clean) element pairs, got "
                    f"{type(element).__name__} — not a DataP2-style cache")
            n, c = element
            self.items.append((np.asarray(n, np.float32),
                               np.asarray(c, np.float32)))
        if not self.items:
            raise ValueError(f"tf.data cache at {path} is empty")
        logger.info("loaded %d pairs from tf.data cache %s",
                    len(self.items), path)

    @staticmethod
    def is_tf_data_cache(path: str) -> bool:
        """A ``tf.data.Dataset.save`` directory always carries these two
        top-level files (any TF 2.x snapshot version)."""
        return (os.path.isfile(os.path.join(path, "dataset_spec.pb"))
                and os.path.isfile(os.path.join(path, "snapshot.metadata")))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]


def open_tensor_cache(path: str):
    """Open any cache flavor by layout: the native npz cache
    (``<dir>/pairs/*.npz``, TensorPairDataset), the reference's ESRGAN
    ``.pt`` tree (TorchTensorPairDataset), or the reference's cGAN
    ``tf.data`` cache (TFDataCacheDataset)."""
    if os.path.isdir(os.path.join(path, "pairs")):
        return TensorPairDataset(path)
    if TFDataCacheDataset.is_tf_data_cache(path):
        return TFDataCacheDataset(path)
    return TorchTensorPairDataset(path)


def train_val_test_split(items: Sequence, val: float = 0.1,
                         test: float = 0.1, seed: int = 42):
    """``datasets.train_val_test_split`` by fractions: the reference's split
    order (train carved first, then val against test, training5Pbar.py:
    138-139)."""
    return datasets.train_val_test_split(
        items, train_split=1.0 - val - test, val_split=val, seed=seed)
