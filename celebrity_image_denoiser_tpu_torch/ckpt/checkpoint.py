"""Native checkpoint format: save and restore, with actual resume.

Port of ``celebrity_image_denoiser_tpu/ckpt/checkpoint.py`` in the **same
layout and key names** (:39-128), so a checkpoint written by either package
resumes in the other: ``<path>/arrays.npz`` holds every array leaf under its
section-prefixed dotted path (``generator.down1.0.kernel``), ``<path>/
meta.json`` the scalars and history.  Sections are nested dicts of arrays in
the JAX layout (``ckpt/convert.py`` carries torch state across); a leaf may
be a numpy array, a Python number or a torch tensor on any device.

Writes are atomic (temp file, then ``os.replace``).  With ``async_write``
the device-to-host copy and the meta snapshot happen inline and only the
serialisation runs on a background thread; ``wait_for_saves`` joins the
writers and re-raises the first write error.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.utils import tree as treelib
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.ckpt")

_pending_saves: list = []
_save_errors: list = []


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, sections: Dict[str, Any],
                    meta: Optional[Dict] = None,
                    async_write: bool = False) -> None:
    """sections: {"generator": tree, "g_optimizer": tree, ...}; meta:
    JSON-serialisable scalars (epoch, best_psnr, metric_history, ...)."""
    flat: Dict[str, np.ndarray] = {}
    for section, t in sections.items():
        if t is None:
            continue
        for k, v in treelib.flatten(t, section).items():
            flat[k] = _to_numpy(v)  # D2H inline, before any thread starts
    # snapshot now: callers keep mutating live objects (metric_history)
    meta_json = json.dumps(meta or {}, indent=1, default=float)

    def write():
        try:
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, ".arrays.npz.tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, os.path.join(path, "arrays.npz"))
            tmp_meta = os.path.join(path, ".meta.json.tmp")
            with open(tmp_meta, "w") as f:
                f.write(meta_json)
            os.replace(tmp_meta, os.path.join(path, "meta.json"))
            logger.info("saved checkpoint: %s (%d arrays)", path, len(flat))
        except Exception as e:
            logger.error("checkpoint write failed: %s (%s)", path, e)
            _save_errors.append(e)
            raise

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _pending_saves.append(t)
    else:
        write()


def wait_for_saves() -> None:
    """Block until every async checkpoint write is done; re-raise the first
    background write error."""
    while _pending_saves:
        _pending_saves.pop().join()
    if _save_errors:
        err = _save_errors[0]
        _save_errors.clear()
        raise err


def load_checkpoint(path: str):
    """Returns (sections, meta): sections a dict of nested numpy trees keyed
    by the section names given at save time."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    nested = treelib.unflatten(flat)
    meta_path = os.path.join(path, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return nested, meta


def latest_checkpoint(checkpoint_dir: str, prefix: str = "") -> Optional[str]:
    """The newest ``<prefix>epoch_<N>`` checkpoint directory, for resume."""
    if not os.path.isdir(checkpoint_dir):
        return None
    best_epoch, best = -1, None
    pat = re.compile(re.escape(prefix) + r"epoch_(\d+)$")
    for name in os.listdir(checkpoint_dir):
        m = pat.search(name)
        full = os.path.join(checkpoint_dir, name)
        if m and os.path.isdir(full) \
                and os.path.exists(os.path.join(full, "arrays.npz")):
            e = int(m.group(1))
            if e > best_epoch:
                best_epoch, best = e, full
    return best
