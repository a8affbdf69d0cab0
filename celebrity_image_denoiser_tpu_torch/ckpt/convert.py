"""Carry weights across: JAX param trees, native npz checkpoints and
reference ``.pth`` files into the port's torch state_dict.

The JAX package stores conv kernels HWIO and transpose-conv kernels
(kH, kW, C_out, C_in) under ``<path>.kernel`` (``nn/layers.py:27,84``); its
exporter maps both to torch with the permutation (3, 2, 0, 1)
(``ckpt/export.py:44-52``): HWIO → OIHW, and (kH, kW, C_out, C_in) →
(C_in, C_out, kH, kW).  ``kernel`` is renamed ``weight``; ``bias`` stays.
The generator of the denoise family has only those two layer kinds; the
BatchNorm and Linear cases come with the discriminator.

``load_npz_state_dict`` reads the native checkpoint layout of
``ckpt/checkpoint.py::load_checkpoint`` (:101): ``<dir>/arrays.npz`` with
section-prefixed dotted keys (``generator.down1.0.kernel``).
``load_pth_state_dict`` is the tolerant ``.pth`` reader of
``ckpt/torch_import.py::load_pth_safely`` (:139): keys ``generator`` /
``state_dict`` / ``G`` tried in turn, a DDP ``module.`` prefix stripped —
but with ``torch.load(..., weights_only=True)``, so no pickle code runs.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.utils import tree as treelib

_KERNEL_PERM = (3, 2, 0, 1)


def jax_params_to_state_dict(tree_or_flat: Mapping[str, Any],
                             section: str = "generator"
                             ) -> Dict[str, torch.Tensor]:
    """A JAX param tree (nested dicts of arrays) or a flat dotted-key dict
    (the ``arrays.npz`` layout, ``<section>.`` prefixes allowed) → a torch
    state_dict of float32 tensors.  Raises ``ValueError`` on a leaf it does
    not know how to carry (anything but a 4-D conv kernel or a bias)."""
    flat = treelib.flatten(dict(tree_or_flat))
    prefix = section + "."
    if any(k.startswith(prefix) for k in flat):
        flat = {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        path, _, leaf = key.rpartition(".")
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{key}: only 4-D conv kernels are carried "
                                 f"across, got shape {arr.shape}")
            arr = np.transpose(arr, _KERNEL_PERM)
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"{key}: no torch counterpart for leaf {leaf!r}")
        sd[f"{path}.{leaf}" if path else leaf] = torch.from_numpy(
            np.array(arr, copy=True, order="C"))
    return sd


def load_npz_state_dict(npz_dir: str, section: str = "generator"
                        ) -> Dict[str, torch.Tensor]:
    """``<npz_dir>/arrays.npz`` → the ``section``'s torch state_dict."""
    with np.load(os.path.join(npz_dir, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    if not any(k.startswith(section + ".") for k in flat):
        raise KeyError(f"{npz_dir}: no {section!r} section in arrays.npz")
    return jax_params_to_state_dict(flat, section=section)


def load_pth_state_dict(path: str,
                        key_candidates=("generator", "state_dict", "G")
                        ) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` → its state_dict (tensors only), tried under
    ``key_candidates`` first, ``module.`` prefixes stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt
    if isinstance(ckpt, dict):
        for k in key_candidates:
            if isinstance(ckpt.get(k), dict):
                sd = ckpt[k]
                break
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: no state_dict found")
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items() if isinstance(v, torch.Tensor)}
