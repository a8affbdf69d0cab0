"""Carry weights across: JAX param trees, native npz checkpoints and
reference ``.pth`` files into the port's torch state_dict, and back.

The JAX package stores conv kernels HWIO and transpose-conv kernels
(kH, kW, C_out, C_in) under ``<path>.kernel`` (``nn/layers.py:27,84``); its
exporter maps both to torch with the permutation (3, 2, 0, 1)
(``ckpt/export.py:44-52``): HWIO → OIHW, and (kH, kW, C_out, C_in) →
(C_in, C_out, kH, kW).  ``kernel`` is renamed ``weight``; ``bias`` stays.
A BatchNorm layer's params ``scale`` / ``bias`` become ``weight`` / ``bias``
and its state ``mean`` / ``var`` become ``running_mean`` / ``running_var``
(``nn/layers.py`` BatchNorm2d); torch's ``num_batches_tracked`` has no JAX
counterpart and keeps the module's own value (``load_jax_trees``).  A PReLU's
slope ``alpha`` becomes ``weight`` too (``ckpt/torch_import.py:83-86``), so
a torch ``weight`` of one dimension is a BatchNorm's ``scale`` in one module
and a PReLU's ``alpha`` in another: the module's type decides.  Given the
``module`` the weights are for, both ways check each leaf against the type
of the module it lands in (a BatchNorm ``scale`` never loads into a PReLU);
``alpha`` is carried only with the module.  A Linear's 2-D ``kernel``
(in, out) becomes its ``weight`` (out, in), and an Embedding's ``table``
its ``weight`` (``ckpt/torch_import.py:77-92``), as the cGAN families
have them; the 2-D ``weight`` of the way back is a Linear's or an
Embedding's by the type of ``module``'s submodule (a Linear without it).

Every module of the port carries its weights this way: the generators and
discriminators of the five families (the srgan discriminator's BatchNorm,
the esrgan discriminator's Linear over NCHW-flattened features) and the VGG
tower of ``models/vgg.py`` (the ``vgg`` / ``vgg_state`` sections of the
shipped ``weights/perceptual``, ``load_npz_state_dict(..., "vgg")``).

``state_dict_to_jax_params`` is the way back — torch → a numpy tree in the
JAX layout, kernels HWIO again (the permutation's inverse, (2, 3, 1, 0), is
the same for both conv kinds) — used to write checkpoints that the JAX
package can resume from.  Reference ``.pth`` files (``initial.1.weight``,
``residuals.N.block.2.weight``, …) need no renaming: the port's modules
carry the reference's child names.

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
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.utils import tree as treelib

_KERNEL_PERM = (3, 2, 0, 1)
_KERNEL_PERM_BACK = (2, 3, 1, 0)
# JAX leaf name -> torch name, for the leaves that are carried as they are
_LEAF_TO_TORCH = {"bias": "bias", "scale": "weight", "alpha": "weight",
                  "table": "weight", "mean": "running_mean",
                  "var": "running_var"}


def _submodule(module: torch.nn.Module, path: str, key: str):
    try:
        return module.get_submodule(path)
    except AttributeError:
        raise ValueError(f"{key}: {type(module).__name__} has no module "
                         f"{path!r}") from None


_CONVS = (torch.nn.Conv2d, torch.nn.ConvTranspose2d)
_LINEARS = (torch.nn.Linear,)
_EMBEDDINGS = (torch.nn.Embedding,)
_BNS = (torch.nn.BatchNorm2d,)
_PRELUS = (torch.nn.PReLU,)
# the module kinds each JAX leaf may land in
_LEAF_KINDS = {"kernel": _CONVS + _LINEARS, "scale": _BNS, "mean": _BNS,
               "var": _BNS, "alpha": _PRELUS, "table": _EMBEDDINGS,
               "bias": _CONVS + _LINEARS + _BNS}


def jax_params_to_state_dict(tree_or_flat: Mapping[str, Any],
                             section: str = "generator",
                             module: Optional[torch.nn.Module] = None
                             ) -> Dict[str, torch.Tensor]:
    """A JAX param tree (nested dicts of arrays) or a flat dotted-key dict
    (the ``arrays.npz`` layout, ``<section>.`` prefixes allowed) → a torch
    state_dict of float32 tensors.  Takes a params tree or a BatchNorm state
    tree (``mean`` / ``var``).  With ``module``, every leaf must land in a
    module of its kind (a conv's ``kernel``, a BatchNorm's ``scale``, a
    PReLU's ``alpha``).  Raises ``ValueError`` on a leaf it does not know
    how to carry, on a PReLU slope without ``module``, and on a leaf that
    lands in a module of another kind."""
    flat = treelib.flatten(dict(tree_or_flat))
    prefix = section + "."
    if any(k.startswith(prefix) for k in flat):
        flat = {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        path, _, leaf = key.rpartition(".")
        arr = np.asarray(value, dtype=np.float32)
        if leaf not in _LEAF_KINDS:
            raise ValueError(f"{key}: no torch counterpart for leaf {leaf!r}")
        if leaf == "alpha" and module is None:
            raise ValueError(f"{key}: a PReLU slope is carried only with the "
                             "module it is for (module=)")
        if module is not None:
            sub = _submodule(module, path, key)
            if not isinstance(sub, _LEAF_KINDS[leaf]):
                raise ValueError(f"{key}: lands in a {type(sub).__name__}")
        if leaf == "kernel":
            if arr.ndim not in (2, 4):
                raise ValueError(f"{key}: only 4-D conv kernels and 2-D "
                                 f"Linear kernels are carried across, got "
                                 f"shape {arr.shape}")
            arr = np.transpose(arr, _KERNEL_PERM if arr.ndim == 4 else (1, 0))
            leaf = "weight"
        else:
            leaf = _LEAF_TO_TORCH[leaf]
        sd[f"{path}.{leaf}" if path else leaf] = torch.from_numpy(
            np.array(arr, copy=True, order="C"))
    return sd


def load_jax_trees(module: torch.nn.Module, params: Mapping[str, Any],
                   state: Optional[Mapping[str, Any]] = None) -> None:
    """Load a JAX (params, state) pair into ``module`` strictly: every
    parameter and running statistic of the module must be given and every
    given leaf must have a place.  ``num_batches_tracked`` buffers keep the
    module's values."""
    sd = jax_params_to_state_dict(params, module=module)
    if state:
        sd.update(jax_params_to_state_dict(state, module=module))
    own = module.state_dict()
    need = {k for k in own if not k.endswith("num_batches_tracked")}
    if set(sd) != need:
        raise KeyError(f"missing {sorted(need - set(sd))}, unexpected "
                       f"{sorted(set(sd) - need)}")
    module.load_state_dict({**own, **sd}, strict=True)


def state_dict_to_jax_params(sd: Mapping[str, torch.Tensor],
                             module: Optional[torch.nn.Module] = None
                             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A torch state_dict (or any dict keyed like one: gradients, optimiser
    moments) → ``(params, state)`` as nested dicts of float32 numpy arrays in
    the JAX layout: 4-D ``weight`` → HWIO ``kernel``, 2-D ``weight`` → a
    Linear's (in, out) ``kernel`` or, by ``module``, an Embedding's
    ``table``, ``running_mean`` /
    ``running_var`` → state ``mean`` / ``var``; ``num_batches_tracked`` is
    dropped.  A 1-D ``weight`` is a PReLU's ``alpha`` or a BatchNorm's
    ``scale`` by the type of ``module``'s submodule at its path; without
    ``module`` it is taken for a BatchNorm's (the denoise family has no
    PReLU)."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for key, value in sd.items():
        path, _, leaf = key.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        arr = value.detach().to("cpu", torch.float32).numpy()
        target = params
        if leaf == "weight" and arr.ndim == 4:
            arr, leaf = np.transpose(arr, _KERNEL_PERM_BACK), "kernel"
        elif leaf == "weight" and arr.ndim == 2:
            sub = None if module is None else _submodule(module, path, key)
            if isinstance(sub, _EMBEDDINGS):
                leaf = "table"
            elif sub is None or isinstance(sub, _LINEARS):
                arr, leaf = arr.T, "kernel"
            else:
                raise ValueError(f"{key}: a 2-D weight of a "
                                 f"{type(sub).__name__}")
        elif leaf == "weight" and arr.ndim == 1:
            leaf = "scale"
            if module is not None:
                sub = _submodule(module, path, key)
                if isinstance(sub, _PRELUS):
                    leaf = "alpha"
                elif not isinstance(sub, _BNS):
                    raise ValueError(f"{key}: a 1-D weight of a "
                                     f"{type(sub).__name__}")
        elif leaf in ("running_mean", "running_var"):
            leaf, target = leaf[len("running_"):], state
        elif leaf != "bias":
            raise ValueError(f"{key}: no JAX counterpart for {leaf!r} of "
                             f"shape {arr.shape}")
        treelib.set_path(target, f"{path}.{leaf}" if path else leaf,
                         np.array(arr, copy=True, order="C"))
    return params, state


def load_npz_state_dict(npz_dir: str, section: str = "generator",
                        module: Optional[torch.nn.Module] = None
                        ) -> Dict[str, torch.Tensor]:
    """``<npz_dir>/arrays.npz`` → the ``section``'s torch state_dict, with
    the BatchNorm statistics of ``<section>_state`` when the file holds
    them; with ``module``, each leaf checked against the module it lands
    in."""
    with np.load(os.path.join(npz_dir, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    if not any(k.startswith(section + ".") for k in flat):
        raise KeyError(f"{npz_dir}: no {section!r} section in arrays.npz")
    sd = {}
    for sec in (section, section + "_state"):
        part = {k: v for k, v in flat.items() if k.startswith(sec + ".")}
        if part:
            sd.update(jax_params_to_state_dict(part, section=sec,
                                               module=module))
    return sd


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
