"""Export the port's weights to the reference's checkpoint formats.

Port of ``celebrity_image_denoiser_tpu/ckpt/export.py``:

* ``export_torch_state_dict`` (:32): a generator's weights in the
  reference's torch layout, as numpy arrays with the JAX exporter's keys
  and values.  The port's modules carry the reference's names and layouts
  already, so this is the module's ``state_dict`` as float32 arrays, with
  every BatchNorm's ``num_batches_tracked`` written 0 as the JAX exporter
  writes it (the JAX package keeps no such counter).
* ``save_pth`` (:81): ``torch.save({key: state_dict}, path)``, the dict
  layout the reference's loaders read.
* ``export_keras_cgan`` (:125): a Keras 3 ``.keras`` zip of the cGAN
  generator (``CGANKerasGenerator``): the JAX exporter's ``metadata.json``
  and ``config.json`` bytes and a ``model.weights.h5`` with its tree
  (``layers/<keras layer>/vars/<i>``: Conv2D and Conv2DTranspose kernel and
  bias in the Keras layouts, BatchNormalization gamma, beta, moving mean
  and moving variance), written by the port's own HDF5 writer
  (``ckpt/keras.py::write_h5``; the card machine has no h5py).
"""

from __future__ import annotations

import json
import zipfile
from typing import Dict

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.ckpt.keras import write_h5


def export_torch_state_dict(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The flat torch-layout state dict of ``module`` as numpy arrays
    (``num_batches_tracked`` 0)."""
    sd: Dict[str, np.ndarray] = {}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.asarray(0, np.int64)
        else:
            sd[k] = v.detach().to("cpu", torch.float32).numpy().copy()
    return sd


def save_pth(module: torch.nn.Module, path: str,
             key: str = "generator") -> None:
    """Write a torch-loadable ``.pth`` with the reference's dict layout."""
    sd = {k: torch.from_numpy(v)
          for k, v in export_torch_state_dict(module).items()}
    torch.save({key: sd}, path)


# the Keras 3 Sequential config of the cGAN generator (``:95-122``)
_KERAS_GEN_LAYERS = [
    ("input_layer", "InputLayer", {"batch_shape": [None, 256, 256, 3]}),
    ("conv2d", "Conv2D", {"filters": 64, "kernel_size": [4, 4],
                          "strides": [2, 2], "padding": "same",
                          "activation": "linear"}),
    ("leaky_re_lu", "LeakyReLU", {"negative_slope": 0.2}),
    ("conv2d_1", "Conv2D", {"filters": 128, "kernel_size": [4, 4],
                            "strides": [2, 2], "padding": "same",
                            "activation": "linear"}),
    ("batch_normalization", "BatchNormalization",
     {"axis": -1, "momentum": 0.99, "epsilon": 0.001}),
    ("leaky_re_lu_1", "LeakyReLU", {"negative_slope": 0.2}),
    ("conv2d_transpose", "Conv2DTranspose",
     {"filters": 128, "kernel_size": [4, 4], "strides": [2, 2],
      "padding": "same", "activation": "linear"}),
    ("batch_normalization_1", "BatchNormalization",
     {"axis": -1, "momentum": 0.99, "epsilon": 0.001}),
    ("leaky_re_lu_2", "LeakyReLU", {"negative_slope": 0.2}),
    ("conv2d_transpose_1", "Conv2DTranspose",
     {"filters": 64, "kernel_size": [4, 4], "strides": [2, 2],
      "padding": "same", "activation": "linear"}),
    ("batch_normalization_2", "BatchNormalization",
     {"axis": -1, "momentum": 0.99, "epsilon": 0.001}),
    ("leaky_re_lu_3", "LeakyReLU", {"negative_slope": 0.2}),
    ("conv2d_2", "Conv2D", {"filters": 3, "kernel_size": [3, 3],
                            "strides": [1, 1], "padding": "same",
                            "activation": "tanh"}),
]
# the generator's Sequential child index -> Keras layer name, parameterised
# layers only
_KERAS_ORDER = [("0", "conv2d"), ("2", "conv2d_1"),
                ("3", "batch_normalization"), ("5", "conv2d_transpose"),
                ("6", "batch_normalization_1"), ("8", "conv2d_transpose_1"),
                ("9", "batch_normalization_2"), ("11", "conv2d_2")]


def keras_weights_tree(module: torch.nn.Module) -> Dict[str, object]:
    """The ``model.weights.h5`` tree of a ``CGANKerasGenerator``."""
    params, state = convert.state_dict_to_jax_params(module.state_dict(),
                                                     module=module)
    seq, seq_state = params["model"], state.get("model", {})
    layers: Dict[str, object] = {}
    for idx, kname in _KERAS_ORDER:
        p = seq[idx]
        if "kernel" in p:
            vs = [p["kernel"], p["bias"]]
        else:  # gamma, beta, moving_mean, moving_var
            s = seq_state[idx]
            vs = [p["scale"], p["bias"], s["mean"], s["var"]]
        layers[kname] = {"vars": {str(i): np.asarray(v, np.float32)
                                  for i, v in enumerate(vs)}}
    return {"layers": layers}


def export_keras_cgan(module: torch.nn.Module, path: str) -> None:
    """Write a Keras 3 ``.keras`` zip of a ``CGANKerasGenerator``'s
    weights."""
    h5 = write_h5(keras_weights_tree(module))
    config = {
        "module": "keras",
        "class_name": "Sequential",
        "config": {
            "name": "sequential",
            "layers": [
                {"module": "keras.layers", "class_name": cls,
                 "config": {"name": name, **cfg}, "registered_name": None}
                for name, cls, cfg in _KERAS_GEN_LAYERS
            ],
        },
        "registered_name": None,
        "build_config": {"input_shape": [None, 256, 256, 3]},
        "compile_config": {},
    }
    metadata = {"keras_version": "3.0.0", "date_saved": "", "exported_by":
                "celebrity_image_denoiser_tpu"}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("metadata.json", json.dumps(metadata))
        z.writestr("config.json", json.dumps(config))
        z.writestr("model.weights.h5", h5)
