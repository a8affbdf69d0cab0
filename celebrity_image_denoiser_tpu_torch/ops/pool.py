"""Pooling of the port (counterpart of ``celebrity_image_denoiser_tpu/
ops/pool.py::max_pool2d:23``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pooling with stride = window and floor division of the spatial
    dims (the JAX VALID ``reduce_window``; ``nn.MaxPool2d(window)``).  Keeps
    ``channels_last`` memory when given it."""
    return F.max_pool2d(x, window, window)
