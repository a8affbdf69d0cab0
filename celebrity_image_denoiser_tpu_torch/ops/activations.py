"""Elementwise activations of the port (counterpart of
``celebrity_image_denoiser_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU; the reference uses slope 0.2 throughout."""
    return F.leaky_relu(x, negative_slope)
