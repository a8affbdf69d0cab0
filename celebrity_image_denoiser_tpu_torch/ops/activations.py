"""Elementwise activations of the port (counterpart of
``celebrity_image_denoiser_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU; the reference uses slope 0.2 throughout."""
    return F.leaky_relu(x, negative_slope)


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """PReLU with a learnable slope (``prelu:19``): ``where(x >= 0, x,
    x·slope)``, the slope cast to x's dtype, broadcast over the channel axis
    of an NCHW tensor when it has one value per channel, else over every
    element.  The JAX package names the slope ``alpha``; PyTorch's
    ``nn.PReLU`` names it ``weight``."""
    w = weight.to(x.dtype)
    if w.numel() > 1 and x.dim() > 1:
        w = w.view((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, x * w)


class PReLU(nn.PReLU):
    """``nn.PReLU`` (one shared slope, 0.25 at init) computing as the JAX
    layer does (``prelu``), so that both packages give the same bits."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.weight)
