"""VGG16 feature tower for the perceptual loss and distance.

Port of ``celebrity_image_denoiser_tpu/models/vgg.py::VGGFeatures`` (:17):
torchvision's ``vgg16.features[:16]``, conv1_1 … relu3_3, the reference's
``VGGPerceptualLoss`` tower (``training.py:101-111``).  The children are
indexed as torchvision indexes them (``slice.0`` … ``slice.15``, the JAX
param paths), so the shipped ``weights/perceptual`` tower (section ``vgg``)
and a torchvision ``features.<i>.weight`` state_dict both load
(``metrics/perceptual.py``).  NCHW in and out; the convs cast their float32
weights to the input's dtype (``ops/conv.py::Conv2d``), so the tower runs in
bfloat16 when given bfloat16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    reset_conv_parameters,
)
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d

# (index, layer) of features[:16]: 'M' a 2×2 max-pool, 'R' a ReLU, an int
# the output channels of a 3×3 conv
_CFG = (64, "R", 64, "R", "M", 128, "R", 128, "R", "M", 256, "R", 256, "R",
        256, "R")


class VGGFeatures(nn.Module):
    """Input (N, 3, H, W); output the relu3_3 features (N, 256, H/4, W/4)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers, cin = [], 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            elif v == "R":
                layers.append(nn.ReLU())
            else:
                layers.append(Conv2d(cin, v, 3, padding=1))
                cin = v
        self.slice = nn.Sequential(*layers)
        reset_conv_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.slice(x)
