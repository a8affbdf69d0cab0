"""ESRGAN generator — a same-resolution enhancer.

Port of ``celebrity_image_denoiser_tpu/models/esrgan.py::ESRGANGenerator``
(:39) and ``ResidualBlock`` (:20): a 9×9 head conv + PReLU, residual blocks
``x + conv-BN-PReLU-conv-BN(x)``, a 9×9 tail conv applied to ``head +
trunk``, no output activation and no upscale.  Served in the [0, 1]
domain, unpadded.  The discriminator (``ESRGANDiscriminator:148``), which
the esrgan trainer runs, is four 3×3 stride-2 convs 3→64→128→256→512 with
LeakyReLU(0.2), then a Linear over the features flattened in NCHW order
(torch's, ``models.py:69`` of the reference) to one logit; its width comes
from ``input_hw``.

Child names equal the JAX param paths (``initial.1`` is the PReLU,
``residuals.N.block.0`` a block's first conv), which are the reference
``.pth`` names too.

Routes (``models/folded.py``): on the kernel route each block conv runs on
K2 with its BatchNorm folded in and no ReLU (16 launches for 8 blocks);
PReLU and the residual adds are tensor ops.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    nchw,
    nhwc,
    reset_conv_parameters,
)
from celebrity_image_denoiser_tpu_torch.models.folded import FoldedConvNet
from celebrity_image_denoiser_tpu_torch.ops.activations import (
    PReLU,
    leaky_relu,
    prelu,
)
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d
from celebrity_image_denoiser_tpu_torch.ops.norm import BatchNorm2d


class ResidualBlock(nn.Module):
    """x + conv-BN-PReLU-conv-BN(x)."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = nn.Sequential(
            Conv2d(channels, channels, 3, 1, 1), BatchNorm2d(channels),
            PReLU(),
            Conv2d(channels, channels, 3, 1, 1), BatchNorm2d(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class ESRGANGenerator(FoldedConvNet):
    """Input (N, 3, H, W) in [0, 1], any H, W; output the same shape."""

    def __init__(self, num_residuals: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.initial = nn.Sequential(Conv2d(3, 64, 9, 1, 4), PReLU())
        self.residuals = nn.Sequential(
            *[ResidualBlock(64) for _ in range(num_residuals)])
        self.final = Conv2d(64, 3, 9, 1, 4)
        reset_conv_parameters(self, generator)

    def forward(self, x: torch.Tensor, *, route: str = "kernel"
                ) -> torch.Tensor:
        self._check_route(route, x)
        x1 = self.initial(x.contiguous())  # NCHW memory: see folded.py
        if route == "autograd":
            x2 = self.residuals(x1)
        else:
            t = nhwc(x1)
            for i, blk in enumerate(self.residuals):
                conv0, bn1, act, conv3, bn4 = blk.block
                name = f"residuals.{i}.block"
                y = self._conv(f"{name}.0", conv0, bn1, t, False, route)
                y = nhwc(prelu(nchw(y), act.weight))
                y = self._conv(f"{name}.3", conv3, bn4, y, False, route)
                t = t + y
            x2 = nchw(t)
        return self.final(x1 + x2)


class ESRGANDiscriminator(nn.Module):
    """Input (N, 3, H, W) in [0, 1] with (H, W) = ``input_hw``; output (N,)
    logits.  Child names equal the JAX param paths (``conv1`` … ``conv4``,
    ``fc``); float32 parameters cast to x's dtype at use."""

    def __init__(self, input_hw: Tuple[int, int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w = input_hw
        for _ in range(4):  # 3×3, stride 2, padding 1
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        self.flat_dim = 512 * h * w
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1)
        self.conv2 = Conv2d(64, 128, 3, stride=2, padding=1)
        self.conv3 = Conv2d(128, 256, 3, stride=2, padding=1)
        self.conv4 = Conv2d(256, 512, 3, stride=2, padding=1)
        self.fc = nn.Linear(self.flat_dim, 1)
        reset_conv_parameters(self, generator)
        with torch.no_grad():  # torch's Linear init: U(±1/sqrt(in))
            bound = 1.0 / math.sqrt(self.flat_dim)
            for t in (self.fc.weight, self.fc.bias):
                t.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = leaky_relu(conv(x), 0.2)
        # torch flattens NCHW: the Linear's weights follow that order
        y = F.linear(x.flatten(1), self.fc.weight.to(x.dtype),
                     self.fc.bias.to(x.dtype))
        return y.reshape(-1)
