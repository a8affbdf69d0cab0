"""SRGAN generator (×4 super-resolution).

Port of ``celebrity_image_denoiser_tpu/models/srgan.py::SRGANGenerator``
(:19): a 9×9 head conv + PReLU; five blocks conv-BN-PReLU-conv-BN in
sequence (no skip inside a block); a ``mid`` conv whose output is added to
the head's; log2(scale) upscale stages of conv 64→256, PixelShuffle(2),
PReLU; a 9×9 tail conv; tanh.  The scale factor must be a power of two
(``:22``).  Served in the [-1, 1] domain, padded to a multiple of 16.  The
discriminator (``SRGANDiscriminator:58``), which the srgan trainer runs, is
a 3×3 conv ladder 3→64→64 (stride 2)→128→128 (stride 2)→256 with BatchNorm
and LeakyReLU(0.2), a global average pool, 1×1 convs 256→512→1 and a
sigmoid.

Child names equal the JAX param paths (``res_blocks.N.0``, ``mid``,
``upscale.0``, ``upscale.2`` the first stage's PReLU, …).

Routes (``models/folded.py``): on the kernel route the ten block convs
(BatchNorm folded in), ``mid`` and the upscale convs run on K2 with no ReLU
(13 launches at ×4); the pixel shuffle is a copy of the NHWC tensor, as the
JAX function's reshape and transpose are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    discriminator_layers,
    nchw,
    nhwc,
    reset_conv_parameters,
)
from celebrity_image_denoiser_tpu_torch.models.folded import FoldedConvNet
from celebrity_image_denoiser_tpu_torch.ops.activations import PReLU, prelu
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, C·r²) → contiguous (N, H·r, W·r, C) with PyTorch's channel
    order (``ops/pixelshuffle.py:14``): channel c·r² + dy·r + dx lands at
    (dy, dx) of output channel c."""
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c // (r * r))


class SRGANGenerator(FoldedConvNet):
    """Input (N, 3, H, W) in [-1, 1]; output (N, 3, H·s, W·s) through tanh."""

    def __init__(self, scale_factor: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if scale_factor < 1 or (scale_factor & (scale_factor - 1)) != 0:
            raise ValueError(
                f"scale_factor must be a power of two (got {scale_factor})")
        self.scale_factor = scale_factor
        self.initial = nn.Sequential(Conv2d(3, 64, 9, padding=4), PReLU())
        self.res_blocks = nn.Sequential(*[nn.Sequential(
            Conv2d(64, 64, 3, padding=1), nn.BatchNorm2d(64), PReLU(),
            Conv2d(64, 64, 3, padding=1), nn.BatchNorm2d(64))
            for _ in range(5)])
        self.mid = Conv2d(64, 64, 3, padding=1)
        ups = []
        for _ in range(int(math.log2(scale_factor))):
            ups += [Conv2d(64, 256, 3, padding=1), nn.PixelShuffle(2),
                    PReLU()]
        self.upscale = nn.Sequential(*ups)
        self.final = Conv2d(64, 3, 9, padding=4)
        reset_conv_parameters(self, generator)

    def forward(self, x: torch.Tensor, *, route: str = "kernel"
                ) -> torch.Tensor:
        self._check_route(route, x)
        x0 = self.initial(x.contiguous())  # NCHW memory: see folded.py
        if route == "autograd":
            y = self.upscale(self.mid(self.res_blocks(x0)) + x0)
            return torch.tanh(self.final(y))
        h0 = nhwc(x0)
        t = h0
        for i, (conv0, bn1, act, conv3, bn4) in enumerate(self.res_blocks):
            t = self._conv(f"res_blocks.{i}.0", conv0, bn1, t, False, route)
            t = nhwc(prelu(nchw(t), act.weight))
            t = self._conv(f"res_blocks.{i}.3", conv3, bn4, t, False, route)
        t = self._conv("mid", self.mid, None, t, False, route) + h0
        for i in range(0, len(self.upscale), 3):
            conv, shuffle, act = self.upscale[i:i + 3]
            t = self._conv(f"upscale.{i}", conv, None, t, False, route)
            t = pixel_shuffle_nhwc(t, shuffle.upscale_factor)
            t = nhwc(prelu(nchw(t), act.weight))
        return torch.tanh(self.final(nchw(t)))


class SRGANDiscriminator(nn.Module):
    """Input (N, 3, H, W) in [-1, 1]; output (N,) probabilities.  Child names
    equal the JAX param paths (``model.0`` … ``model.17``); float32
    parameters cast to x's dtype at use, BatchNorm in the torch convention
    (``models/denoise_unet.py::discriminator_layers``)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(
            nn.Conv2d(3, 64, 3, padding=1), nn.LeakyReLU(0.2),
            nn.Conv2d(64, 64, 3, stride=2, padding=1), nn.BatchNorm2d(64),
            nn.LeakyReLU(0.2),
            nn.Conv2d(64, 128, 3, padding=1), nn.BatchNorm2d(128),
            nn.LeakyReLU(0.2),
            nn.Conv2d(128, 128, 3, stride=2, padding=1), nn.BatchNorm2d(128),
            nn.LeakyReLU(0.2),
            nn.Conv2d(128, 256, 3, padding=1), nn.BatchNorm2d(256),
            nn.LeakyReLU(0.2),
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(256, 512, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(512, 1, 1), nn.Sigmoid())
        reset_conv_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return discriminator_layers(self.model, x, self.training).reshape(-1)
