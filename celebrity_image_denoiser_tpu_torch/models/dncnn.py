"""DnCNN — the blind-σ residual denoiser.

Port of ``celebrity_image_denoiser_tpu/models/dncnn.py::DnCNN`` (:15): the
DnCNN-B layout, Conv+ReLU, (depth-2)×(Conv without bias + BatchNorm +
ReLU), Conv without bias; the network predicts the noise residual and the
output is ``x - residual``.  Served in the [0, 1] domain, unpadded.

Child names equal the JAX param paths (``body.0``, ``body.3``, …), so the
shipped npz and a reference ``.pth`` load strictly (``ckpt/convert.py``).

Routes (``models/folded.py``): on the kernel route the depth-1 conv+ReLU
layers run in pairs on K3 (eight launches at depth 17) and the last conv on
K2 with a zero bias and no ReLU (one launch).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    nchw,
    nhwc,
    reset_conv_parameters,
)
from celebrity_image_denoiser_tpu_torch.models.folded import FoldedConvNet
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d


class DnCNN(FoldedConvNet):
    """Input (N, 3, H, W) in [0, 1], any H, W; output the same shape."""

    def __init__(self, depth: int = 17, channels: int = 64,
                 image_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = [Conv2d(image_channels, channels, 3, padding=1), nn.ReLU()]
        for _ in range(depth - 2):
            layers += [Conv2d(channels, channels, 3, padding=1, bias=False),
                       nn.BatchNorm2d(channels), nn.ReLU()]
        layers.append(Conv2d(channels, image_channels, 3, padding=1,
                             bias=False))
        self.body = nn.Sequential(*layers)
        # (name, conv, bn or None) of each conv, in order
        self._plan = []
        for i, layer in enumerate(layers):
            if isinstance(layer, nn.Conv2d):
                nxt = layers[i + 1] if i + 1 < len(layers) else None
                bn = nxt if isinstance(nxt, nn.BatchNorm2d) else None
                self._plan.append((f"body.{i}", layer, bn))
        reset_conv_parameters(self, generator)

    def forward(self, x: torch.Tensor, *, route: str = "kernel"
                ) -> torch.Tensor:
        self._check_route(route, x)
        if route == "autograd":
            return x - self.body(x)
        *relu_convs, last = self._plan
        h = nhwc(x)
        for i in range(0, len(relu_convs) - 1, 2):
            h = self._pair(relu_convs[i], relu_convs[i + 1], h, route)
        if len(relu_convs) % 2:
            h = self._conv(*relu_convs[-1], h, relu=True, route=route)
        residual = self._conv(*last, h, relu=False, route=route)
        return x - nchw(residual)
