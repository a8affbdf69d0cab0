"""cGAN, Keras architecture: the generator the server answers with by
default, and its discriminator.

Port of ``celebrity_image_denoiser_tpu/models/cgan.py``: the generator
(``CGANKerasGenerator:27``) is conv 3→64 4×4 stride 2 → conv 64→128 4×4
stride 2 + BatchNorm → transpose conv 128→128 4×4 stride 2 + BatchNorm →
transpose conv 128→64 4×4 stride 2 + BatchNorm → conv 64→3 3×3 → tanh,
LeakyReLU(0.2) between the layers; Keras' 'same' padding of a 4×4 stride-2
layer on an even input is a padding of 1 on every side.  BatchNorm in
Keras' convention (``ops/norm.py::KerasBatchNorm2d``, eps 1e-3).  Served in
[-1, 1], padded to a multiple of 4.  The discriminator
(``CGANKerasDiscriminator:52``) is conv 64 → conv 128 + BatchNorm → conv
256 + BatchNorm (4×4 stride 2, LeakyReLU(0.2)), then a Linear over the
features flattened in NHWC order (Keras' order), then a sigmoid; it is
ported for the trainer (``ROADMAP.md`` queue 1, item 5) and not served.

Child names equal the JAX param paths (``model.0``, ``model.3``, …,
``features.5``, ``dense``), so the Keras file and JAX trees load strictly
(``ckpt/keras.py``, ``ckpt/convert.py``).

Routes (``models/folded.py``): the 4×4 convs and transpose convs, the
BatchNorms and LeakyReLUs are PyTorch ops on every route, as they were XLA
ops in the JAX package; the tail conv runs on K2 with its bias and no ReLU
on the kernel route (one launch), through K2's plain version on the plain
route, and as the module on the autograd route (the route the int8
calibration hooks and replays: there the tail, a 64→3 conv, stays float).
The first conv takes its input in contiguous NCHW memory, so that cuDNN
sums it alike at every tile shape (``models/folded.py``): on the int8 rung
its output is quantized at the next conv.

The same request gives the same pixels: the PyTorch layers run under
cuDNN's deterministic flag (``core/device.py::deterministic_cudnn``).
cuDNN's default algorithms for the f32 4×4 stride-2 transpose convs need
not sum alike twice, and its deterministic ones took 5–16× as long on the
H100 (``PERF.md`` §6); so the kernel and plain routes run each transpose
conv as a 3×3 conv with an output channel group per output phase, then
depth-to-space (``_phased``), whose forward algorithms are deterministic.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.core.device import deterministic_cudnn
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import nchw, nhwc
from celebrity_image_denoiser_tpu_torch.models.folded import FoldedConvNet
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d, ConvTranspose2d
from celebrity_image_denoiser_tpu_torch.ops.norm import KerasBatchNorm2d
from celebrity_image_denoiser_tpu_torch.ops.quant import d2s_convt4x4_weight


@torch.no_grad()
def reset_keras_parameters(module: nn.Module,
                           generator: Optional[torch.Generator]) -> None:
    """Keras' default init, drawn from ``generator``: glorot-uniform
    weights (fan_in = C_in·k·k, fan_out = C_out·k·k for either conv kind;
    in and out features for a Linear), zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            if isinstance(m, nn.Linear):
                fan_in, fan_out = m.in_features, m.out_features
            else:
                k = m.weight.shape[2] * m.weight.shape[3]
                fan_in, fan_out = m.in_channels * k, m.out_channels * k
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            m.weight.uniform_(-limit, limit, generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def _down(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 4, stride=2, padding=1)


def _up(cin: int, cout: int) -> ConvTranspose2d:
    return ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


class CGANKerasGenerator(FoldedConvNet):
    """Input (N, 3, H, W) in [-1, 1], H and W divisible by 4 (serving pads
    to that); output the same shape through tanh."""

    TAIL = 11  # the 3×3 tail conv's index in ``model``

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(
            _down(3, 64), nn.LeakyReLU(0.2),
            _down(64, 128), KerasBatchNorm2d(128), nn.LeakyReLU(0.2),
            _up(128, 128), KerasBatchNorm2d(128), nn.LeakyReLU(0.2),
            _up(128, 64), KerasBatchNorm2d(64), nn.LeakyReLU(0.2),
            Conv2d(64, 3, 3, padding=1), nn.Tanh())
        reset_keras_parameters(self, generator)

    def forward(self, x: torch.Tensor, *, route: str = "kernel"
                ) -> torch.Tensor:
        self._check_route(route, x)
        x = x.contiguous()  # NCHW memory: see the module docstring
        with deterministic_cudnn():
            if route == "autograd":
                return self.model(x)
            h = x
            for i, layer in enumerate(self.model[:self.TAIL]):
                h = (self._phased(f"model.{i}", layer, h)
                     if isinstance(layer, nn.ConvTranspose2d) else layer(h))
        y = self._conv(f"model.{self.TAIL}", self.model[self.TAIL], None,
                       nhwc(h), relu=False, route=route)
        return torch.tanh(nchw(y))

    def _phased(self, name: str, conv: nn.ConvTranspose2d,
                x: torch.Tensor) -> torch.Tensor:
        """The 4×4 stride-2 padding-1 transpose conv as a 3×3 conv with an
        output channel group per output phase, then depth-to-space (the
        int8 rewrite's arithmetic, ``ops/quant.py``, in float).  The weights
        are laid out once per loaded weights, as ``_folded`` does."""
        ts = (conv.weight, conv.bias)
        stamp = tuple((t.data_ptr(), t._version) for t in ts)
        hit = self._kparams.get((name, "phased"))
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                w3 = d2s_convt4x4_weight(conv.weight.detach().float())
                hit = (stamp, w3.permute(0, 3, 1, 2).contiguous(),
                       conv.bias.detach().float().repeat(4))
            self._kparams[(name, "phased")] = hit
        y = F.conv2d(x, hit[1].to(x.dtype), hit[2].to(x.dtype), padding=1)
        n, c4, h, w = y.shape
        y = y.view(n, 2, 2, c4 // 4, h, w).permute(0, 3, 4, 1, 5, 2)
        return y.reshape(n, c4 // 4, 2 * h, 2 * w)


class CGANKerasDiscriminator(nn.Module):
    """Input (N, 3, H, W) with H and W those given (default 256²); output
    (N,) probabilities."""

    def __init__(self, input_hw: Tuple[int, int] = (256, 256),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h, w = input_hw
        self.features = nn.Sequential(
            _down(3, 64), nn.LeakyReLU(0.2),
            _down(64, 128), KerasBatchNorm2d(128), nn.LeakyReLU(0.2),
            _down(128, 256), KerasBatchNorm2d(256), nn.LeakyReLU(0.2))
        self.dense = nn.Linear(256 * (h // 8) * (w // 8), 1)
        reset_keras_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features(x)
        # Keras flattens NHWC: the Linear's weights follow that order
        y = self.dense(f.permute(0, 2, 3, 1).flatten(1))
        return torch.sigmoid(y).reshape(-1)
