"""Denoise GAN models — the flagship family — and the serving step.

Port of ``celebrity_image_denoiser_tpu/models/denoise_unet.py::
DenoiseGenerator`` (:21-72): (3→64→64) ↓ (64→128→128) ↓ bottleneck
(128→256→256), 2×2 stride-2 transpose-conv ups with skip concats (decoder
half first, :64,70), 3×3 convs, ReLU, tanh output.  The serving copy's
skip-crop (:62-63,68-69) is kept: when the upsampled tensor is smaller than
the encoder skip (odd sizes after pooling), the skip is cropped to match.

Child names equal the JAX param paths (``down1.0``, ``up2``, ``upconv1.2``,
…), so the state_dict of this module is the JAX tree with ``kernel`` renamed
``weight`` (``ckpt/convert.py``) and a reference ``.pth`` loads strictly.

Dispatch.  The module is logically NCHW with OIHW weights; on the card the
activations live in ``torch.channels_last``, so each NHWC view handed to the
kernels is contiguous without a copy.  The ten 3×3 convs run through
``ops/cuda``: the four ReLU pairs ``down1``, ``down2``, ``bottleneck`` and
``upconv2`` through ``double_conv3x3_relu`` (4 launches per forward), and
``upconv1``'s two convs through ``conv3x3_bias_relu`` (2 launches; the last
without ReLU).  Transpose convs, max-pools, the concats and the tanh are
PyTorch ops, as they were XLA ops in the JAX package.  On a CPU tensor every
kernel wrapper runs its plain version.

``forward(x, route=...)`` names the way through the 3×3 convs:

* ``"kernel"`` (default) — the kernel wrappers, for inference;
* ``"plain"`` — the kernels' plain versions on any device, the reference
  ``chip_smoke.py`` holds the kernel route against on the card.  Both run
  detached kernel-layout weights and have no backward: with autograd
  recording and a trainable parameter or input they raise;
* ``"autograd"`` — the module's own conv modules, each computing through
  ``ops/conv.py`` (PyTorch's differentiable convs), weights cast to the
  activation dtype at use and the bias added in that dtype, as the JAX
  layers run under AD (``ops/conv.py:76-101``).  The trainer's step takes
  this route, as the JAX trainer differentiates through XLA's convs and no
  Pallas kernel; so do int8 calibration (forward hooks on those modules)
  and the generic int8 transform (``ops/quant.py``).

``DenoiseDiscriminator`` (:75-101) is the trainer's critic: 4 convs with
BatchNorm and LeakyReLU(0.2), a global average pool, a 1×1 conv and a
sigmoid; it has no Pallas kernel in the JAX package and none here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.ops.activations import leaky_relu
from celebrity_image_denoiser_tpu_torch.ops.conv import (
    Conv2d,
    ConvTranspose2d,
    conv2d_layer,
)
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3, double_conv
from celebrity_image_denoiser_tpu_torch.ops.norm import BatchNorm2d, batch_norm
from celebrity_image_denoiser_tpu_torch.ops.pool import (
    global_avg_pool,
    max_pool2d,
)

ROUTES = ("kernel", "plain", "autograd")


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC (a free view for channels_last)."""
    return t.permute(0, 2, 3, 1).contiguous()


def _nhwc_view(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """NCHW tensor (or None) -> NHWC view with contiguous channels: no copy
    for a crop of channels_last memory, a copy otherwise."""
    if t is None:
        return None
    v = t.permute(0, 2, 3, 1)
    return v if v.stride(3) == 1 else v.contiguous()


def nchw(t: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return t.permute(0, 3, 1, 2)


@torch.no_grad()
def reset_conv_parameters(module: nn.Module,
                           generator: Optional[torch.Generator]) -> None:
    """PyTorch's default conv init — U(±1/sqrt(fan_in)) for weight and bias
    (if any), fan_in from weight dim 1 (C_out for a transpose conv, the
    quirk ``nn/layers.py:87-88`` keeps) — drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = m.weight.shape[2:]
            bound = 1.0 / math.sqrt(m.weight.shape[1] * kh * kw)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)


class DenoiseGenerator(nn.Module):
    """Input (N, 3, H, W) in [-1, 1], H and W best divisible by 4 (serving
    pads to that); output the same shape through tanh."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.down1 = nn.Sequential(
            Conv2d(3, 64, 3, padding=1), nn.ReLU(),
            Conv2d(64, 64, 3, padding=1), nn.ReLU())
        self.down2 = nn.Sequential(
            Conv2d(64, 128, 3, padding=1), nn.ReLU(),
            Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.bottleneck = nn.Sequential(
            Conv2d(128, 256, 3, padding=1), nn.ReLU(),
            Conv2d(256, 256, 3, padding=1), nn.ReLU())
        self.up2 = ConvTranspose2d(256, 128, 2, stride=2)
        self.upconv2 = nn.Sequential(
            Conv2d(256, 128, 3, padding=1), nn.ReLU(),
            Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.up1 = ConvTranspose2d(128, 64, 2, stride=2)
        self.upconv1 = nn.Sequential(
            Conv2d(128, 64, 3, padding=1), nn.ReLU(),
            Conv2d(64, 3, 3, padding=1))
        # kernel-layout weights (HWIO in the activation dtype, f32 bias),
        # made once per loaded weights; not part of the state_dict
        self._kparams: Dict[Tuple[str, torch.dtype], tuple] = {}
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_parameters(self, generator)

    def _kernel_params(self, name: str, conv: nn.Conv2d, dtype: torch.dtype):
        """(HWIO weight in ``dtype``, f32 bias, the weight's
        ``conv3x3.tf32_weights`` copy in f32 else None) for ``conv``,
        rebuilt only when the parameters change (load_state_dict and
        in-place optimiser updates bump ``_version``, ``.to()`` replaces the
        storage)."""
        w, b = conv.weight, conv.bias
        stamp = (w.data_ptr(), w._version, b.data_ptr(), b._version)
        hit = self._kparams.get((name, dtype))
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hwio = w.detach().permute(2, 3, 1, 0).to(dtype).contiguous()
                bias = b.detach().float().contiguous()
                split = (conv3x3.tf32_weights(hwio)
                         if dtype == torch.float32 else None)
            hit = (stamp, hwio, bias, split)
            self._kparams[(name, dtype)] = hit
        return hit[1:]

    def _pair(self, name: str, x: torch.Tensor, route: str,
              skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv pair ``name`` on x, or on cat([x, skip]) (channels): the
        kernel and plain routes take the two halves apart, so that the
        kernel can read them in place."""
        seq = getattr(self, name)
        if route == "autograd":
            if skip is not None:
                x = torch.cat([x, skip], dim=1)
            return torch.relu(seq[2](torch.relu(seq[0](x))))
        w1, b1, s1 = self._kernel_params(f"{name}.0", seq[0], x.dtype)
        w2, b2, s2 = self._kernel_params(f"{name}.2", seq[2], x.dtype)
        if route == "plain":
            return nchw(double_conv.double_conv3x3_relu_plain(
                nhwc(x), w1, b1, w2, b2, x2=_nhwc_view(skip)))
        return nchw(double_conv.double_conv3x3_relu(
            nhwc(x), w1, b1, w2, b2, x2=_nhwc_view(skip), w1_tf32=s1,
            w2_tf32=s2))

    def _single(self, idx: int, x: torch.Tensor, relu: bool, route: str,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = self.upconv1[idx]
        if route == "autograd":
            if skip is not None:
                x = torch.cat([x, skip], dim=1)
            y = conv(x)
            return torch.relu(y) if relu else y
        w, b, split = self._kernel_params(f"upconv1.{idx}", conv, x.dtype)
        if route == "plain":
            return nchw(conv3x3.conv3x3_bias_relu_plain(
                nhwc(x), w, b, relu=relu, x2=_nhwc_view(skip)))
        return nchw(conv3x3.conv3x3_bias_relu(
            nhwc(x), w, b, relu=relu, x2=_nhwc_view(skip), kernel_tf32=split))

    def forward(self, x: torch.Tensor, *, route: str = "kernel"
                ) -> torch.Tensor:
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; choose from {ROUTES}")
        if route != "autograd":
            conv3x3.refuse_grad(f"DenoiseGenerator route={route!r}", x,
                                *self.parameters())
        e1 = self._pair("down1", x, route)
        e2 = self._pair("down2", max_pool2d(e1), route)
        b = self._pair("bottleneck", max_pool2d(e2), route)

        d2 = self.up2(b)
        if d2.shape[2:] != e2.shape[2:]:  # skip-crop, JAX :62-63
            e2 = e2[:, :, : d2.shape[2], : d2.shape[3]]
        d2 = self._pair("upconv2", d2, route, skip=e2)

        d1 = self.up1(d2)
        if d1.shape[2:] != e1.shape[2:]:  # skip-crop, JAX :68-69
            e1 = e1[:, :, : d1.shape[2], : d1.shape[3]]
        d1 = self._single(0, d1, relu=True, route=route, skip=e1)
        d1 = self._single(2, d1, relu=False, route=route)
        return torch.tanh(d1)


class DenoiseDiscriminator(nn.Module):
    """Input (N, 3, H, W); output (N,) probabilities.  Child names equal the
    JAX param paths (``model.0`` … ``model.12``); the activations and the
    pool hold no parameters and are plain functions in ``forward``.

    The float32 parameters are cast to x's dtype at use and each conv's bias
    is added in that dtype (``conv2d_layer``); BatchNorm takes its batch
    statistics in float32 and keeps float32 running statistics, updated in
    train mode on every forward."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(
            nn.Conv2d(3, 64, 3, padding=1),
            nn.LeakyReLU(0.2),
            nn.Conv2d(64, 64, 3, stride=2, padding=1),
            BatchNorm2d(64),
            nn.LeakyReLU(0.2),
            nn.Conv2d(64, 128, 3, padding=1),
            BatchNorm2d(128),
            nn.LeakyReLU(0.2),
            nn.Conv2d(128, 128, 3, stride=2, padding=1),
            BatchNorm2d(128),
            nn.LeakyReLU(0.2),
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(128, 1, 1),
            nn.Sigmoid())
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_conv_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return discriminator_layers(self.model, x, self.training).reshape(-1)


def discriminator_layers(model: nn.Sequential, x: torch.Tensor,
                         training: bool) -> torch.Tensor:
    """The layers of a torch-family discriminator's ``model`` (convs,
    BatchNorm, LeakyReLU, the global average pool, the sigmoid) as the JAX
    layers run them: ``conv2d_layer``, ``batch_norm`` (batch statistics and
    an in-place running update in train mode; those of the layer's
    ``group``'s global batch when it has one)."""
    for layer in model:
        if isinstance(layer, nn.Conv2d):
            x = conv2d_layer(x, layer.weight, layer.bias,
                             stride=layer.stride, padding=layer.padding)
        elif isinstance(layer, nn.BatchNorm2d):
            x = batch_norm(x, layer.weight, layer.bias, layer.running_mean,
                           layer.running_var, train=training, eps=layer.eps,
                           momentum=layer.momentum,
                           group=getattr(layer, "group", None))
        elif isinstance(layer, nn.LeakyReLU):
            x = leaky_relu(x, layer.negative_slope)
        elif isinstance(layer, nn.AdaptiveAvgPool2d):
            x = global_avg_pool(x)
        elif isinstance(layer, nn.Sigmoid):
            x = torch.sigmoid(x)
        else:
            raise TypeError(f"no JAX counterpart for {type(layer).__name__}")
    return x


# bf16(2/255): the JAX step multiplies a bf16 array by the Python float 2/255,
# which JAX rounds to the array's dtype first (a weak-typed scalar), so the
# constant is 0.00787353515625, not 2/255 — kept to serve the same pixels
_BF16_2_OVER_255 = 0.00787353515625


@torch.inference_mode()
def serve_step(model: DenoiseGenerator, x_uint8: torch.Tensor, *,
               device="cuda") -> torch.Tensor:
    """The bf16 serving step of ``bench.py:119-124``: uint8 NHWC → [-1, 1] →
    U-Net → clip(y·0.5+0.5) → **round** → uint8 NHWC.  (Serving over HTTP
    truncates instead, ``serve/handlers.py``.)  ``model`` must already be
    bf16 on ``device``; every op rounds to bf16 as the JAX step does."""
    dev = resolve_device(device)
    if x_uint8.dtype != torch.uint8 or x_uint8.dim() != 4 \
            or x_uint8.shape[3] != 3:
        raise ValueError(f"x must be uint8 (N, H, W, 3), got {x_uint8.dtype} "
                         f"{tuple(x_uint8.shape)}")
    p = model.down1[0].weight
    if p.dtype != torch.bfloat16 or p.device.type != dev.type:
        raise ValueError(f"model must be bf16 on {dev}, got {p.dtype} on "
                         f"{p.device}")
    x = x_uint8.to(dev).to(torch.bfloat16) * _BF16_2_OVER_255 - 1.0
    y = model(nchw(x))
    y01 = torch.clamp(y * 0.5 + 0.5, 0.0, 1.0)
    return nhwc(torch.round(y01 * 255.0).to(torch.uint8))
