"""Denoise U-Net generator — the flagship family — and its serving step.

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
kernel wrapper runs its plain version; ``forward(x, plain=True)`` runs the
plain versions on any device — the reference ``chip_smoke.py`` holds the
kernel path against on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.ops.conv import conv2d_transpose
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3, double_conv
from celebrity_image_denoiser_tpu_torch.ops.pool import max_pool2d


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC (a free view for channels_last)."""
    return t.permute(0, 2, 3, 1).contiguous()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return t.permute(0, 3, 1, 2)


class DenoiseGenerator(nn.Module):
    """Input (N, 3, H, W) in [-1, 1], H and W best divisible by 4 (serving
    pads to that); output the same shape through tanh."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.down1 = nn.Sequential(
            nn.Conv2d(3, 64, 3, padding=1), nn.ReLU(),
            nn.Conv2d(64, 64, 3, padding=1), nn.ReLU())
        self.down2 = nn.Sequential(
            nn.Conv2d(64, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.bottleneck = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())
        self.up2 = nn.ConvTranspose2d(256, 128, 2, stride=2)
        self.upconv2 = nn.Sequential(
            nn.Conv2d(256, 128, 3, padding=1), nn.ReLU(),
            nn.Conv2d(128, 128, 3, padding=1), nn.ReLU())
        self.up1 = nn.ConvTranspose2d(128, 64, 2, stride=2)
        self.upconv1 = nn.Sequential(
            nn.Conv2d(128, 64, 3, padding=1), nn.ReLU(),
            nn.Conv2d(64, 3, 3, padding=1))
        # kernel-layout weights (HWIO in the activation dtype, f32 bias),
        # made once per loaded weights; not part of the state_dict
        self._kparams: Dict[Tuple[str, torch.dtype], tuple] = {}
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """PyTorch's default conv init — U(±1/sqrt(fan_in)) for weight and
        bias, fan_in from weight dim 1 (C_out for a transpose conv, the
        quirk ``nn/layers.py:87-88`` keeps) — drawn from ``generator``."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                kh, kw = m.weight.shape[2:]
                bound = 1.0 / math.sqrt(m.weight.shape[1] * kh * kw)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)

    def _kernel_params(self, name: str, conv: nn.Conv2d, dtype: torch.dtype):
        """(HWIO weight in ``dtype``, f32 bias) for ``conv``, rebuilt only
        when the parameters change (load_state_dict bumps ``_version``,
        ``.to()`` replaces the storage)."""
        w, b = conv.weight, conv.bias
        stamp = (w.data_ptr(), w._version, b.data_ptr(), b._version)
        hit = self._kparams.get((name, dtype))
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hwio = w.detach().permute(2, 3, 1, 0).to(dtype).contiguous()
                bias = b.detach().float().contiguous()
            hit = (stamp, hwio, bias)
            self._kparams[(name, dtype)] = hit
        return hit[1], hit[2]

    def _pair(self, name: str, x: torch.Tensor, plain: bool) -> torch.Tensor:
        seq = getattr(self, name)
        w1, b1 = self._kernel_params(f"{name}.0", seq[0], x.dtype)
        w2, b2 = self._kernel_params(f"{name}.2", seq[2], x.dtype)
        fn = (double_conv.double_conv3x3_relu_plain if plain
              else double_conv.double_conv3x3_relu)
        return _nchw(fn(_nhwc(x), w1, b1, w2, b2))

    def _single(self, idx: int, x: torch.Tensor, relu: bool,
                plain: bool) -> torch.Tensor:
        w, b = self._kernel_params(f"upconv1.{idx}", self.upconv1[idx],
                                   x.dtype)
        fn = (conv3x3.conv3x3_bias_relu_plain if plain
              else conv3x3.conv3x3_bias_relu)
        return _nchw(fn(_nhwc(x), w, b, relu=relu))

    def _up(self, up: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        return conv2d_transpose(x, up.weight.to(x.dtype), up.bias.to(x.dtype),
                                stride=2)

    def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        e1 = self._pair("down1", x, plain)
        e2 = self._pair("down2", max_pool2d(e1), plain)
        b = self._pair("bottleneck", max_pool2d(e2), plain)

        d2 = self._up(self.up2, b)
        if d2.shape[2:] != e2.shape[2:]:  # skip-crop, JAX :62-63
            e2 = e2[:, :, : d2.shape[2], : d2.shape[3]]
        d2 = self._pair("upconv2", torch.cat([d2, e2], dim=1), plain)

        d1 = self._up(self.up1, d2)
        if d1.shape[2:] != e1.shape[2:]:  # skip-crop, JAX :68-69
            e1 = e1[:, :, : d1.shape[2], : d1.shape[3]]
        d1 = torch.cat([d1, e1], dim=1)
        d1 = self._single(0, d1, relu=True, plain=plain)
        d1 = self._single(2, d1, relu=False, plain=plain)
        return torch.tanh(d1)


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
    y = model(_nchw(x))
    y01 = torch.clamp(y * 0.5 + 0.5, 0.0, 1.0)
    return _nhwc(torch.round(y01 * 255.0).to(torch.uint8))
