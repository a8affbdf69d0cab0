"""Convolution primitives of the port: plain PyTorch (cuDNN on the card).

Counterpart of ``celebrity_image_denoiser_tpu/ops/conv.py``: ``conv2d`` (:57)
and ``conv2d_transpose`` (:104), in PyTorch's NCHW/OIHW idiom.  The 3×3
convs of the U-Net's main path do not come through here on the card — they
run the hand-written kernels in ``ops/cuda/``, whose plain versions use
``conv2d``.  The transpose conv was an XLA conv in the JAX package too (no
Pallas kernel), so it stays a library call.  Training differentiates through
these functions (``conv2d_layer``), as the JAX trainer differentiates through
XLA's convs and never through a Pallas kernel.

``conv2d_layer`` and ``conv2d_transpose`` consult ``ops/quant.py::
conv_hook`` before their float conv, as the JAX package's ``ops.conv2d``
does: under the generic int8 transform's replay the hook returns the int8
path's output, and the layer adds its bias to that instead.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.ops import quant


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, padding=0) -> torch.Tensor:
    """``nn.Conv2d`` semantics, stride 1; x (N, C_in, H, W), weight OIHW."""
    return F.conv2d(x, weight, bias, padding=padding)


def conv2d_layer(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], *, stride=1, padding=0
                 ) -> torch.Tensor:
    """A conv layer as the JAX layers run it under AD (``ops/conv.py:
    76-101``): float32 master ``weight`` cast to x's dtype at use, the conv's
    output in that dtype, then ``bias`` added in that dtype (for bfloat16
    that is a second rounding, where a fused bias would round once).
    Differentiable in x, weight and bias."""
    y = quant.conv_hook(
        x, weight,
        lambda xq, wq, ws, rw: quant.int8_conv2d(xq, wq, ws, stride,
                                                 padding, rw),
        lambda xf, wf: F.conv2d(xf, wf, None, stride=stride, padding=padding))
    if y is None:
        y = F.conv2d(x, weight.to(x.dtype), None, stride=stride,
                     padding=padding)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return y


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, stride=1,
                     padding=0) -> torch.Tensor:
    """``nn.ConvTranspose2d`` semantics; weight (C_in, C_out, kH, kW);
    output size (in - 1) * stride - 2 * padding + k, as in the JAX op
    (``ops/conv.py:104-144``)."""
    y = quant.conv_hook(
        x, weight,
        lambda xq, wq, ws, rw: quant.int8_conv_transpose2d(
            xq, wq, ws, stride, padding, rw),
        lambda xf, wf: F.conv_transpose2d(xf, wf, None, stride=stride,
                                          padding=padding))
    if y is None:
        return F.conv_transpose2d(x, weight, bias, stride=stride,
                                  padding=padding)
    return y if bias is None else y + bias.to(y.dtype).view(1, -1, 1, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs as the JAX conv layer runs: ``conv2d_layer``
    (weights cast to x's dtype, bias added in that dtype, the int8 replay
    consulted first)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_layer(x, self.weight, self.bias, stride=self.stride,
                            padding=self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (no output padding) with its parameters cast
    to x's dtype at use, through ``conv2d_transpose``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_transpose(x, self.weight.to(x.dtype),
                                self.bias.to(x.dtype), stride=self.stride,
                                padding=self.padding)
