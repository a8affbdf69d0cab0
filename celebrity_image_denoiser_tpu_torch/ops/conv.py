"""Convolution primitives of the port: plain PyTorch (cuDNN on the card).

Counterpart of ``celebrity_image_denoiser_tpu/ops/conv.py``: ``conv2d`` (:57)
and ``conv2d_transpose`` (:104), in PyTorch's NCHW/OIHW idiom.  The 3×3
convs of the U-Net's main path do not come through here on the card — they
run the hand-written kernels in ``ops/cuda/``, whose plain versions use
``conv2d``.  The transpose conv was an XLA conv in the JAX package too (no
Pallas kernel), so it stays a library call.  Training differentiates through
these functions (``conv2d_layer``), as the JAX trainer differentiates through
XLA's convs and never through a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
    y = F.conv2d(x, weight.to(x.dtype), None, stride=stride, padding=padding)
    if bias is not None:
        y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    return y


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, stride=1
                     ) -> torch.Tensor:
    """``nn.ConvTranspose2d`` semantics, no padding; weight (C_in, C_out,
    kH, kW); output size (in - 1) * stride + k, as in the JAX op."""
    return F.conv_transpose2d(x, weight, bias, stride=stride)
