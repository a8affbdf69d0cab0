"""Convolution primitives of the port: plain PyTorch (cuDNN on the card).

Counterpart of ``celebrity_image_denoiser_tpu/ops/conv.py``: ``conv2d`` (:57)
and ``conv2d_transpose`` (:104), in PyTorch's NCHW/OIHW idiom.  The 3×3
convs of the U-Net's main path do not come through here on the card — they
run the hand-written kernels in ``ops/cuda/``, whose plain versions use
``conv2d``.  The transpose conv was an XLA conv in the JAX package too (no
Pallas kernel), so it stays a library call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *, padding=0) -> torch.Tensor:
    """``nn.Conv2d`` semantics, stride 1; x (N, C_in, H, W), weight OIHW."""
    return F.conv2d(x, weight, bias, padding=padding)


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *, stride=1
                     ) -> torch.Tensor:
    """``nn.ConvTranspose2d`` semantics, no padding; weight (C_in, C_out,
    kH, kW); output size (in - 1) * stride + k, as in the JAX op."""
    return F.conv_transpose2d(x, weight, bias, stride=stride)
