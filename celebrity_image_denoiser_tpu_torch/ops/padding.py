"""Spatial padding and cropping of NHWC batches (counterpart of
``celebrity_image_denoiser_tpu/ops/padding.py``): the serving pad-to-divisor
and crop-back contract, with ``core/config.py::get_padding``'s (left, top,
right, bottom) order."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pad_nhwc(x: torch.Tensor, padding: Tuple[int, int, int, int],
             value: float = 0.0) -> torch.Tensor:
    """``pad_nhwc:17``: padding = (left, top, right, bottom), PIL /
    torchvision order; constant ``value``."""
    left, top, right, bottom = padding
    return F.pad(x, (0, 0, left, right, top, bottom), mode="constant",
                 value=value)


def crop_nhwc(x: torch.Tensor, padding: Tuple[int, int, int, int],
              out_size: Tuple[int, int]) -> torch.Tensor:
    """``crop_nhwc:26``: the region ``pad_nhwc(padding)`` added, cropped
    back; ``out_size`` = (width, height) of the original image (PIL
    convention)."""
    left, top, _, _ = padding
    w, h = out_size
    return x[:, top:top + h, left:left + w, :]
