"""Separable image resize, the function ``jax.image.resize`` computes.

Port of ``celebrity_image_denoiser_tpu/ops/resize.py::resize`` (:16) for
its bicubic and lanczos3 methods.  Each resized axis gets a
weight matrix built the way ``jax.image.scale_and_translate`` builds it:
output sample ``j`` sits at ``(j + 0.5) / scale - 0.5`` in input
coordinates; the kernel (Keys cubic with a = -0.5, or Lanczos-3) is taken
at the distance to each input sample, widened by ``1 / scale`` on a
downscale when ``antialias`` is set; each output sample's weights are
normalised to sum 1; and an output sample that lies outside the input is
dropped (weight 0).  The two matrices are applied with two ``einsum``s.
The weights are computed in float32, in the order JAX computes them.

``F.interpolate(mode="bicubic")`` is another function (a = -0.75, the
border clamped, no antialias) and is not used here.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: int):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, (math.pi ** 2) * x * x,
                           torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


_KERNELS = {"bicubic": _keys_cubic, "lanczos3": _lanczos(3)}


def weight_matrix(in_size: int, out_size: int, method: str = "bicubic",
                  antialias: bool = True, device=None) -> torch.Tensor:
    """(in_size, out_size) float32: column ``j`` holds output sample ``j``'s
    weights over the input samples."""
    try:
        kernel = _KERNELS[method]
    except KeyError:
        raise ValueError(f"unknown resize method {method!r}; choose from "
                         f"{sorted(_KERNELS)}") from None
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.0 - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bicubic",
           antialias: bool = True) -> torch.Tensor:
    """Resize NHWC (or HWC) images to (height, width) = ``size``.  An axis
    whose size does not change is left as it is (every kernel here
    interpolates).  ``antialias`` matters on a downscale only.  Integer
    images are resized in float32, rounded and clipped to their range."""
    if x.dim() not in (3, 4):
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(x.shape)}")
    y = x.float()
    h, w = y.shape[-3], y.shape[-2]
    if h != size[0]:
        y = torch.einsum("...hwc,hk->...kwc", y, weight_matrix(
            h, size[0], method, antialias, y.device))
    if w != size[1]:
        y = torch.einsum("...hwc,wk->...hkc", y, weight_matrix(
            w, size[1], method, antialias, y.device))
    if x.dtype.is_floating_point:
        return y.to(x.dtype)
    info = torch.iinfo(x.dtype)
    return torch.clamp(torch.round(y), info.min, info.max).to(x.dtype)

