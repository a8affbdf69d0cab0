"""Multi-scale SSIM (the ``pytorch_msssim`` convention).

Port of ``celebrity_image_denoiser_tpu/metrics/msssim.py::ms_ssim:30``:
five scales with the Wang et al. weights (``_WEIGHTS:19``), an 11×11
Gaussian window (σ 1.5) applied over the valid region and depthwise, biased
covariance, a 2×2 average pool between scales (odd extents truncated), and
each scale's ``cs`` and the last scale's SSIM clamped at 0 before the
power.  The maps come from ``psnr_ssim.ssim_maps``.

The smallest scale needs a full window after four halvings, so an input
side below ``win · 2⁴`` (176 px for the default window) raises a
``ValueError`` here; the JAX function fails on the shape instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.metrics.psnr_ssim import (
    gaussian_filter,
    ssim_maps,
)

_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def min_size(win: int = 11) -> int:
    """The smallest input side MS-SSIM takes with a ``win``-tap window."""
    return win * 2 ** (len(_WEIGHTS) - 1)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
            win: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Per-image MS-SSIM of NHWC ``a``, ``b`` (returns (N,)), a scalar for
    HWC; computed in float32 (float64 inputs stay float64)."""
    squeeze = a.dim() == 3
    if squeeze:
        a, b = a[None], b[None]
    h, w = int(a.shape[1]), int(a.shape[2])
    if min(h, w) < min_size(win):
        raise ValueError(
            f"ms_ssim needs images of at least {min_size(win)} px a side "
            f"(a {win}-tap window at the fifth scale), got {h}x{w}")
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    a = a.to(dt).permute(0, 3, 1, 2)
    b = b.to(dt).permute(0, 3, 1, 2)
    filt = gaussian_filter(a.shape[1], win, sigma, dt, a.device)
    out = None
    for i, wt in enumerate(_WEIGHTS):
        s, cs = ssim_maps(a, b, data_range, filt)
        if i < len(_WEIGHTS) - 1:
            term = cs.mean(dim=(1, 2, 3)).clamp_min(0.0) ** wt
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
        else:
            term = s.mean(dim=(1, 2, 3)).clamp_min(0.0) ** wt
        out = term if out is None else out * term
    return out[0] if squeeze else out
