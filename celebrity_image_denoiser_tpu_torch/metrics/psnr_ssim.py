"""PSNR / SSIM on the device in the skimage convention (counterpart of
``celebrity_image_denoiser_tpu/metrics/psnr_ssim.py``: ``psnr:27``,
``ssim:87``).

``ssim`` = skimage ``structural_similarity`` defaults — 7×7 uniform window
over the valid region, unbiased covariance, mean over channels — including
the reference's habit of calling it with ``data_range=2.0`` on [-1, 1]
tensors.  Both functions take NHWC (or HWC) like the JAX package and return
per-image values.  ``ssim_tf`` waits for the cGAN family.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0
         ) -> torch.Tensor:
    """Per-image PSNR over NHWC (returns (N,)) or a scalar for HWC."""
    dims = tuple(range(1, a.dim())) if a.dim() == 4 else None
    err = (a.float() - b.float()) ** 2
    mse = err.mean(dim=dims) if dims else err.mean()
    return 10.0 * torch.log10((data_range ** 2) / torch.clamp(mse, min=1e-12))


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0,
         win: int = 7) -> torch.Tensor:
    """skimage-convention SSIM; per-image values for NHWC, a scalar for
    HWC."""
    squeeze = a.dim() == 3
    if squeeze:
        a, b = a[None], b[None]
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)

    def filt(x):  # mean filter over the valid region
        return F.avg_pool2d(x, win, stride=1)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    norm = win * win / (win * win - 1.0)  # the unbiased estimator
    ua, ub = filt(a), filt(b)
    va = (filt(a * a) - ua * ua) * norm
    vb = (filt(b * b) - ub * ub) * norm
    vab = (filt(a * b) - ua * ub) * norm
    lum = (2 * ua * ub + c1) / (ua * ua + ub * ub + c1)
    cs = (2 * vab + c2) / (va + vb + c2)
    out = (lum * cs).mean(dim=(1, 2, 3))
    return out[0] if squeeze else out
