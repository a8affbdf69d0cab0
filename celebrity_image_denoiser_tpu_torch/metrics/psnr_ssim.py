"""PSNR / SSIM on the device in the reference's two conventions
(counterpart of ``celebrity_image_denoiser_tpu/metrics/psnr_ssim.py``:
``psnr:27``, ``ssim:87``, ``ssim_tf:103``).

``ssim`` = skimage ``structural_similarity`` defaults — 7×7 uniform window
over the valid region, unbiased covariance, mean over channels — including
the reference's habit of calling it with ``data_range=2.0`` on [-1, 1]
tensors.  ``ssim_tf`` = ``tf.image.ssim``, the cGAN trainer's: an 11×11
Gaussian window (σ 1.5) over the valid region, biased covariance.  The
functions take NHWC (or HWC) like the JAX package and return per-image
values.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0
         ) -> torch.Tensor:
    """Per-image PSNR over NHWC (returns (N,)) or a scalar for HWC."""
    dims = tuple(range(1, a.dim())) if a.dim() == 4 else None
    err = (a.float() - b.float()) ** 2
    mse = err.mean(dim=dims) if dims else err.mean()
    return 10.0 * torch.log10((data_range ** 2) / torch.clamp(mse, min=1e-12))


def ssim_maps(a: torch.Tensor, b: torch.Tensor, data_range: float, filt,
              norm: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSIM map and the contrast-structure map ``cs`` of NCHW ``a``,
    ``b`` (``_ssim_maps:71``), with the window ``filt`` and the covariance
    scaled by ``norm``; computed in the inputs' dtype."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ua, ub = filt(a), filt(b)
    va = (filt(a * a) - ua * ua) * norm
    vb = (filt(b * b) - ub * ub) * norm
    vab = (filt(a * b) - ua * ub) * norm
    lum = (2 * ua * ub + c1) / (ua * ua + ub * ub + c1)
    cs = (2 * vab + c2) / (va + vb + c2)
    return lum * cs, cs


def _ssim(a: torch.Tensor, b: torch.Tensor, data_range: float, filt,
          norm: float) -> torch.Tensor:
    """The SSIM map's per-image mean of NHWC or HWC ``a``, ``b`` in
    float32."""
    squeeze = a.dim() == 3
    if squeeze:
        a, b = a[None], b[None]
    s, _ = ssim_maps(a.float().permute(0, 3, 1, 2),
                     b.float().permute(0, 3, 1, 2), data_range, filt, norm)
    out = s.mean(dim=(1, 2, 3))
    return out[0] if squeeze else out


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0,
         win: int = 7) -> torch.Tensor:
    """skimage-convention SSIM; per-image values for NHWC, a scalar for
    HWC."""
    return _ssim(a, b, data_range, lambda x: F.avg_pool2d(x, win, stride=1),
                 win * win / (win * win - 1.0))  # the unbiased estimator


def gaussian_filter(c: int, win: int, sigma: float, dtype, device):
    """The separable ``win``-tap Gaussian (σ ``sigma``) over the valid
    region, depthwise over ``c`` NCHW channels (``_gaussian_filter:59``):
    the taps made in float32, as in the JAX package, then cast to
    ``dtype``."""
    coords = torch.arange(win, dtype=torch.float32, device=device) \
        - (win - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    g = (g / g.sum()).to(dtype)
    kh = g.view(1, 1, win, 1).repeat(c, 1, 1, 1)
    kw = g.view(1, 1, 1, win).repeat(c, 1, 1, 1)
    return lambda x: F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)


def ssim_tf(a: torch.Tensor, b: torch.Tensor, max_val: float = 2.0,
            win: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """``tf.image.ssim`` convention (Gaussian window, biased covariance);
    per-image values for NHWC, a scalar for HWC."""
    return _ssim(a, b, max_val, gaussian_filter(
        a.shape[-1], win, sigma, torch.float32, a.device), 1.0)
