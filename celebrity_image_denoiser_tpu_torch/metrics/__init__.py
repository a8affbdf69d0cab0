"""Image-quality metrics of the port."""

from celebrity_image_denoiser_tpu_torch.metrics.perceptual import (
    PerceptualDistance,
)
from celebrity_image_denoiser_tpu_torch.metrics.psnr_ssim import (
    psnr,
    ssim,
    ssim_tf,
)

__all__ = ["PerceptualDistance", "psnr", "ssim", "ssim_tf"]
