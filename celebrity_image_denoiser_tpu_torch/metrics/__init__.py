"""Image-quality metrics of the port."""

from celebrity_image_denoiser_tpu_torch.metrics.perceptual import (
    PerceptualDistance,
)
from celebrity_image_denoiser_tpu_torch.metrics.msssim import ms_ssim
from celebrity_image_denoiser_tpu_torch.metrics.psnr_ssim import (
    psnr,
    ssim,
    ssim_tf,
)

__all__ = ["PerceptualDistance", "ms_ssim", "psnr", "ssim", "ssim_tf"]
