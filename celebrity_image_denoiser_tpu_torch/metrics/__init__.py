"""Image-quality metrics of the port."""

from celebrity_image_denoiser_tpu_torch.metrics.psnr_ssim import psnr, ssim

__all__ = ["psnr", "ssim"]
