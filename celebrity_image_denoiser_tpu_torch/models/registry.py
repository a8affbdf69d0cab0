"""Model registry: the generators and discriminators by their serving names
(port of ``celebrity_image_denoiser_tpu/models/registry.py``)."""

from __future__ import annotations

from typing import Callable, Dict

from celebrity_image_denoiser_tpu_torch.models.cgan import (
    CGANKerasDiscriminator,
    CGANKerasGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.cgan_torch import (
    CGANTorchGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseDiscriminator,
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.dncnn import DnCNN
from celebrity_image_denoiser_tpu_torch.models.esrgan import (
    ESRGANDiscriminator,
    ESRGANGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.restormer import Restormer
from celebrity_image_denoiser_tpu_torch.models.srgan import (
    SRGANDiscriminator,
    SRGANGenerator,
)

GENERATORS: Dict[str, Callable] = {
    "denoise": DenoiseGenerator,
    "srgan": SRGANGenerator,
    "esrgan": ESRGANGenerator,
    "cgan": CGANKerasGenerator,        # the serving default backend
    "cgan_torch": CGANTorchGenerator,  # the torch fallback backend
    "dncnn": DnCNN,
}

# families the port serves that the JAX package has none of (never trained
# here: no discriminator, no trainer)
SERVE_ONLY: Dict[str, Callable] = {
    "restormer": Restormer,
}

DISCRIMINATORS: Dict[str, Callable] = {
    "denoise": DenoiseDiscriminator,
    "srgan": SRGANDiscriminator,
    "esrgan": ESRGANDiscriminator,
    "cgan": CGANKerasDiscriminator,
}


def build_generator(name: str, **kwargs):
    table = {**GENERATORS, **SERVE_ONLY}
    if name not in table:
        raise ValueError(f"Unknown model '{name}'. Choose one of "
                         f"{list(table)}")
    return table[name](**kwargs)


def build_discriminator(name: str, **kwargs):
    if name not in DISCRIMINATORS:
        raise ValueError(f"Unknown discriminator '{name}'. Choose one of "
                         f"{list(DISCRIMINATORS)}")
    return DISCRIMINATORS[name](**kwargs)
