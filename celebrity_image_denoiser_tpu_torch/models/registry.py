"""Model registry: the generators and discriminators by their serving names
(port of ``celebrity_image_denoiser_tpu/models/registry.py``), for the
families ported so far."""

from __future__ import annotations

from typing import Callable, Dict

from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseDiscriminator,
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.dncnn import DnCNN
from celebrity_image_denoiser_tpu_torch.models.esrgan import ESRGANGenerator
from celebrity_image_denoiser_tpu_torch.models.srgan import SRGANGenerator

GENERATORS: Dict[str, Callable] = {
    "denoise": DenoiseGenerator,
    "srgan": SRGANGenerator,
    "esrgan": ESRGANGenerator,
    "dncnn": DnCNN,
}

# the discriminators of the families the port trains
DISCRIMINATORS: Dict[str, Callable] = {
    "denoise": DenoiseDiscriminator,
}

_WAITING = ("cgan", "cgan_torch")


def build_generator(name: str, **kwargs):
    if name in _WAITING:
        raise ValueError(f"the {name} generator is not ported yet "
                         "(ROADMAP.md queue 1, item 3)")
    if name not in GENERATORS:
        raise ValueError(f"Unknown model '{name}'. Choose one of "
                         f"{list(GENERATORS)}")
    return GENERATORS[name](**kwargs)


def build_discriminator(name: str, **kwargs):
    if name not in DISCRIMINATORS:
        raise ValueError(f"Unknown discriminator '{name}'. Choose one of "
                         f"{list(DISCRIMINATORS)}")
    return DISCRIMINATORS[name](**kwargs)
