"""cGAN, torch architecture: the server's ``cgan_backend=torch`` fallback.

Port of ``celebrity_image_denoiser_tpu/models/cgan_torch.py::
CGANTorchGenerator`` (:22): a label embedding (10 classes, 100 wide) →
Linear 200 → 8192, read as (N, 128, 8, 8) → BatchNorm, ReLU → transpose
convs 4×4 stride 2 padding 1, 128 → 128 → 64 → 32, each with BatchNorm and
ReLU → conv 32 → 3, 3×3 → tanh: a 64×64 image from a latent and a label.
BatchNorm in the torch convention.  The input of the Linear is the latent
then the embedding, as in the JAX model.

Its image-condition path keeps the reference's shape fault (the JAX
model's note, :7-12): a 3-channel image concatenated with a 3-channel
condition goes into ``BatchNorm2d(128)``, which raises, as it does there.

Child names equal the JAX param paths (``label_emb``, ``l1``, ``model.N``).
Every layer is a PyTorch op (XLA ops in the JAX package); the server runs
it in float only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    reset_conv_parameters,
)
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d, ConvTranspose2d


class CGANTorchGenerator(nn.Module):
    """``forward(z, cond)``: z (N, latent) or (N, latent, 1, 1), cond (N,)
    integer labels → (N, 3, 64, 64) in [-1, 1]; a 4-D ``cond`` takes the
    image-condition path, which raises."""

    def __init__(self, n_classes: int = 10, latent_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_classes = n_classes
        self.latent_dim = latent_dim
        self.init_size = 8
        self.label_emb = nn.Embedding(n_classes, latent_dim)
        self.l1 = nn.Linear(2 * latent_dim, 128 * self.init_size ** 2)
        layers = [nn.BatchNorm2d(128), nn.ReLU()]
        for cin, cout in ((128, 128), (128, 64), (64, 32)):
            layers += [ConvTranspose2d(cin, cout, 4, stride=2, padding=1),
                       nn.BatchNorm2d(cout), nn.ReLU()]
        layers.append(Conv2d(32, 3, 3, stride=1, padding=1))
        self.model = nn.Sequential(*layers)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """PyTorch's default init (the JAX layers' torch init), drawn from
        ``generator``: the embedding N(0, 1), the Linear U(±1/sqrt(in))."""
        reset_conv_parameters(self, generator)
        self.label_emb.weight.normal_(generator=generator)
        bound = 1.0 / math.sqrt(self.l1.in_features)
        self.l1.weight.uniform_(-bound, bound, generator=generator)
        self.l1.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, z: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is None:
            raise ValueError("cGAN requires a condition (label or tensor)")
        if cond.dim() == 1:
            h = torch.cat([z.reshape(z.shape[0], -1), self.label_emb(cond)],
                          dim=1)
            h = self.l1(h).view(-1, 128, self.init_size, self.init_size)
            return torch.tanh(self.model(h))
        # the image-condition path, with the reference's channel fault
        return torch.tanh(self.model(torch.cat([z, cond], dim=1)))
