"""Loss functions of the GAN families (counterpart of
``celebrity_image_denoiser_tpu/train/losses.py``).

    mse / mae           — mean over all elements
    bce                 — on probabilities (the denoise D ends in a sigmoid)
    bce_with_logits     — ESRGAN's D

``bce`` follows the JAX package, not ``torch.nn.BCELoss``: the probability is
clipped to [1e-7, 1 − 1e-7] before the logs (``losses.py:24-28``), where
torch clamps each log at −100.  ``make_vgg_perceptual`` waits for the SRGAN
family.
"""

from __future__ import annotations

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def bce(pred_prob: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross-entropy of probabilities against a constant target."""
    p = torch.clamp(pred_prob, 1e-7, 1 - 1e-7)
    return -torch.mean(target * torch.log(p) + (1 - target) * torch.log(1 - p))


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """The numerically stable log-sigmoid formulation of ``losses.py:31-36``."""
    return torch.mean(torch.relu(logits) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))
