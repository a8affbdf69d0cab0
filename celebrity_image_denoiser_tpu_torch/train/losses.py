"""Loss functions of the GAN families (counterpart of
``celebrity_image_denoiser_tpu/train/losses.py``).

    mse / mae           — mean over all elements
    bce                 — on probabilities (the denoise D ends in a sigmoid)
    bce_with_logits     — ESRGAN's D
    make_vgg_perceptual — SRGAN's content loss, MSE over frozen VGG features

``bce`` follows the JAX package, not ``torch.nn.BCELoss``: the probability is
clipped to [1e-7, 1 − 1e-7] before the logs (``losses.py:24-28``), where
torch clamps each log at −100.
"""

from __future__ import annotations

import torch
import torch.nn as nn


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


class VGGPerceptualLoss(nn.Module):
    """``loss(x, y) = MSE(vgg(x), vgg(y))`` over a frozen tower
    (``losses.py:39-58``, the reference's ``VGGPerceptualLoss``,
    ``training.py:101-111``), on NCHW tensors in the model's native range:
    ``to_unit`` maps [-1, 1] to [0, 1] first (the shipped tower was trained
    on [0, 1]; a torchvision or random tower keeps the reference's
    unshifted feed).  The tower's parameters take no gradient; ``y``'s
    features are taken without one; ``x``'s carry the gradient to ``x``.
    Given bfloat16 inputs the tower runs in bfloat16 and the mean is taken
    in float32."""

    def __init__(self, vgg: nn.Module, to_unit: bool = False):
        super().__init__()
        self.vgg = vgg.eval().requires_grad_(False)
        self.to_unit = to_unit

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.to_unit:
            x, y = x * 0.5 + 0.5, y * 0.5 + 0.5
        with torch.no_grad():
            fy = self.vgg(y)
        return mse(self.vgg(x).float(), fy.float())


def make_vgg_perceptual(vgg: nn.Module, to_unit: bool = False
                        ) -> VGGPerceptualLoss:
    """The perceptual content loss over ``vgg`` (``models/vgg.py::
    VGGFeatures``), frozen."""
    return VGGPerceptualLoss(vgg, to_unit)
