"""Batch normalisation with running statistics, in the torch and the Keras
conventions.

Counterpart of ``celebrity_image_denoiser_tpu/ops/norm.py::batch_norm``
(:21).  The torch convention: eps 1e-5, momentum 0.1 (running =
0.9·running + 0.1·batch), the biased batch variance in the normaliser and
the unbiased one in the running update (:41-59) — which is
``nn.BatchNorm2d``.  The Keras convention (``keras_momentum=True``, the
cGAN family's ``BatchNormalization``): eps 1e-3, running = 0.99·running +
0.01·batch, the biased batch variance in both — ``KerasBatchNorm2d``; in
eval mode it is ``nn.BatchNorm2d(eps=1e-3)`` with Keras' moving variance
taken as it is.

The running statistics are updated in place (the JAX function returns new
ones).  ``x`` may be bfloat16 while the parameters and statistics stay
float32: the batch statistics are then taken in float32 and the output is
x's dtype.

``fold_batch_norm`` folds an eval BatchNorm into the conv before it, for the
kernel routes of the generators (``models/{dncnn,esrgan,srgan}.py``): the
JAX package computes the conv and then the BatchNorm, and so does the
port's autograd route; the kernels take one conv with a bias.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


KERAS_MOMENTUM = 0.99  # the Keras layer's default (running-stat decay)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool, eps: float = 1e-5, momentum: float = 0.1
               ) -> torch.Tensor:
    """Normalise NCHW ``x`` over (N, H, W).  In train mode uses the batch
    statistics and updates ``running_mean`` / ``running_var`` in place; in
    eval mode uses the running statistics unchanged."""
    return F.batch_norm(x, running_mean, running_var, weight, bias, train,
                        momentum, eps)


class KerasBatchNorm2d(nn.BatchNorm2d):
    """Keras' ``BatchNormalization`` on NCHW tensors: ``nn.BatchNorm2d``
    with eps 1e-3 whose train-mode update keeps ``KERAS_MOMENTUM`` of the
    running statistics and takes the biased batch variance
    (``ops/norm.py:44-55`` with ``keras_momentum=True``)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=1 - KERAS_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            xf = x.detach().float()
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            for run, batch in ((self.running_mean, mean),
                               (self.running_var, var)):
                run.copy_(KERAS_MOMENTUM * run + (1.0 - KERAS_MOMENTUM)
                          * batch)
        return y


@torch.no_grad()
def fold_batch_norm(conv_w: torch.Tensor, conv_b: Optional[torch.Tensor],
                    bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conv (OIHW ``conv_w``, ``conv_b`` or None) followed by ``bn`` in
    eval mode (running statistics, ``bn.eps``) as one conv, in float32:
    ``g = weight / sqrt(running_var + eps)``, ``w' = w · g`` per output
    channel, ``b' = (b - running_mean) · g + bias``."""
    g = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    b = (torch.zeros_like(g) if conv_b is None else conv_b.float())
    w = conv_w.float() * g.view(-1, 1, 1, 1)
    return w, (b - bn.running_mean.float()) * g + bn.bias.float()
