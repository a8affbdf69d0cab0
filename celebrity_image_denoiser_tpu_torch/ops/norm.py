"""Batch normalisation with running statistics (torch convention).

Counterpart of ``celebrity_image_denoiser_tpu/ops/norm.py::batch_norm``
(:21) for its torch convention only: eps 1e-5, momentum 0.1 (running =
0.9·running + 0.1·batch), the biased batch variance in the normaliser and
the unbiased one in the running update (:41-59) — which is
``nn.BatchNorm2d``.  The Keras convention waits for the cGAN family.

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


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool, eps: float = 1e-5, momentum: float = 0.1
               ) -> torch.Tensor:
    """Normalise NCHW ``x`` over (N, H, W).  In train mode uses the batch
    statistics and updates ``running_mean`` / ``running_var`` in place; in
    eval mode uses the running statistics unchanged."""
    return F.batch_norm(x, running_mean, running_var, weight, bias, train,
                        momentum, eps)


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
