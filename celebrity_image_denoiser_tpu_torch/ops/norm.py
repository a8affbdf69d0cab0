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
"""

from __future__ import annotations

import torch
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
