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

Statistics over a data-parallel group.  JAX's mesh step is one jit over the
global batch (``train/gan_trainer.py:288-297``), so its BatchNorm takes the
global batch's statistics.  The port's ranks each hold a share, so a
BatchNorm whose ``group`` is set (``set_batch_norm_group``: the trainer's
``mesh=``) takes, in train mode, its mean and biased variance over the
group: two sums of ``parallel/collectives.py::psum`` (the sum, then the
sum of squared deviations from the global mean); its backward is
BatchNorm's own with its two sums taken over the group too
(``_GroupBatchNorm``), so the gradient is the global batch's.  The running
variance takes the global count's unbiased factor.  Not ``nn.SyncBatchNorm``: it refuses CPU tensors, where the tests
run it.  The port's models build their BatchNorms from ``BatchNorm2d``
below (``nn.BatchNorm2d`` with a ``group``) and ``KerasBatchNorm2d``; the
discriminators call ``batch_norm`` with their layer's ``group``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.parallel.collectives import (
    group_size,
    psum,
)


KERAS_MOMENTUM = 0.99  # the Keras layer's default (running-stat decay)


def _channels(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class _GroupBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of NCHW ``x`` over ``group``'s global batch.
    The statistics and ``x − mean`` are taken in float64, the rest in
    float32: a channel that is nearly constant over the batch (a
    discriminator's on a generator's first, near-flat outputs) has ``x −
    mean`` many digits below ``mean``, and a float32 mean then cost 1e-2
    of a discriminator gradient against a float64 step, where PyTorch's
    CPU BatchNorm (which accumulates in double) keeps 1e-5.  The backward
    is BatchNorm's own (``dx = w·invstd·(g − Σg/N − x̂·Σ(g·x̂)/N)``, both
    sums in float64 over the group in one all-reduce); the parameters'
    gradients are this rank's sums (the trainer sums them over the group
    with every other gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps):
        xd = x.double()
        count = x.numel() // x.shape[1] * group_size(group)
        mean = psum(xd.sum(dim=(0, 2, 3)), group) / count
        xmu = xd - _channels(mean)
        var = psum((xmu * xmu).sum(dim=(0, 2, 3)), group) / count
        invstd = torch.rsqrt(var + eps)
        xhat = (xmu * _channels(invstd)).float()
        y = xhat * _channels(weight.float()) + _channels(bias.float())
        ctx.save_for_backward(xhat, invstd.float(), weight)
        ctx.group, ctx.count, ctx.dtypes = group, count, (x.dtype,
                                                          bias.dtype)
        mean, var = mean.float(), var.float()
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, invstd, weight = ctx.saved_tensors
        g = gy.float()
        sums = torch.stack([g.sum(dim=(0, 2, 3), dtype=torch.float64),
                            (g * xhat).sum(dim=(0, 2, 3),
                                           dtype=torch.float64)])
        tot_g, tot_gx = (psum(sums, ctx.group) / ctx.count).unbind()
        dx = (g.double() - _channels(tot_g) - xhat * _channels(tot_gx)) \
            * _channels(invstd * weight.float())
        return (dx.to(ctx.dtypes[0]), sums[1].to(weight.dtype),
                sums[0].to(ctx.dtypes[1]), None, None)


def group_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, group, eps: float) -> tuple:
    """Train-mode BatchNorm of NCHW ``x`` with the mean and biased variance
    of ``group``'s global batch (the sum, then the sum of squared
    deviations from the global mean, each summed over the group), computed
    in float32 and returned in x's dtype; returns (y, mean, biased
    variance, count) for the running update."""
    y, mean, var = _GroupBatchNorm.apply(x, weight, bias, group, eps)
    return y, mean, var, x.numel() // x.shape[1] * group_size(group)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool, eps: float = 1e-5, momentum: float = 0.1,
               group=None) -> torch.Tensor:
    """Normalise NCHW ``x`` over (N, H, W).  In train mode uses the batch
    statistics and updates ``running_mean`` / ``running_var`` in place; in
    eval mode uses the running statistics unchanged.  ``group`` (a process
    group, or one per axis of a mesh): in train mode the statistics are the
    whole group's batch's."""
    if group is None or not train:
        return F.batch_norm(x, running_mean, running_var, weight, bias,
                            train, momentum, eps)
    y, mean, var, count = group_batch_norm(x, weight, bias, group, eps)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var * (count / (count - 1)),
                                              alpha=momentum)
    return y


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode statistics are those of
    ``group``'s global batch when ``group`` is set (None: this batch's, as
    ``nn.BatchNorm2d``)."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.group is None:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, train=True, eps=self.eps,
                          momentum=self.momentum, group=self.group)


class KerasBatchNorm2d(nn.BatchNorm2d):
    """Keras' ``BatchNormalization`` on NCHW tensors: ``nn.BatchNorm2d``
    with eps 1e-3 whose train-mode update keeps ``KERAS_MOMENTUM`` of the
    running statistics and takes the biased batch variance
    (``ops/norm.py:44-55`` with ``keras_momentum=True``); over ``group``'s
    global batch when it is set."""

    group = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-3, momentum=1 - KERAS_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            y, mean, var, _ = group_batch_norm(x, self.weight, self.bias,
                                               self.group, self.eps)
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                    run.copy_(KERAS_MOMENTUM * run + (1.0 - KERAS_MOMENTUM)
                              * batch)
            return y
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


def set_batch_norm_group(module: nn.Module, group) -> None:
    """Give every BatchNorm of ``module`` the ``group`` whose global batch
    its train-mode statistics are taken over (None: each its own batch's
    again).  Raises for a BatchNorm no path of the port can sync."""
    for name, m in module.named_modules():
        if isinstance(m, (BatchNorm2d, KerasBatchNorm2d)):
            m.group = group
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            raise TypeError(f"{name}: {type(m).__name__} cannot take its "
                            "statistics over a group (use ops.norm."
                            "BatchNorm2d)")
