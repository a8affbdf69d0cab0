"""Collectives over a ``torch.distributed`` process group — the training
mesh's communication layer.

Counterpart of ``celebrity_image_denoiser_tpu/parallel/collectives.py``
(:18-39).  Where the JAX functions name a mesh axis inside ``shard_map``,
these take the process group of that axis (``parallel/mesh.py::
axis_group``): NCCL between ranks on their own cards, gloo on the CPU.
``group`` may also be a sequence of groups, one per axis of a 2-D mesh: the
sum is then taken over each in turn, which is the sum over the whole mesh.

    psum          the sum over the group; its backward sums the gradient
                  over the group too (the synced BatchNorm, the train step)
    psum_mean     the metrics' mean over the group
    all_gather    the ranks' tensors concatenated (or stacked)
    ppermute_shift the neighbour exchange: each rank's tensor to the rank
                  ``shift`` places on, zeros to a rank that receives none

The sum's backward is an all-reduce of the gradient: with ``y = Σ_r x_r``
on every rank, the gradient of the sum of every rank's loss with respect
to ``x_r`` is ``Σ_r' ∂L_r'/∂y``.  PyTorch's own differentiable all-reduce
(``torch.distributed.nn.functional.all_reduce``) does the same and warns
that it is deprecated, so the port keeps its own ``autograd.Function``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

Group = Union[None, dist.ProcessGroup, Sequence[dist.ProcessGroup]]


def _groups(group: Group) -> tuple:
    if group is None or isinstance(group, dist.ProcessGroup):
        return (group,)
    return tuple(group)


def group_size(group: Group) -> int:
    """The number of ranks ``group`` sums over (the product over a
    sequence of groups)."""
    n = 1
    for g in _groups(group):
        n *= dist.get_world_size(g)
    return n


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    y = x.clone()
    for g in _groups(group):
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
    return y


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), ctx.group), None


def psum(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (None: the default group), on every
    rank; differentiable, its backward the sum of the gradient over the
    group.  ``x`` is not changed."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sum.apply(x, group)
    return _all_reduce(x, group)


def psum_mean(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """The mean of ``x`` over ``group``."""
    return psum(x, group) / group_size(group)


def all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
               axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along ``axis``
    (``tiled``) or stacked along a new one."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _peer(group: Optional[dist.ProcessGroup], rank: int) -> int:
    """The global rank of ``group``'s ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def ppermute_shift(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   shift: int, wrap: bool = False) -> torch.Tensor:
    """Send each rank's ``x`` to the rank ``shift`` places on in ``group``;
    returns what this rank received.  Not wrapping (the default), a rank
    that receives nothing gets zeros (the halo-exchange pattern, JAX's
    ``ppermute`` semantics); ``wrap=True`` is the ring.  One
    ``batch_isend_irecv`` of this rank's send and receive."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst, src = me + shift, me - shift
    if wrap:
        dst, src = dst % n, src % n
    x = x.contiguous()
    out = torch.zeros_like(x)
    if wrap and dst == me:  # a shift by a multiple of the ring's size
        out.copy_(x)
        return out
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x, _peer(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out, _peer(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
