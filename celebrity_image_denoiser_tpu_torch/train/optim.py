"""First-party optimiser and LR schedules (counterpart of
``celebrity_image_denoiser_tpu/train/optim.py``).

``adam`` is the torch-convention Adam of ``optim.py:31-56``: bias-corrected
moments, eps outside the square root of the corrected second moment.  Its
state is the same triple ``(step, mu, nu)`` — ``mu`` and ``nu`` dictionaries
keyed like the parameters — so it saves and loads under the JAX package's
checkpoint keys.  ``lr`` is passed per call (the StepLR schedule steps per
epoch on the host).  Unlike the JAX pair of pure functions, ``update``
changes the parameters and the state **in place**, under ``no_grad``, with
one fused multi-tensor call per operation.  ``adam_keras`` waits for the
cGAN family.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch


@dataclasses.dataclass
class AdamState:
    step: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Returns ``(init, update)``:

    ``init(params) -> AdamState`` for a dict of named tensors;
    ``update(grads, state, params, lr)`` updates ``params`` and ``state`` in
    place; ``grads`` is a dict with the parameters' names."""

    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            step=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor], lr: float) -> None:
        names = list(params)
        g = [grads[k] for k in names]
        p = [params[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        state.step += 1
        t = state.step
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        denom = torch._foreach_div(nu, bc2)       # v_hat
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        # p -= lr * (mu / bc1) / (sqrt(v_hat) + eps)
        torch._foreach_addcdiv_(p, mu, denom, value=-float(lr) / bc1)

    return init, update


def step_lr(base_lr: float, step_size: int = 30, gamma: float = 0.1
            ) -> Callable[[int], float]:
    """torch StepLR: lr = base · gamma^(epoch // step_size)."""

    def schedule(epoch: int) -> float:
        return base_lr * (gamma ** (epoch // step_size))

    return schedule


def constant_lr(base_lr: float) -> Callable[[int], float]:
    return lambda _: base_lr
