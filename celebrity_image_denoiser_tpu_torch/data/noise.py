"""Noise synthesis on the device — the trainer's on-the-fly input stage.

Port of ``celebrity_image_denoiser_tpu/data/noise.py`` for **variant 1**
(uint8-domain parameters expressed on [0, 1]; ``noise.py:47-86``): gaussian
σ=25, salt & pepper p=0.02/0.02, speckle σ=0.1, poisson(λ=pixel), uniform
[0, 25).  The per-kind functions take and return float images in [0, 1]
(NHWC or HWC) like their JAX counterparts; randomness comes from an explicit
``torch.Generator`` on the image's device instead of a ``jax.random`` key, so
the streams differ and the tests compare distributions, or feed both sides
the same draws through the ``*_from_draws`` halves.

``random_noise_batch`` is the input stage itself.  It differs from the JAX
function (``noise.py:207-229``) in what crosses its boundary, because the
fused kernel does: it takes the clean batch as **uint8** NHWC (what the
pipeline puts on the device — a quarter of the float32 bytes) and returns
the noisy batch as float32 in **[-1, 1]**.  The samples that draw
``gaussian`` go together, as one uint8 sub-batch, through
``ops/cuda/noise.py::fused_normalize_gaussian_noise`` (the hand-written
kernel on the card) and its output is used as it is; the other kinds run
the functions below on ``u8/255`` and are mapped with ``·2 − 1``.

Variants 2 and 3, ``blind_gaussian_batch`` and ``poisson_v3_exact`` belong to
families that are not ported yet (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import noise as noise_kernel

NOISE_TYPES = ("gaussian", "salt_pepper", "speckle", "poisson", "uniform")
_WAITING = ("variants 2 and 3 of the noise functions are not ported yet "
            "(ROADMAP.md queue 1 item 10)")


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def _randn(gen, img):
    return torch.randn(img.shape, generator=gen, dtype=img.dtype,
                       device=img.device)


def _rand(gen, shape, img):
    return torch.rand(shape, generator=gen, dtype=img.dtype, device=img.device)


# ---- variant 1: each kind as (draw, then a pure function of the draws) -----

def gaussian_v1_from_draws(img, normal, mean=0.0, sigma=25.0):
    return _clip01(img + (mean / 255.0 + (sigma / 255.0) * normal))


def gaussian_v1(gen, img, mean=0.0, sigma=25.0):
    return gaussian_v1_from_draws(img, _randn(gen, img), mean, sigma)


def salt_pepper_v1_from_draws(img, u_salt, u_pepper, salt_prob=0.02,
                              pepper_prob=0.02):
    c = img.shape[-1]
    p_salt = 1.0 - math.exp(-salt_prob * c)
    p_pepper = 1.0 - math.exp(-pepper_prob * c)
    out = torch.where(u_salt < p_salt, torch.ones_like(img), img)
    return torch.where(u_pepper < p_pepper, torch.zeros_like(img), out)


def salt_pepper_v1(gen, img, salt_prob=0.02, pepper_prob=0.02):
    """Per-pixel (all channels) salt/pepper at the reference's *effective*
    density: it draws p·H·W·C pixel coordinates with replacement over the
    H·W grid, so a pixel flips with probability 1 − e^(−p·C) per polarity,
    not p.  Pepper overwrites salt on overlap (``noise.py:52-67``)."""
    pix = tuple(img.shape[:-1]) + (1,)
    return salt_pepper_v1_from_draws(img, _rand(gen, pix, img),
                                     _rand(gen, pix, img), salt_prob,
                                     pepper_prob)


def speckle_v1_from_draws(img, normal, sigma=0.1):
    return _clip01(img + img * (sigma * normal))


def speckle_v1(gen, img, sigma=0.1):
    return speckle_v1_from_draws(img, _randn(gen, img), sigma)


def poisson_v1_from_draws(img, counts):
    return _clip01(counts.to(img.dtype) / 255.0)


def poisson_v1(gen, img):
    """np.random.poisson(uint8_pixel): λ = the pixel value in [0, 255]."""
    return poisson_v1_from_draws(img, torch.poisson(img * 255.0,
                                                    generator=gen))


def uniform_v1_from_draws(img, u, low=0.0, high=25.0):
    return _clip01(img + (low / 255.0 + u * ((high - low) / 255.0)))


def uniform_v1(gen, img, low=0.0, high=25.0):
    return uniform_v1_from_draws(img, _rand(gen, img.shape, img), low, high)


_VARIANTS = {
    1: {
        "gaussian": gaussian_v1,
        "salt_pepper": salt_pepper_v1,
        "speckle": speckle_v1,
        "poisson": poisson_v1,
        "uniform": uniform_v1,
    },
}


def _kind_fn(kind: str, variant: int):
    if variant in (2, 3):
        raise NotImplementedError(_WAITING)
    try:
        return _VARIANTS[variant][kind]
    except KeyError:
        raise ValueError(
            f"unknown noise kind/variant: {kind!r}/{variant} "
            f"(kinds: {NOISE_TYPES}, variants: 1|2|3)") from None


def add_noise(gen: torch.Generator, img: torch.Tensor, kind: str,
              variant: int = 1) -> torch.Tensor:
    """Apply one named noise type; img float in [0, 1], any leading dims."""
    return _kind_fn(kind, variant)(gen, img)


def random_noise_batch(gen: torch.Generator, batch_uint8: torch.Tensor,
                       types: Sequence[str] = NOISE_TYPES, variant: int = 1
                       ) -> Tuple[torch.Tensor, List[int]]:
    """Per-sample random noise type over a uint8 NHWC batch; returns the
    noisy batch, float32 NHWC in [-1, 1], and the kind index each sample
    drew (into ``types``).

    One draw of ``n + 1`` integers from ``gen`` gives the ``n`` kind indices
    and the seed of the fused gaussian kernel; it comes to the host once
    (the sub-batches' sizes depend on it).  Then the gaussian samples take
    one launch of ``fused_normalize_gaussian_noise`` — none if no sample drew
    gaussian — and the other kinds draw from ``gen`` in the order of
    ``types``."""
    if batch_uint8.dtype != torch.uint8 or batch_uint8.dim() != 4:
        raise ValueError(f"batch must be uint8 (N, H, W, C), got "
                         f"{batch_uint8.dtype} {tuple(batch_uint8.shape)}")
    if gen.device.type != batch_uint8.device.type:
        raise ValueError(f"generator on {gen.device}, batch on "
                         f"{batch_uint8.device}")
    fns = [_kind_fn(t, variant) for t in types]
    n = batch_uint8.shape[0]
    draws = torch.randint(0, 1 << 62, (n + 1,), generator=gen,
                          device=batch_uint8.device).tolist()
    kinds, seed = [d % len(types) for d in draws[:n]], draws[n]
    out = torch.empty(batch_uint8.shape, dtype=torch.float32,
                      device=batch_uint8.device)
    for k, (name, fn) in enumerate(zip(types, fns)):
        rows = [i for i, kind in enumerate(kinds) if kind == k]
        if not rows:
            continue
        idx = torch.tensor(rows, device=batch_uint8.device)
        sub = batch_uint8.index_select(0, idx)
        if name == "gaussian":
            noisy = noise_kernel.fused_normalize_gaussian_noise(
                seed, sub, sigma=25.0, out_dtype=torch.float32)
        else:
            noisy = fn(gen, sub.to(torch.float32) / 255.0) * 2.0 - 1.0
        out.index_copy_(0, idx, noisy)
    return out, kinds
