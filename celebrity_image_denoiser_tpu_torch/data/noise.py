"""Noise synthesis on the device — the trainer's on-the-fly input stage.

Port of ``celebrity_image_denoiser_tpu/data/noise.py`` for **variant 1**
(uint8-domain parameters expressed on [0, 1]; ``noise.py:47-86``): gaussian
σ=25, salt & pepper p=0.02/0.02, speckle σ=0.1, poisson(λ=pixel), uniform
[0, 25).  The per-kind functions take and return float images in [0, 1]
(NHWC or HWC) like their JAX counterparts; randomness comes from an explicit
``torch.Generator`` on the image's device instead of a ``jax.random`` key, so
the streams differ and the tests compare distributions, or feed both sides
the same draws through the ``*_from_draws`` halves.  Those halves, the
variant's parameters and the kind codes are the noise kernel's
(``ops/cuda/noise.py``, whose plain version is made of them); they are
imported from there.

``random_noise_batch`` is the input stage itself.  It differs from the JAX
function (``noise.py:207-229``) in what crosses its boundary, because the
kernel does: it takes the clean batch as **uint8** NHWC (what the pipeline
puts on the device — a quarter of the float32 bytes) and returns the noisy
batch and the clean target, both float32 in **[-1, 1]**, with the kind each
sample drew.  Like the JAX function it is one program on the device with no
host read: the kinds and the stream's seed are drawn from the generator on
the batch's device and go, with the batch, to one launch of
``ops/cuda/noise.py::noise_batch`` (the hand-written kernel on the card;
its plain version on the CPU), in which each sample takes its kind from
the functions below fed with the stream's draws.

**Variant 2** (``noise.py:89-117``, skimage style: gaussian σ=25, s&p
amount 0.05 per element, poisson ``Pois(x·256)/256``, speckle σ=0.1,
uniform [-50, 50)) is here as plain tensor functions with an explicit
generator, for the srgan quality battery (``serve/quality.py``):
``add_noise(..., variant=2)`` and ``random_noise_batch01``, which takes a
float [0, 1] batch like the JAX function.  The input stage
(``random_noise_batch``, one kernel launch) still takes variant 1 only; the
srgan trainer decides whether K4 takes variant 2 (``ROADMAP.md`` queue 1,
item 4).  Variant 3, ``blind_gaussian_batch`` and ``poisson_v3_exact``
wait for their trainers (the same item).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import noise as noise_kernel
from celebrity_image_denoiser_tpu_torch.ops.cuda.noise import (
    GAUSSIAN_SIGMA,
    PEPPER_PROB,
    SALT_PROB,
    SPECKLE_SIGMA,
    UNIFORM_HIGH,
    gaussian_v1_from_draws,
    poisson_v1_from_draws,
    salt_pepper_v1_from_draws,
    speckle_v1_from_draws,
    uniform_v1_from_draws,
)

NOISE_TYPES = tuple(noise_kernel.KIND_CODES)


def _randn(gen, img):
    return torch.randn(img.shape, generator=gen, dtype=img.dtype,
                       device=img.device)


def _rand(gen, shape, img):
    return torch.rand(shape, generator=gen, dtype=img.dtype, device=img.device)


# ---- variant 1: each kind as (draw, then a pure function of the draws) -----

def gaussian_v1(gen, img, mean=0.0, sigma=GAUSSIAN_SIGMA):
    return gaussian_v1_from_draws(img, _randn(gen, img), mean, sigma)


def salt_pepper_v1(gen, img, salt_prob=SALT_PROB, pepper_prob=PEPPER_PROB):
    """Per-pixel (all channels) salt/pepper at the reference's *effective*
    density: it draws p·H·W·C pixel coordinates with replacement over the
    H·W grid, so a pixel flips with probability 1 − e^(−p·C) per polarity,
    not p.  Pepper overwrites salt on overlap (``noise.py:52-67``)."""
    pix = tuple(img.shape[:-1]) + (1,)
    return salt_pepper_v1_from_draws(img, _rand(gen, pix, img),
                                     _rand(gen, pix, img), salt_prob,
                                     pepper_prob)


def speckle_v1(gen, img, sigma=SPECKLE_SIGMA):
    return speckle_v1_from_draws(img, _randn(gen, img), sigma)


def poisson_v1(gen, img):
    """np.random.poisson(uint8_pixel): λ = the pixel value in [0, 255]."""
    return poisson_v1_from_draws(img, torch.poisson(img * 255.0,
                                                    generator=gen))


def uniform_v1(gen, img, low=0.0, high=UNIFORM_HIGH):
    return uniform_v1_from_draws(img, _rand(gen, img.shape, img), low, high)


# ---- variant 2: skimage style (plain tensor functions) ---------------------

def gaussian_v2(gen, img):
    return gaussian_v1(gen, img, 0.0, 25.0)


def salt_pepper_v2(gen, img, amount=0.05):
    """skimage ``random_noise(mode='s&p', amount)``: each *element* flips
    with probability ``amount``, half of them to salt, half to pepper."""
    flip = _rand(gen, img.shape, img) < amount
    salted = _rand(gen, img.shape, img) < 0.5
    out = torch.where(flip & salted, torch.ones_like(img), img)
    return torch.where(flip & ~salted, torch.zeros_like(img), out)


def speckle_v2(gen, img, sigma=SPECKLE_SIGMA):
    return speckle_v1(gen, img, sigma)


def poisson_v2(gen, img, vals=256.0):
    """skimage poisson: ``Pois(img · vals) / vals``, vals = 2^bitdepth."""
    return torch.clamp(torch.poisson(img * vals, generator=gen) / vals, 0.0,
                       1.0)


def uniform_v2(gen, img, low=-50.0, high=50.0):
    return uniform_v1_from_draws(img, _rand(gen, img.shape, img), low, high)


_VARIANTS = {
    1: {
        "gaussian": gaussian_v1,
        "salt_pepper": salt_pepper_v1,
        "speckle": speckle_v1,
        "poisson": poisson_v1,
        "uniform": uniform_v1,
    },
    2: {
        "gaussian": gaussian_v2,
        "salt_pepper": salt_pepper_v2,
        "speckle": speckle_v2,
        "poisson": poisson_v2,
        "uniform": uniform_v2,
    },
}


def _kind_fn(kind: str, variant: int):
    if variant not in _VARIANTS:
        noise_kernel.check_variant(variant)
    try:
        return _VARIANTS[variant][kind]
    except KeyError:
        raise ValueError(f"unknown noise kind {kind!r} (kinds: "
                         f"{NOISE_TYPES})") from None


def add_noise(gen: torch.Generator, img: torch.Tensor, kind: str,
              variant: int = 1) -> torch.Tensor:
    """Apply one named noise type; img float in [0, 1], any leading dims."""
    return _kind_fn(kind, variant)(gen, img)


def random_noise_batch01(gen: torch.Generator, batch01: torch.Tensor,
                         types: Sequence[str] = NOISE_TYPES,
                         variant: int = 2) -> torch.Tensor:
    """Per-sample random noise kind over a float [0, 1] NHWC batch, the JAX
    ``random_noise_batch`` (``noise.py:207``) as plain tensor functions:
    the kinds uniform over ``types``, then each sample's noise, all drawn
    from ``gen`` in order.  Returns the noisy batch in [0, 1]."""
    kinds = torch.randint(0, len(types), batch01.shape[:1], generator=gen,
                          device=gen.device).tolist()
    return torch.stack([add_noise(gen, img, types[k], variant)
                        for k, img in zip(kinds, batch01)])


def random_noise_batch(gen: torch.Generator, batch_uint8: torch.Tensor,
                       types: Sequence[str] = NOISE_TYPES, variant: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample random noise kind over a uint8 NHWC batch; returns the
    noisy batch and the clean target, float32 NHWC in [-1, 1], and the kind
    index each sample drew (into ``types``), an int64 tensor on the
    batch's device.

    The ``n`` kind indices (uniform over ``types``, as the JAX function's
    ``randint``) and then the stream's seed are drawn from ``gen`` on the
    batch's device; neither comes to the host, and the noise takes one
    launch of ``noise_batch`` (which refuses unknown kinds and the variants
    not ported)."""
    if batch_uint8.dtype != torch.uint8 or batch_uint8.dim() != 4:
        raise ValueError(f"batch must be uint8 (N, H, W, C), got "
                         f"{batch_uint8.dtype} {tuple(batch_uint8.shape)}")
    if gen.device.type != batch_uint8.device.type:
        raise ValueError(f"generator on {gen.device}, batch on "
                         f"{batch_uint8.device}")
    dev = batch_uint8.device
    kinds = torch.randint(0, len(types), batch_uint8.shape[:1], generator=gen,
                          device=dev)
    seed = torch.randint(0, 1 << 62, (1,), generator=gen, device=dev)
    noisy, clean = noise_kernel.noise_batch(kinds, seed, batch_uint8,
                                            tuple(types), variant)
    return noisy, clean, kinds
