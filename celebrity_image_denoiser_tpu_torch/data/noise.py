"""Noise synthesis on the device — the trainers' on-the-fly input stage.

Port of ``celebrity_image_denoiser_tpu/data/noise.py``: the three noise
variants (``noise.py:45-170``) — **variant 1** (uint8-domain parameters on
[0, 1]: gaussian σ=25, salt & pepper p=0.02/0.02 per pixel, speckle σ=0.1,
poisson(λ=pixel), uniform [0, 25)), **variant 2** (skimage style: gaussian
σ=25, s&p amount 0.05 per element, poisson ``Pois(x·256)/256``, speckle
σ=0.1, uniform [-50, 50)), **variant 3** (float [0, 1] domain: gaussian
var 0.01, s&p 0.002/0.002 per element, speckle ``x + x·n``, poisson as
variant 2 with JAX's on-device vals=256, uniform [-0.05, 0.05)) — and the
blind-σ Gaussian (``blind_gaussian_batch``, ``noise.py:232-242``).  The
per-kind functions take and return float images in [0, 1] (NHWC or HWC)
like their JAX counterparts; randomness comes from an explicit
``torch.Generator`` on the image's device instead of a ``jax.random`` key,
so the streams differ and the tests compare distributions, or feed both
sides the same draws through the ``*_from_draws`` halves.  Those halves,
the variants' parameters and the kind codes are the noise kernel's
(``ops/cuda/noise.py``, whose plain version is made of them); they are
imported from there.  ``poisson_v3_exact`` is variant 3's poisson with the
reference's per-image scale (``noise.py:144-163``), for the offline
renderer (``cli/noise_gen.py``): a plain function of tensors and a
generator, not a mode of the kernel, whose table fixes the scale at 256.

``random_noise_batch`` and ``blind_gaussian_batch`` are the input stage
itself.  They differ from the JAX functions (``noise.py:207-242``) in what
crosses their boundary, because the kernel does: they take the clean batch
as **uint8** NHWC (what the pipeline puts on the device — a quarter of the
float32 bytes) and return the noisy batch and the clean target, both
float32, in [-1, 1] (``domain="tanh"``, the tanh families) or on [0, 1]
(``"unit"``: esrgan and dncnn, and srgan's noisy side before its
downscale).  Like the JAX functions each is one program on the device with
no host read: the kinds and the stream's seed are drawn from the generator
on the batch's device and go, with the batch, to one launch of
``ops/cuda/noise.py::noise_batch`` or ``blind_noise_batch`` (the
hand-written kernel on the card; its plain version on the CPU), in which
each sample takes its kind from the functions below fed with the stream's
draws.

``random_noise_batch01`` is the JAX function's float [0, 1] form as plain
tensor functions with a generator, for srgan's quality battery
(``serve/quality.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import noise as noise_kernel
from celebrity_image_denoiser_tpu_torch.ops.cuda.noise import (
    GAUSSIAN3_VAR,
    GAUSSIAN_SIGMA,
    PEPPER_PROB,
    POISSON_VALS,
    SALT_PROB,
    SP2_AMOUNT,
    SP3_AMOUNT,
    SPECKLE_SIGMA,
    UNIFORM2_HIGH,
    UNIFORM2_LOW,
    UNIFORM3_HIGH,
    UNIFORM3_LOW,
    UNIFORM_HIGH,
    gaussian_v1_from_draws,
    gaussian_v3_from_draws,
    poisson_v1_from_draws,
    poisson_v2_from_draws,
    salt_pepper_v1_from_draws,
    salt_pepper_v2_from_draws,
    salt_pepper_v3_from_draws,
    speckle_v1_from_draws,
    speckle_v3_from_draws,
    uniform_v1_from_draws,
    uniform_v3_from_draws,
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


# ---- variant 2: skimage style -------------------------------------------

def gaussian_v2(gen, img):
    return gaussian_v1(gen, img, 0.0, GAUSSIAN_SIGMA)


def salt_pepper_v2(gen, img, amount=SP2_AMOUNT):
    """skimage ``random_noise(mode='s&p', amount)``: each *element* flips
    with probability ``amount``, half of them to salt, half to pepper."""
    return salt_pepper_v2_from_draws(img, _rand(gen, img.shape, img),
                                     _rand(gen, img.shape, img), amount)


def speckle_v2(gen, img, sigma=SPECKLE_SIGMA):
    return speckle_v1(gen, img, sigma)


def poisson_v2(gen, img, vals=POISSON_VALS):
    """skimage poisson: ``Pois(img · vals) / vals``, vals = 2^bitdepth."""
    return torch.clamp(torch.poisson(img * vals, generator=gen) / vals, 0.0,
                       1.0)


def uniform_v2(gen, img, low=UNIFORM2_LOW, high=UNIFORM2_HIGH):
    return uniform_v1_from_draws(img, _rand(gen, img.shape, img), low, high)


# ---- variant 3: float [0, 1] domain ----------------------------------------

def gaussian_v3(gen, img, var=GAUSSIAN3_VAR):
    return gaussian_v3_from_draws(img, _randn(gen, img), var)


def salt_pepper_v3(gen, img, amount=SP3_AMOUNT):
    return salt_pepper_v3_from_draws(img, _rand(gen, img.shape, img),
                                     _rand(gen, img.shape, img), amount)


def speckle_v3(gen, img):
    return speckle_v3_from_draws(img, _randn(gen, img))


def poisson_v3(gen, img, vals=POISSON_VALS):
    return poisson_v2(gen, img, vals)


def uniform_v3(gen, img, low=UNIFORM3_LOW, high=UNIFORM3_HIGH):
    return uniform_v3_from_draws(img, _rand(gen, img.shape, img), low, high)


def v3_poisson_vals(img: torch.Tensor) -> float:
    """Variant 3's exact poisson scale, ``2^ceil(log2(#unique))`` over the
    image's values (``v3_poisson_vals:144``, esrgan_addNoise.py:32-34).
    Data-dependent, so it is read on the host."""
    n = int(torch.unique(img).numel()) if img.numel() else 1
    return float(2.0 ** math.ceil(math.log2(max(n, 1))))


def poisson_v3_exact(gen: torch.Generator, img: torch.Tensor) -> torch.Tensor:
    """Variant 3's poisson with the reference's per-image scale
    (``poisson_v3_exact:157``): ``Pois(img · vals) / vals`` clipped to
    [0, 1], vals from ``v3_poisson_vals``; ``img`` one float image on [0,
    1], the counts drawn by ``torch.poisson`` from ``gen`` on its device."""
    vals = v3_poisson_vals(img)
    return poisson_v2_from_draws(img, torch.poisson(img * vals,
                                                    generator=gen), vals)


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
    3: {
        "gaussian": gaussian_v3,
        "salt_pepper": salt_pepper_v3,
        "speckle": speckle_v3,
        "poisson": poisson_v3,
        "uniform": uniform_v3,
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


def _check_uint8_batch(gen: torch.Generator, batch_uint8: torch.Tensor):
    if batch_uint8.dtype != torch.uint8 or batch_uint8.dim() != 4:
        raise ValueError(f"batch must be uint8 (N, H, W, C), got "
                         f"{batch_uint8.dtype} {tuple(batch_uint8.shape)}")
    if gen.device.type != batch_uint8.device.type:
        raise ValueError(f"generator on {gen.device}, batch on "
                         f"{batch_uint8.device}")


def stream_seed(gen: torch.Generator, device) -> torch.Tensor:
    """The kernel stream's seed, drawn on ``device``."""
    return torch.randint(0, 1 << 62, (1,), generator=gen, device=device)


def _share(batch_uint8: torch.Tensor, rank: int, world: int) -> int:
    """The first sample of ``rank``'s share of the global batch of ``world``
    shares, each of ``batch_uint8``'s size."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return rank * batch_uint8.shape[0]


def random_noise_batch(gen: torch.Generator, batch_uint8: torch.Tensor,
                       types: Sequence[str] = NOISE_TYPES, variant: int = 1,
                       domain: str = "tanh", rank: int = 0, world: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample random noise kind of ``variant`` over a uint8 NHWC batch;
    returns the noisy batch and the clean target, float32 NHWC in [-1, 1]
    (``domain="tanh"``) or on [0, 1] (``"unit"``), and the kind index each
    sample drew (into ``types``), an int64 tensor on the batch's device.

    The ``n`` kind indices (uniform over ``types``, as the JAX function's
    ``randint``) and then the stream's seed are drawn from ``gen`` on the
    batch's device; neither comes to the host, and the noise takes one
    launch of ``noise_batch`` (which refuses unknown kinds, variants and
    domains).

    ``rank`` of ``world`` (data parallelism): ``batch_uint8`` is rank's
    share, samples ``rank·n .. (rank+1)·n - 1``, of a global batch of
    ``world·n``.  Every rank draws the global batch's kinds and the seed
    from its identically seeded ``gen``, takes its slice of the kinds and
    launches at its ``first_sample``, so its rows are bit-equal to those of
    the single launch over the global batch; the kinds returned are its
    share's."""
    _check_uint8_batch(gen, batch_uint8)
    dev = batch_uint8.device
    first = _share(batch_uint8, rank, world)
    n = batch_uint8.shape[0]
    kinds = torch.randint(0, len(types), (n * world,), generator=gen,
                          device=dev)[first:first + n]
    noisy, clean = noise_kernel.noise_batch(kinds, stream_seed(gen, dev),
                                            batch_uint8, tuple(types),
                                            variant, domain, first)
    return noisy, clean, kinds


def blind_gaussian_batch(gen: torch.Generator, batch_uint8: torch.Tensor,
                         domain: str = "unit", rank: int = 0, world: int = 1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blind-σ Gaussian noise for DnCNN training (``noise.py:232-242``):
    per-sample σ ~ U[5, 50] on the 0-255 scale
    (``ops/cuda/noise.py::BLIND_SIGMA``: the JAX function's defaults, which
    its trainer never changes), over a uint8 NHWC batch; returns the noisy
    batch and the clean target, float32 NHWC on [0, 1] (``domain="unit"``,
    dncnn's) or in [-1, 1].  The stream's
    seed is drawn from ``gen`` on the batch's device, and each σ from the
    stream on the card (``ops/cuda/noise.py::blind_sigmas``): one launch
    of ``blind_noise_batch``, no host read.  ``rank`` of ``world`` as in
    ``random_noise_batch``: this rank's rows of the global batch's
    launch."""
    _check_uint8_batch(gen, batch_uint8)
    first = _share(batch_uint8, rank, world)
    return noise_kernel.blind_noise_batch(stream_seed(gen, batch_uint8.device),
                                          batch_uint8, domain, first)
