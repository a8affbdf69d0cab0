"""Serving-path quality fixture: the measurement behind the quality gate.

Port of ``celebrity_image_denoiser_tpu/serve/quality.py``.  A retrain of
the JAX package measures the fresh checkpoint's PSNR gain on a fixed
structured fixture through the full serving path and records it as
``fixture_gain_db`` in ``weights/<family>/meta.json``.  The gate then
holds a live measurement, through the port's ``ServeState.enhance``, to at
least ``GATE_FRACTION`` of that recorded margin, so a port or weight
regression that destroys most of the quality fails instead of shipping
with a still-positive gain.

The fixture is structured (smooth fields and sharp shapes), not random per
pixel, with Gaussian noise of σ = 25.  PNG goes through the port's own codec
(``data/imageio.py``), which is lossless, so the served pixels are those
the JAX fixture's Pillow round trip gives.

srgan's fixture is the JAX one: a 256² noisy fixture shrunk to 64² by
Pillow's bicubic (``data/imageio.py::resize_bicubic_u8``, equal to Pillow
bit for bit), the ×4 output scored against the bicubic upscale of that
input.  ``srgan_battery_gain_db`` is its held-out battery (the synthetic
corpus, noise variant 2, a ×4 bicubic downscale through
``ops/resize.py``), drawn on the CPU from a ``torch.Generator`` seeded 77:
its images differ from the JAX battery's (another generator), the recipe
is the same.  cgan is measured through its Keras backend with label 5, as
the JAX fixture asks (the web page's request); it records no margin, so its
floor is ``recorded_gate_floor``'s default.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.data import imageio

# a live gain may drift a little from the recorded one (another device,
# another dtype, a retrain); 70% of the recorded margin catches "most of
# the quality is gone" without flapping on numeric noise
GATE_FRACTION = 0.7


def structured_clean(size: int = 64) -> np.ndarray:
    """Synthetic-corpus-like clean image: smooth gradients + a rectangle and
    a disc (sharp edges), uint8 RGB."""
    yy, xx = np.mgrid[0:size, 0:size]
    img = np.stack([120 + 60 * np.sin(yy / 20), 100 + 80 * (xx / size),
                    90 + 50 * np.cos((xx + yy) / 25)], -1)
    img[size // 3: 2 * size // 3, size // 5: size // 2] = [200, 80, 60]
    mask = (yy - 0.7 * size) ** 2 + (xx - 0.7 * size) ** 2 < (size / 6) ** 2
    img[mask] = [40, 160, 220]
    return np.clip(img, 0, 255).astype(np.uint8)


def psnr_u8(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(10 * np.log10(255.0 ** 2 / np.mean(d ** 2)))


def noisy_fixture(size: int = 64, seed: int = 1):
    """(clean, noisy) uint8 pair: σ=25 gaussian on the structured fixture."""
    clean = structured_clean(size)
    rng = np.random.default_rng(seed)
    noisy = np.clip(clean.astype(np.float64) +
                    rng.normal(0, 25, clean.shape), 0, 255).astype(np.uint8)
    return clean, noisy


def _decode_b64_png(b64: str) -> np.ndarray:
    return imageio.decode_png(base64.b64decode(b64))


def _enhance_png(state, model: str, img: np.ndarray) -> np.ndarray:
    kwargs = (dict(cgan_backend="keras", label=5) if model == "cgan"
              else {})
    result = state.enhance(model, imageio.encode_png(img), "image/png",
                           include_graph=False, **kwargs)
    return _decode_b64_png(result["denoised_image_base64"])


def fixture_gain_db(state, model: str) -> float:
    """PSNR gain of ``model`` on the fixture through the full serving path
    (``ServeState.enhance``): against the noisy input for the
    same-resolution families, against the bicubic ×4 upscale of the 64²
    input for srgan; cgan through its Keras backend (label 5, which the
    Keras model ignores)."""
    if model == "srgan":
        clean, noisy = noisy_fixture(256, seed=2)
        lr = imageio.resize_bicubic_u8(noisy, (64, 64))
        out = _enhance_png(state, "srgan", lr)
        bicubic = imageio.resize_bicubic_u8(lr, (256, 256))
        return psnr_u8(out, clean) - psnr_u8(bicubic, clean)
    clean, noisy = noisy_fixture(64, seed=1)
    out = _enhance_png(state, model, noisy)
    return psnr_u8(out, clean) - psnr_u8(noisy, clean)


def srgan_battery_gain_db(state, n: int = 6, size: int = 128,
                          seed: int = 77) -> float:
    """Bicubic-relative PSNR margin of srgan averaged over a held-out
    battery (``srgan_battery_gain_db:101``): ``n`` synthetic clean images
    of ``size``², noise variant 2, LR = ×4 bicubic downscale (antialiased,
    ``ops/resize.py``), baseline = the bicubic ×4 upscale of the LR image;
    every LR image through the full serving path.  Drawn on the CPU."""
    from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
    from celebrity_image_denoiser_tpu_torch.data.synthetic import (
        synth_clean_batch,
    )
    from celebrity_image_denoiser_tpu_torch.ops.resize import resize

    gen = torch.Generator().manual_seed(seed)
    clean01 = synth_clean_batch(gen, n, size)
    noisy01 = noise_lib.random_noise_batch01(gen, clean01, variant=2)
    h, w = noisy01.shape[1:3]
    lr01 = torch.clamp(resize(noisy01, (h // 4, w // 4)), 0, 1)
    base01 = torch.clamp(resize(lr01, (h, w)), 0, 1)

    def u8(t):
        return torch.round(t * 255).to(torch.uint8).numpy()
    clean_u8, base_u8, lr_u8 = u8(clean01), u8(base01), u8(lr01)
    gains = [psnr_u8(_enhance_png(state, "srgan", lr_u8[i]), clean_u8[i])
             - psnr_u8(base_u8[i], clean_u8[i]) for i in range(len(lr_u8))]
    return float(np.mean(gains))


def recorded_margin(weights_dir: str, model: str,
                    key: str = "fixture_gain_db") -> Optional[float]:
    """The gain recorded at retrain time (``weights/<model>/meta.json``), or
    None when nothing usable is recorded: no file, a malformed or truncated
    one, a document that is not an object, or a value that is not a
    number.  Callers that require a recording assert on this rather than
    on the floor, which cannot tell 'unrecorded' from 'recorded but
    modest'."""
    meta_path = os.path.join(weights_dir, model, "meta.json")
    try:
        with open(meta_path) as f:
            recorded = json.load(f).get(key)
    except (OSError, ValueError, TypeError, AttributeError):
        return None
    if not isinstance(recorded, (int, float)) or isinstance(recorded, bool):
        return None
    return float(recorded)


def recorded_gate_floor(weights_dir: str, model: str, default: float,
                        key: str = "fixture_gain_db") -> float:
    """The gate floor for ``model``: GATE_FRACTION × the margin recorded
    under ``key``, or ``default`` when none is recorded (never below
    ``default``)."""
    recorded = recorded_margin(weights_dir, model, key=key)
    if recorded is None:
        return default
    return max(default, GATE_FRACTION * recorded)
