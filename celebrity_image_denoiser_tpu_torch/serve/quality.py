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

Ported for the same-resolution families; srgan and cgan wait for their
models (``ROADMAP.md`` queue 1, item 3), and so does
``srgan_battery_gain_db``.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional

import numpy as np

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


def fixture_gain_db(state, model: str) -> float:
    """PSNR gain of ``model`` on the fixture through the full serving path
    (``ServeState.enhance``), against the noisy input."""
    if model in ("srgan", "cgan"):
        raise ValueError(
            f"fixture_gain_db({model!r}) waits for the {model} family "
            "(ROADMAP.md queue 1, item 3: the other served families)")
    clean, noisy = noisy_fixture(64, seed=1)
    result = state.enhance(model, imageio.encode_png(noisy), "image/png",
                           include_graph=False)
    out = _decode_b64_png(result["denoised_image_base64"])
    return psnr_u8(out, clean) - psnr_u8(noisy, clean)


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
