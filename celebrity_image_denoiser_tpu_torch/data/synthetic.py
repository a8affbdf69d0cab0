"""Synthetic clean images, made on the device from a ``torch.Generator``.

Port of ``celebrity_image_denoiser_tpu/data/synthetic.py::synth_clean_batch``
(:20-90) — the same recipe and ranges: a smooth low-frequency colour field
(6×6 uniform, cubic upsampling), a mid-frequency layer (24×24 in ±0.12,
linear), ``num_shapes`` antialiased rectangles or ellipses (1.5 px sigmoid
edge), two band-limited texture layers at quarter and half resolution with
per-image amplitude in [0, 0.12] coupled to luminance, and a radial vignette
of strength in [0, 0.35]; clipped to [0, 1].  The images differ from the JAX
package's for the same seed (another generator, and PyTorch's cubic kernel
has a = −0.75 where JAX's has −0.5); the statistics a denoiser needs — flat
regions, sharp edges, fine texture — are the same.  ``calibration_batch``
(:93) is the int8 calibration batch, ``lr_batch`` (:120) the low-resolution
recipe (the ×4 bicubic downscale is ``ops/resize.py``'s, JAX's function),
``srgan_calibration_batch`` (:135) SRGAN's calibration mix and
``heldout_noisy_batch`` (:158) the held-out agreement-probe batch.  Every
batch is drawn from a ``torch.Generator`` on the CPU (seeded as the JAX
function seeds its keys) whatever the device, so the card calibrates on
the batch the CPU tests see.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.ops.resize import resize


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _resize(x, size: int, mode: str):
    """(n, h, w, 3) → (n, size, size, 3), half-pixel centres."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode=mode,
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def synth_clean_batch(gen: torch.Generator, n: int, size: int = 128,
                      num_shapes: int = 4) -> torch.Tensor:
    """(n, size, size, 3) float32 clean images in [0, 1] on ``gen``'s
    device."""
    dev = gen.device
    img = _resize(_uniform(gen, (n, 6, 6, 3), 0.0, 1.0, dev), size, "bicubic")
    img = img + _resize(_uniform(gen, (n, 24, 24, 3), -0.12, 0.12, dev), size,
                        "bilinear")
    coords = torch.arange(size, dtype=torch.float32, device=dev)
    yy, xx = coords.view(1, size, 1), coords.view(1, 1, size)

    for _ in range(num_shapes):
        centre = _uniform(gen, (n, 2), 0.15 * size, 0.85 * size, dev)
        dims = _uniform(gen, (n, 2), 0.06 * size, 0.30 * size, dev)
        cy, cx = centre[:, 0].view(n, 1, 1), centre[:, 1].view(n, 1, 1)
        hh, ww = dims[:, 0].view(n, 1, 1), dims[:, 1].view(n, 1, 1)
        # signed distances (negative inside) for both candidate shapes
        d_rect = torch.maximum((yy - cy).abs() - hh, (xx - cx).abs() - ww)
        d_ell = (torch.sqrt(((yy - cy) / hh) ** 2 + ((xx - cx) / ww) ** 2)
                 - 1.0) * torch.minimum(hh, ww)
        use_rect = torch.rand((n, 1, 1), generator=gen, device=dev) < 0.5
        mask = torch.sigmoid(-torch.where(use_rect, d_rect, d_ell) / 1.5)
        mask = mask.unsqueeze(-1)
        color = _uniform(gen, (n, 1, 1, 3), 0.0, 1.0, dev)
        img = img * (1.0 - mask) + color * mask

    amp = _uniform(gen, (n, 2), 0.0, 0.12, dev).view(n, 2, 1, 1, 1)
    tex_q = _resize(_uniform(gen, (n, size // 4, size // 4, 3), -1.0, 1.0,
                             dev), size, "bilinear")
    tex_h = _resize(_uniform(gen, (n, size // 2, size // 2, 3), -1.0, 1.0,
                             dev), size, "bilinear")
    tex = amp[:, 0] * tex_q + amp[:, 1] * tex_h
    img = img + tex * img.mean(dim=-1, keepdim=True)

    r2 = ((yy / size - 0.5) ** 2 + (xx / size - 0.5) ** 2) * 2.0
    strength = _uniform(gen, (n, 1, 1), 0.0, 0.35, dev)
    img = img * (1.0 - strength * r2).unsqueeze(-1)
    return torch.clamp(img, 0.0, 1.0)


def calibration_batch(tanh: bool, size: int = 128, sigmas=(0.12,), *,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Int8-PTQ calibration batch (``calibration_batch:93``): for each σ in
    ``sigmas``, 8 clean synthetic images plus σ·N(0, 1), clipped to [0, 1];
    mapped to [-1, 1] when ``tanh``.  (8·len(sigmas), size, size, 3) float32
    on ``generator``'s device, drawn from it (default: a CPU generator seeded
    0).  Shared by serving and the bench, so the benchmarked int8 program is
    the served one."""
    gen = generator or torch.Generator().manual_seed(0)
    parts = []
    for sigma in sigmas:
        clean01 = synth_clean_batch(gen, 8, size)
        noise = torch.randn(clean01.shape, generator=gen, device=gen.device)
        parts.append(torch.clamp(clean01 + sigma * noise, 0.0, 1.0))
    batch01 = torch.cat(parts, dim=0)
    return batch01 * 2.0 - 1.0 if tanh else batch01


def lr_batch(seed: int, n: int, hw: int, sigma: float = 0.0) -> torch.Tensor:
    """(n, hw, hw, 3) low-resolution images in [-1, 1] (``lr_batch:120``):
    clean synthetics rendered at 4·hw and bicubic-downsized, with optional
    mild sensor noise σ; drawn on the CPU from generators seeded ``seed``
    (the images) and ``seed + 1`` (the noise)."""
    clean01 = synth_clean_batch(torch.Generator().manual_seed(seed), n,
                                4 * hw)
    lr01 = torch.clamp(resize(clean01, (hw, hw), method="bicubic"), 0.0, 1.0)
    if sigma:
        noise = torch.randn(lr01.shape,
                            generator=torch.Generator().manual_seed(seed + 1))
        lr01 = torch.clamp(lr01 + sigma * noise, 0.0, 1.0)
    return lr01 * 2.0 - 1.0


def srgan_calibration_batch() -> torch.Tensor:
    """SRGAN's int8 calibration batch (``srgan_calibration_batch:135``): its
    serving inputs are low-resolution images, so 8 clean LR 64² + 4 LR with
    σ 0.05 + 4 noisy full-resolution crops, (16, 64, 64, 3) in [-1, 1]."""
    return torch.cat([lr_batch(0, 8, 64), lr_batch(20, 4, 64, sigma=0.05),
                      calibration_batch(True)[:4, :64, :64, :]])


def heldout_noisy_batch(tanh: bool, size: int = 48,
                        sigmas=(0.08, 0.18)) -> torch.Tensor:
    """Held-out agreement-probe batch (``heldout_noisy_batch:158``): the
    calibration recipe with disjoint seeds and off-calibration σs, so a
    probe never measures calibration pixels.  For the i-th σ, 4 clean
    synthetics (a CPU generator seeded 1000 + i) plus σ·N(0, 1) (seeded
    2000 + i), clipped to [0, 1]; (4·len(sigmas), size, size, 3) float32,
    mapped to [-1, 1] when ``tanh``."""
    parts = []
    for i, sigma in enumerate(sigmas):
        clean01 = synth_clean_batch(torch.Generator().manual_seed(1000 + i),
                                    4, size)
        noise = torch.randn(clean01.shape,
                            generator=torch.Generator().manual_seed(2000 + i))
        parts.append(torch.clamp(clean01 + sigma * noise, 0.0, 1.0))
    batch01 = torch.cat(parts, dim=0)
    return batch01 * 2.0 - 1.0 if tanh else batch01
