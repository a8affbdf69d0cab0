"""Inputs made from the seed: noisy photographs as uint8 RGB.

The clean images follow the recipe of the port's ``data/synthetic.py``
(copied here, so that the yardstick does not move with the program): a
smooth colour field, a mid-frequency layer, antialiased rectangles and
ellipses, two band-limited texture layers coupled to luminance and a radial
vignette, clipped to [0, 1].  They hold what a denoiser's work depends on:
flat regions, sharp edges and fine texture.  The noise is Gaussian in [0, 1]
at the mix's sigma; the result is rounded to uint8, as a decoded upload is.
Everything is drawn on ``device`` from a ``torch.Generator`` seeded with the
run's seed, in a few large calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) \
        + lo


def _resize(x, size: int, mode: str):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode=mode,
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def clean_batch(gen: torch.Generator, n: int, size: int,
                num_shapes: int = 4) -> torch.Tensor:
    """(n, size, size, 3) float32 clean images in [0, 1] on ``gen``'s
    device."""
    img = _resize(_uniform(gen, (n, 6, 6, 3), 0.0, 1.0), size, "bicubic")
    img = img + _resize(_uniform(gen, (n, 24, 24, 3), -0.12, 0.12), size,
                        "bilinear")
    coords = torch.arange(size, dtype=torch.float32, device=gen.device)
    yy, xx = coords.view(1, size, 1), coords.view(1, 1, size)
    for _ in range(num_shapes):
        centre = _uniform(gen, (n, 2), 0.15 * size, 0.85 * size)
        dims = _uniform(gen, (n, 2), 0.06 * size, 0.30 * size)
        cy, cx = centre[:, 0].view(n, 1, 1), centre[:, 1].view(n, 1, 1)
        hh, ww = dims[:, 0].view(n, 1, 1), dims[:, 1].view(n, 1, 1)
        d_rect = torch.maximum((yy - cy).abs() - hh, (xx - cx).abs() - ww)
        d_ell = (torch.sqrt(((yy - cy) / hh) ** 2 + ((xx - cx) / ww) ** 2)
                 - 1.0) * torch.minimum(hh, ww)
        use_rect = torch.rand((n, 1, 1), generator=gen,
                              device=gen.device) < 0.5
        mask = torch.sigmoid(-torch.where(use_rect, d_rect, d_ell) / 1.5)
        color = _uniform(gen, (n, 1, 1, 3), 0.0, 1.0)
        img = img * (1.0 - mask.unsqueeze(-1)) + color * mask.unsqueeze(-1)
    amp = _uniform(gen, (n, 2), 0.0, 0.12).view(n, 2, 1, 1, 1)
    tex = (amp[:, 0] * _resize(_uniform(gen, (n, size // 4, size // 4, 3),
                                        -1.0, 1.0), size, "bilinear")
           + amp[:, 1] * _resize(_uniform(gen, (n, size // 2, size // 2, 3),
                                          -1.0, 1.0), size, "bilinear"))
    img = img + tex * img.mean(dim=-1, keepdim=True)
    r2 = ((yy / size - 0.5) ** 2 + (xx / size - 0.5) ** 2) * 2.0
    strength = _uniform(gen, (n, 1, 1), 0.0, 0.35)
    img = img * (1.0 - strength * r2).unsqueeze(-1)
    return torch.clamp(img, 0.0, 1.0)


def noisy_u8(seed: int, n: int, size: int, sigma: float, device,
             block: int = 16) -> torch.Tensor:
    """(n, size, size, 3) uint8 noisy images on ``device``, drawn from
    ``seed``; made ``block`` images at a time to bound the temporaries."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, block):
        m = min(block, n - i)
        clean = clean_batch(gen, m, size)
        noise = torch.randn(clean.shape, generator=gen, device=device)
        out[i:i + m] = torch.round(torch.clamp(clean + sigma * noise, 0.0,
                                               1.0) * 255.0).to(torch.uint8)
    return out


def served_domain(u8: torch.Tensor, domain: str) -> torch.Tensor:
    """uint8 NHWC -> float32 NHWC in the configuration's serving domain:
    "[0,1]" (x / 255) or "[-1,1]" ((x / 255 - 0.5) / 0.5, the reference's
    ``Normalize(0.5, 0.5)``)."""
    x01 = u8.float() / 255.0
    if domain == "[0,1]":
        return x01
    if domain == "[-1,1]":
        return (x01 - 0.5) / 0.5
    raise ValueError(f"unknown serving domain {domain!r}")
