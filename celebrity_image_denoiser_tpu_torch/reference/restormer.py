"""Plain reference of Restormer (Zamir et al., "Restormer: Efficient
Transformer for High-Resolution Image Restoration", CVPR 2022,
arXiv:2111.09881), as ``basicsr/models/archs/restormer_arch.py`` of
github.com/swz30/Restormer computes it, at the settings of
``Denoising/Options/GaussianColorDenoising_Restormer.yml`` (``ARCH``).

Plain PyTorch in float32, NCHW, one image at a time if the caller wishes:
no kernel of the port, no tiling, no batching of its own.  It imports
nothing of the port, so that the tests hold the port against an
independent copy of the equations.  The module names are the published
ones, so a published ``.pth`` loads key for key.

Departures from the published code, each noted where it is made:

* ``seed_parameters``: the published modules' default initialisation
  (``nn.Conv2d``'s kaiming-uniform with a = √5, LayerNorm weights ones),
  drawn from a ``torch.Generator`` seeded with ``init_seed`` in
  ``named_parameters()`` order; then the per-head temperatures, whose
  published default of one would make a forward that leaves them out
  indistinguishable, drawn from U(``temperature_range``) in the same order;
  then the output conv's weight scaled by ``output_scale`` (a power of
  two), so that a random-weight output clips on few pixels;
* ``forward(..., tf32=True)``: every conv's and matmul's operands rounded
  to TF32 (10 mantissa bits, to nearest, ties away), the control that a
  float32 comparison must be able to tell apart.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

ARCH = {"inp_channels": 3, "out_channels": 3, "dim": 48,
        "num_blocks": (4, 6, 6, 8), "num_refinement_blocks": 4,
        "heads": (1, 2, 4, 8), "ffn_expansion_factor": 2.66, "bias": False,
        "LayerNorm_type": "BiasFree"}
LN_EPS = 1e-5  # BiasFree_LayerNorm's


def _conv(cin: int, cout: int, k: int = 1, groups: int = 1) -> nn.Conv2d:
    """A published conv (no bias), made on the meta device: no draw."""
    return nn.Conv2d(cin, cout, k, padding=k // 2, groups=groups, bias=False,
                     device="meta")


class BiasFree_LayerNorm(nn.Module):  # noqa: N801 (the published name)
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device="meta"))


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.body = BiasFree_LayerNorm(dim)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.empty(num_heads, 1, 1,
                                                    device="meta"))
        self.qkv = _conv(dim, dim * 3)
        self.qkv_dwconv = _conv(dim * 3, dim * 3, 3, groups=dim * 3)
        self.project_out = _conv(dim, dim)


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_expansion_factor: float):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.project_in = _conv(dim, hidden * 2)
        self.dwconv = _conv(hidden * 2, hidden * 2, 3, groups=hidden * 2)
        self.project_out = _conv(hidden, dim)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim, ffn_expansion_factor)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int, embed_dim: int):
        super().__init__()
        self.proj = _conv(in_c, embed_dim, 3)


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(_conv(n_feat, n_feat // 2, 3),
                                  nn.PixelUnshuffle(2))


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(_conv(n_feat, n_feat * 2, 3),
                                  nn.PixelShuffle(2))


def _level(dim: int, heads: int, n: int, ffn: float) -> nn.Sequential:
    return nn.Sequential(*[TransformerBlock(dim, heads, ffn)
                           for _ in range(n)])


class Restormer(nn.Module):
    """The published network; parameters on the meta device until
    ``materialize`` (or a ``to_empty``) places them."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, bias: bool = False,
                 LayerNorm_type: str = "BiasFree"):  # noqa: N803
        super().__init__()
        if bias or LayerNorm_type != "BiasFree":
            raise ValueError("this reference holds the Gaussian colour "
                             "denoising settings: bias False, BiasFree")
        f = ffn_expansion_factor
        self.patch_embed = OverlapPatchEmbed(inp_channels, dim)
        self.encoder_level1 = _level(dim, heads[0], num_blocks[0], f)
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = _level(dim * 2, heads[1], num_blocks[1], f)
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = _level(dim * 4, heads[2], num_blocks[2], f)
        self.down3_4 = Downsample(dim * 4)
        self.latent = _level(dim * 8, heads[3], num_blocks[3], f)
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = _conv(dim * 8, dim * 4)
        self.decoder_level3 = _level(dim * 4, heads[2], num_blocks[2], f)
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = _conv(dim * 4, dim * 2)
        self.decoder_level2 = _level(dim * 2, heads[1], num_blocks[1], f)
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = _level(dim * 2, heads[0], num_blocks[0], f)
        self.refinement = _level(dim * 2, heads[0], num_refinement_blocks, f)
        self.output = _conv(dim * 2, out_channels, 3)

    # -- the published forward, functionally, with optional TF32 operands --
    def _r(self, t: torch.Tensor) -> torch.Tensor:
        return round_tf32(t) if self._tf32 else t

    def _conv(self, m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self._r(x), self._r(m.weight), None,
                        padding=m.padding, groups=m.groups)

    def _ln(self, m: LayerNorm, x: torch.Tensor) -> torch.Tensor:
        # to_3d, BiasFree_LayerNorm over the channels of each pixel, to_4d
        t = x.permute(0, 2, 3, 1)
        sigma = t.var(-1, keepdim=True, unbiased=False)
        t = t / torch.sqrt(sigma + LN_EPS) * m.body.weight
        return t.permute(0, 3, 1, 2)

    def _attention(self, m: Attention, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = self._conv(m.qkv_dwconv, self._conv(m.qkv, x))
        q, k, v = qkv.chunk(3, dim=1)
        heads = m.num_heads
        q, k, v = (t.reshape(b, heads, c // heads, h * w) for t in (q, k, v))
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = (self._r(q) @ self._r(k).transpose(-2, -1)) * m.temperature
        attn = attn.softmax(dim=-1)
        out = (self._r(attn) @ self._r(v)).reshape(b, c, h, w)
        return self._conv(m.project_out, out)

    def _ffn(self, m: FeedForward, x: torch.Tensor) -> torch.Tensor:
        x = self._conv(m.project_in, x)
        x1, x2 = self._conv(m.dwconv, x).chunk(2, dim=1)
        return self._conv(m.project_out, F.gelu(x1) * x2)

    def _blocks(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for blk in seq:
            x = x + self._attention(blk.attn, self._ln(blk.norm1, x))
            x = x + self._ffn(blk.ffn, self._ln(blk.norm2, x))
        return x

    def _resample(self, m, x: torch.Tensor) -> torch.Tensor:
        return m.body[1](self._conv(m.body[0], x))

    @torch.no_grad()
    def forward(self, inp_img: torch.Tensor, *, tf32: bool = False
                ) -> torch.Tensor:
        self._tf32 = tf32
        enc1 = self._blocks(self.encoder_level1,
                            self._conv(self.patch_embed.proj, inp_img))
        enc2 = self._blocks(self.encoder_level2,
                            self._resample(self.down1_2, enc1))
        enc3 = self._blocks(self.encoder_level3,
                            self._resample(self.down2_3, enc2))
        latent = self._blocks(self.latent, self._resample(self.down3_4, enc3))
        d3 = torch.cat([self._resample(self.up4_3, latent), enc3], 1)
        d3 = self._blocks(self.decoder_level3,
                          self._conv(self.reduce_chan_level3, d3))
        d2 = torch.cat([self._resample(self.up3_2, d3), enc2], 1)
        d2 = self._blocks(self.decoder_level2,
                          self._conv(self.reduce_chan_level2, d2))
        d1 = torch.cat([self._resample(self.up2_1, d2), enc1], 1)
        d1 = self._blocks(self.refinement,
                          self._blocks(self.decoder_level1, d1))
        return self._conv(self.output, d1) + inp_img


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest, ties away."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def build(arch: Optional[dict] = None) -> Restormer:
    """The network at ``arch`` (default ``ARCH``) on the meta device."""
    return Restormer(**dict(ARCH, **(arch or {})))


@torch.no_grad()
def seed_parameters(model: nn.Module, init_seed: int,
                    temperature_range=(1.0, 1.0),
                    output_scale: float = 1.0) -> nn.Module:
    """Place ``model``'s parameters on the CPU and draw them (the module
    docstring): every conv's weight by ``nn.init.kaiming_uniform_(a=√5)``
    and every LayerNorm weight one, in ``named_parameters()`` order from
    one generator seeded with ``init_seed``; then the temperatures from
    U(``temperature_range``) in the same order; then the output conv's
    weight times ``output_scale``."""
    model.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(int(init_seed))
    temps = []
    for name, p in model.named_parameters():
        if name.endswith("temperature"):
            temps.append(p)
        elif p.dim() == 4:
            nn.init.kaiming_uniform_(p, a=math.sqrt(5), generator=gen)
        else:
            p.fill_(1.0)
    lo, hi = temperature_range
    for p in temps:
        p.uniform_(lo, hi, generator=gen)
    model.output.weight.mul_(output_scale)
    return model


def n_parameters(arch: Optional[dict] = None) -> int:
    """The parameter count at ``arch``, counted on the meta device."""
    return sum(p.numel() for p in build(arch).parameters())
