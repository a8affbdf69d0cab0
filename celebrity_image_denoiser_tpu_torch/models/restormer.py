"""Restormer, for blind Gaussian colour denoising (Zamir et al., "Restormer:
Efficient Transformer for High-Resolution Image Restoration", CVPR 2022,
arXiv:2111.09881; github.com/swz30/Restormer,
``basicsr/models/archs/restormer_arch.py`` at the settings of
``Denoising/Options/GaussianColorDenoising_Restormer.yml``).

A four-level encoder-decoder of transformer blocks, ``dim`` 48,
``num_blocks`` (4, 6, 6, 8), 4 refinement blocks, ``heads`` (1, 2, 4, 8),
``ffn_expansion_factor`` 2.66, no bias, BiasFree LayerNorm; 26,111,668
parameters.  Each block is ``x + MDTA(LN(x))`` then ``x + GDFN(LN(x))``:

* MDTA, the transposed channel attention: a 1×1 conv C → 3C, a depthwise
  3×3, then per head of d = C / heads channels the d × d matrix
  ``softmax(normalize(q) normalize(k)ᵀ · temperature)`` over all pixels,
  ``A · v``, and a 1×1 projection;
* GDFN, the gated feed-forward: a 1×1 conv C → 2·hidden, a depthwise 3×3,
  ``gelu(x₁) · x₂`` (exact GELU), a 1×1 conv back to C;
* LayerNorm over each pixel's channels: ``x / sqrt(var(x) + 1e-5) · w``.

Down steps are a 3×3 conv C → C/2 and a pixel unshuffle, up steps a 3×3
conv C → 2C and a pixel shuffle; levels 3 and 2 concatenate the skip and
reduce it by a 1×1 conv, level 1 only concatenates (96 channels); the
output is a 3×3 conv 96 → 3 plus the input.  Served in the [0, 1] domain,
padded to a multiple of 8.

Child names are the published module names, so a published ``.pth``
(``params``) maps key for key.  The parameters are stored as published
(OIHW conv weights, the temperatures (heads, 1, 1)).  Seeded
initialisation (``seed_parameters``): the published defaults —
``nn.init.kaiming_uniform_(a=√5)`` for every conv, LayerNorm weights one —
drawn in ``named_parameters()`` order from a generator seeded with
``init_seed``; then the temperatures, whose default of one would hide a
forward that leaves them out, from U(``temperature_range``); then the
output conv's weight times ``output_scale``.

``forward(x, route=...)`` on NHWC tensors (handed in as their NCHW view,
as the server hands every model):

* ``"kernel"`` — the 3×3 convs on K2 (``ops/cuda/conv3x3.py``, no bias or
  ReLU), MDTA's core on K7 (``ops/cuda/channel_attention.py``), both
  depthwise convs on K8 (``ops/cuda/dwconv3x3.py``; GDFN's gate fused),
  every 1×1 conv on K9 (``ops/cuda/pointwise_gemm.py``, float32 as three
  TF32 products) with each block's LayerNorm folded into the GEMM after it
  and each block's residual add into the GEMM that ends its branch, pixel
  (un)shuffle and the skip concatenation as tensor ops;
* ``"plain"`` — the same function through the kernels' plain versions.

Two departures from the published order of operations, both
re-associations that save full-resolution passes:

* ``A · v`` and the projection are one GEMM, ``v · W_effᵀ`` with ``W_eff =
  W_proj · blockdiag(A_h)`` (a C × C matrix per image);
* LayerNorm is not applied before the 1×1 conv that follows it: BiasFree
  LayerNorm takes no mean out, so ``LN(x) · Wᵀ = r ⊙ (x · (W ·
  diag(g))ᵀ)`` with ``r = 1 / sqrt(var(x) + 1e-5)`` a pixel; the weight
  ``g`` is folded into the conv's (cached) weight and K9 scales each
  output row by ``r``, computed from the rows it reads.  No normalised
  tensor is made.

Spans (``utils/profiling.py::SPANS``): ``cid.restormer.attention`` (one
MDTA, its LayerNorm and residual add included), ``cid.restormer.ffn`` (one
GDFN) and ``cid.restormer.resample`` (a down or up step with its skip
concatenation and reduction): 44, 44 and 6 a forward at the published
depths.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.models.denoise_unet import nchw, nhwc
from celebrity_image_denoiser_tpu_torch.models.srgan import (
    pixel_shuffle_nhwc,
    pixel_unshuffle_nhwc,
)
from celebrity_image_denoiser_tpu_torch.ops.cuda import (
    channel_attention,
    conv3x3,
    dwconv3x3,
    pointwise_gemm,
)
from celebrity_image_denoiser_tpu_torch.utils.profiling import span

ROUTES = ("kernel", "plain")


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


@torch.no_grad()
def seed_parameters(model: nn.Module, init_seed: int,
                    temperature_range=(1.0, 1.0),
                    output_scale: float = 1.0) -> None:
    """Place ``model``'s parameters on the CPU and draw them (the module
    docstring)."""
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


# The two calls a planted fault replaces (looked up at call time)
def attention_maps(qkv: torch.Tensor, heads: int, temperature: torch.Tensor,
                   route: str) -> torch.Tensor:
    """Each head's softmaxed d × d attention (N, heads, d, d): K7, or its
    plain version."""
    if route == "plain":
        return channel_attention.channel_attention_plain(qkv, heads,
                                                         temperature)
    return channel_attention.channel_attention(qkv, heads, temperature)


def depthwise(x: torch.Tensor, w: torch.Tensor, gate: bool,
              route: str) -> torch.Tensor:
    """A depthwise 3×3 conv, GDFN's gate fused where asked: K8, or its
    plain version."""
    if route == "plain":
        return dwconv3x3.dwconv3x3_plain(x, w, gate=gate)
    return dwconv3x3.dwconv3x3(x, w, gate=gate)


def pointwise(a: torch.Tensor, w: torch.Tensor, layer_norm: bool,
              residual: Optional[torch.Tensor], route: str,
              w_tf32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 1×1 conv as a GEMM over a's pixel rows, a BiasFree LayerNorm
    folded in as a row scale where asked (its weight already in ``w``) and
    ``residual`` added: K9, or its plain version."""
    if route == "plain":
        return pointwise_gemm.pointwise_gemm_plain(
            a, w, layer_norm=layer_norm, residual=residual)
    return pointwise_gemm.pointwise_gemm(a, w, layer_norm=layer_norm,
                                         residual=residual, w_tf32=w_tf32)


def fold_attention(w_proj: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """``W_proj · blockdiag(A_h)`` per image: w_proj (C, C), attn (N,
    heads, d, d) → (N, C, C), so that ``v · W_effᵀ`` is the projection of
    ``A · v``."""
    n, heads, d, _ = attn.shape
    c = heads * d
    w = w_proj.view(c, heads, d).permute(1, 0, 2).unsqueeze(0)  # 1,h,C,d
    return torch.matmul(w, attn).permute(0, 2, 1, 3).reshape(n, c, c)


class Restormer(nn.Module):
    """Input (N, 3, H, W) in [0, 1] (an NHWC tensor's NCHW view), H and W
    multiples of 8; output the same shape, the restored image (not
    clipped)."""

    def __init__(self, inp_channels: int = 3, out_channels: int = 3,
                 dim: int = 48, num_blocks: Sequence[int] = (4, 6, 6, 8),
                 num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8),
                 ffn_expansion_factor: float = 2.66, *,
                 init_seed: Optional[int] = 0,
                 temperature_range: Tuple[float, float] = (1.0, 1.0),
                 output_scale: float = 1.0):
        super().__init__()
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
        if init_seed is not None:
            seed_parameters(self, init_seed, temperature_range, output_scale)
        # kernel-layout copies of the weights, rebuilt when one changes;
        # not part of the state_dict
        self._kparams: Dict[str, tuple] = {}

    # -- kernel-layout weights -------------------------------------------
    def _cached(self, name: str, make, *params: torch.Tensor):
        # an inference tensor has no version counter (and cannot change)
        stamp = tuple((p.data_ptr(), p.device,
                       None if p.is_inference() else p._version)
                      for p in params)
        hit = self._kparams.get(name)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = (stamp, make(*(p.detach() for p in params)))
            self._kparams[name] = hit
        return hit[1]

    def _conv3(self, name: str, conv: nn.Conv2d, x: torch.Tensor,
               route: str) -> torch.Tensor:
        """A 3×3 conv (no bias): K2, or its plain version."""
        def make(w):
            hwio = w.permute(2, 3, 1, 0).contiguous()
            split = (conv3x3.tf32_weights(hwio) if hwio.shape[3] > 4
                     else None)
            return hwio, w.new_zeros(hwio.shape[3]), split
        hwio, zero, split = self._cached(name, make, conv.weight)
        if route == "plain":
            return conv3x3.conv3x3_bias_relu_plain(x, hwio, zero, relu=False)
        return conv3x3.conv3x3_bias_relu(x, hwio, zero, relu=False,
                                         kernel_tf32=split)

    def _taps(self, name: str, conv: nn.Conv2d) -> torch.Tensor:
        return self._cached(name, dwconv3x3.tap_weights, conv.weight)

    def _pointwise(self, name: str, conv: nn.Conv2d, x: torch.Tensor,
                   route: str, norm: Optional[LayerNorm] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A 1×1 conv (no bias) with the LayerNorm before it folded in where
        there is one: its weight ``W · diag(g)`` (Cout, Cin) and K9's split
        of it are cached, rebuilt when either parameter changes."""
        def make(w, g=None):
            w = w.flatten(1) if g is None else w.flatten(1) * g
            return w, pointwise_gemm.gemm_weights(w)
        params = (conv.weight,) + (() if norm is None else
                                   (norm.body.weight,))
        w, split = self._cached(name, make, *params)
        return pointwise(x, w, norm is not None, residual, route, split)

    # -- the blocks ---------------------------------------------------------
    def _attention(self, name: str, blk: TransformerBlock, x: torch.Tensor,
                   route: str) -> torch.Tensor:
        """x + MDTA(LN(x)) on NHWC x."""
        m = blk.attn
        c = x.shape[3]
        with span("cid.restormer.attention"):
            qkv = depthwise(self._pointwise(f"{name}.attn.qkv", m.qkv, x,
                                            route, norm=blk.norm1),
                            self._taps(f"{name}.attn.qkv_dwconv",
                                       m.qkv_dwconv), False, route)
            attn = attention_maps(qkv, m.num_heads, m.temperature.view(-1),
                                  route)
            w_eff = fold_attention(m.project_out.weight.flatten(1), attn)
            return pointwise(qkv[..., 2 * c:], w_eff, False, x, route)

    def _ffn(self, name: str, blk: TransformerBlock, x: torch.Tensor,
             route: str) -> torch.Tensor:
        """x + GDFN(LN(x)) on NHWC x."""
        m = blk.ffn
        with span("cid.restormer.ffn"):
            g = depthwise(self._pointwise(f"{name}.ffn.project_in",
                                          m.project_in, x, route,
                                          norm=blk.norm2),
                          self._taps(f"{name}.ffn.dwconv", m.dwconv), True,
                          route)
            return self._pointwise(f"{name}.ffn.project_out", m.project_out,
                                   g, route, residual=x)

    def _blocks(self, name: str, seq: nn.Sequential, x: torch.Tensor,
                route: str) -> torch.Tensor:
        for i, blk in enumerate(seq):
            x = self._attention(f"{name}.{i}", blk, x, route)
            x = self._ffn(f"{name}.{i}", blk, x, route)
        return x

    def _down(self, name: str, m: Downsample, x: torch.Tensor,
              route: str) -> torch.Tensor:
        with span("cid.restormer.resample"):
            return pixel_unshuffle_nhwc(
                self._conv3(f"{name}.body.0", m.body[0], x, route), 2)

    def _up(self, name: str, m: Upsample, x: torch.Tensor,
            skip: torch.Tensor, reduce: Optional[nn.Conv2d],
            route: str) -> torch.Tensor:
        """The up step, the skip concatenated, and the 1×1 reduction where
        the level has one."""
        with span("cid.restormer.resample"):
            y = pixel_shuffle_nhwc(
                self._conv3(f"{name}.body.0", m.body[0], x, route), 2)
            y = torch.cat([y, skip], dim=3)
            return y if reduce is None else self._pointwise(
                f"{name}.reduce", reduce, y, route)

    def forward(self, x: torch.Tensor, *, route: str = "kernel"
                ) -> torch.Tensor:
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; choose from {ROUTES}")
        conv3x3.refuse_grad(f"Restormer route={route!r}", x,
                            *self.parameters())
        inp = nhwc(x)
        if inp.shape[1] % 8 or inp.shape[2] % 8:
            raise ValueError(f"H and W must be multiples of 8 (three "
                             f"halvings), got {tuple(inp.shape[1:3])}")
        enc1 = self._blocks("encoder_level1", self.encoder_level1,
                            self._conv3("patch_embed.proj",
                                        self.patch_embed.proj, inp, route),
                            route)
        enc2 = self._blocks("encoder_level2", self.encoder_level2,
                            self._down("down1_2", self.down1_2, enc1, route),
                            route)
        enc3 = self._blocks("encoder_level3", self.encoder_level3,
                            self._down("down2_3", self.down2_3, enc2, route),
                            route)
        lat = self._blocks("latent", self.latent,
                           self._down("down3_4", self.down3_4, enc3, route),
                           route)
        d3 = self._blocks("decoder_level3", self.decoder_level3,
                          self._up("up4_3", self.up4_3, lat, enc3,
                                   self.reduce_chan_level3, route), route)
        d2 = self._blocks("decoder_level2", self.decoder_level2,
                          self._up("up3_2", self.up3_2, d3, enc2,
                                   self.reduce_chan_level2, route), route)
        d1 = self._blocks("decoder_level1", self.decoder_level1,
                          self._up("up2_1", self.up2_1, d2, enc1, None,
                                   route), route)
        d1 = self._blocks("refinement", self.refinement, d1, route)
        y = self._conv3("output", self.output, d1, route) + inp
        return nchw(y)
