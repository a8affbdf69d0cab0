"""s8 skip-storage int8 forward of the denoise U-Net.

Port of ``celebrity_image_denoiser_tpu/ops/quant_unet.py::
quantize_apply_denoise_unet`` (:91; the algebra is in its docstring): the
U-Net's skips, pool inputs and concat halves are stored as s8 at scales
sliced from the consuming conv's calibrated per-input-channel scales
(``s[10][64:]`` for e1, ``s[7][128:]`` for e2, ``s[7][:128]`` and
``s[10][:64]`` for the transpose convs' outputs), so every activation
between conv 0 and the output conv lives in s8; max-pool runs on the s8
tensor (it commutes with a positive scale and with rounding), and the conv
after each pool folds the storage scale.

Every conv rounds where the JAX program rounds:

* conv 0 (``_conv_f:73``, bf16): the conv rounded to bf16, the bias added
  in bf16, ReLU, then ``_q`` (true division, round half to even, clip ±127)
  — K2's s8-out mode, ``ops/cuda/conv3x3.py::conv3x3_bias_relu_q8``;
* convs 1–5, 7, 8, 10 and, with ``quant_last``, the output conv 11
  (``_conv_q:55``): s32 sums, ``bf16(f32(acc)·w_scale) + bias`` in bf16,
  ReLU, then ``_q`` at the next scale (conv 11: bf16 out) — K5,
  ``ops/cuda/conv3x3_s8.py``; convs 7 and 10 read their concat's two s8
  halves in place;
* the transpose convs up2 and up1 (``_convt_q:62``) — K6,
  ``ops/cuda/convt2x2_s8.py``;
* max-pool on s8 (``_maxpool_s8:80``) is a PyTorch reduction over the 2×2
  windows, as it was an XLA one;
* ``tanh`` of the bf16 output, then x's dtype.

The odd-size skip crop (:190-191, :202-203) is a strided view that K5 reads
in place.  Per forward on the card: K2 ×1, K5 ×9, K6 ×2.

``quantize_apply_denoise_unet`` returns a ``QuantizedDenoiseUNet``, an
``nn.Module`` whose buffers hold the s8 weights and every scale on the
model's device; ``forward(x, route=...)`` takes x NHWC in [-1, 1] (the
JAX layout) and returns the tanh output, NHWC, in x's dtype.  ``route`` is
``"kernel"`` (the kernel wrappers; on a CPU tensor they run their plain
versions) or ``"plain"`` (the plain versions on any device, the reference
``chip_smoke.py`` holds the kernel route against).  ``first_conv`` and
``body`` split the forward at conv 0's s8 output: K2 sums conv 0's bf16
products in another order than the plain f32 conv, so a rounding there may
fall the other way; everything after it is integer sums and single IEEE
roundings, equal bit for bit on both routes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.ops import quant
from celebrity_image_denoiser_tpu_torch.ops.cuda import (
    conv3x3,
    conv3x3_s8,
    convt2x2_s8,
)

ROUTES = ("kernel", "plain")

# per conv call, the kernel shape in the JAX package's layout (kH, kW, in /
# out as JAX holds it) — the U-Net topology (quant_unet.py:129-134)
EXPECTED = [
    (3, 3, 3, 64), (3, 3, 64, 64), (3, 3, 64, 128), (3, 3, 128, 128),
    (3, 3, 128, 256), (3, 3, 256, 256), (2, 2, 128, 256),
    (3, 3, 256, 128), (3, 3, 128, 128), (2, 2, 64, 128),
    (3, 3, 128, 64), (3, 3, 64, 3),
]
TRANSPOSED = (6, 9)  # up2, up1
# the generator's parameter paths, in call order
PATHS = ("down1.0", "down1.2", "down2.0", "down2.2", "bottleneck.0",
         "bottleneck.2", "up2", "upconv2.0", "upconv2.2", "up1", "upconv1.0",
         "upconv1.2")


def _jax_shape(weight: torch.Tensor) -> tuple:
    """A PyTorch conv weight's shape in the JAX package's layout: HWIO for a
    conv, (kH, kW, C_out, C_in) for a transpose conv — both (kH, kW, dim 1,
    dim 0) of PyTorch's."""
    a, b, kh, kw = (int(d) for d in weight.shape)
    return (kh, kw, b, a)


def maxpool_s8(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 VALID max-pool of an s8 NHWC tensor."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :2 * h2, :2 * w2].reshape(n, h2, 2, w2, 2, c).amax(
        dim=(2, 4))


def quantize_apply_denoise_unet(model: nn.Module, calib_x: torch.Tensor,
                                quant_last: bool = True,
                                split_concat: bool = False
                                ) -> "QuantizedDenoiseUNet":
    """Calibrate ``model`` (a ``DenoiseGenerator``) on ``calib_x`` (NHWC, in
    [-1, 1], on the model's device) and build its s8 skip-storage forward.

    Raises ``ValueError`` if the conv call sequence is not the 12-conv U-Net
    (callers fall back to the generic transform).  ``split_concat`` was a
    rejected experiment of the JAX package and is not ported."""
    if split_concat:
        raise NotImplementedError(
            "split_concat is a rejected experiment of the JAX package (kept "
            "there for its receipt) and is not ported (ROADMAP.md queue 1, "
            "'Not queued')")
    taps = quant.calibrate(model, calib_x)
    got = [_jax_shape(t[1]) for t in taps]
    if got != EXPECTED or [i for i, t in enumerate(taps) if t[2]] != list(
            TRANSPOSED):
        raise ValueError(f"not the denoise U-Net conv sequence (got {got}); "
                         "use quant.quantize_apply instead")
    return QuantizedDenoiseUNet(model, [t[0] for t in taps], quant_last)


class QuantizedDenoiseUNet(nn.Module):
    """The s8 skip-storage U-Net (see the module docstring)."""

    def __init__(self, model: nn.Module, amaxes, quant_last: bool = True):
        super().__init__()
        self.quant_last = quant_last
        # act_scale IS the serving floor recipe: the slicing below is only
        # valid while these stay bit-identical to the JAX package's
        s = [quant.act_scale(a) for a in amaxes]
        fold_scale = {1: s[1], 2: s[10][64:], 3: s[3], 4: s[7][128:],
                      5: s[5], 6: s[6], 7: s[7], 8: s[8], 9: s[9],
                      10: s[10], 11: s[11]}
        convs = dict(model.named_modules())
        with torch.no_grad():
            for i in range(1, 12):
                if i == 11 and not quant_last:
                    continue
                weight = convs[PATHS[i]].weight
                w_i8, w_scale, _ = quant.fold_and_quantize(
                    weight, fold_scale[i], i in TRANSPOSED)
                # the kernels' layouts: (Cout, 3, 3, Cin), (2, 2, Cout, Cin)
                perm = (2, 3, 1, 0) if i in TRANSPOSED else (0, 2, 3, 1)
                self.register_buffer(f"w{i}", w_i8.permute(perm).contiguous())
                self.register_buffer(f"ws{i}", w_scale.contiguous())
            for i in range(12):
                self.register_buffer(
                    f"b{i}", convs[PATHS[i]].bias.detach().to(torch.bfloat16))
            # conv 0 (and conv 11 without quant_last) in bf16, HWIO
            for i in (0, 11):
                self.register_buffer(
                    f"wf{i}", convs[PATHS[i]].weight.detach().permute(
                        2, 3, 1, 0).to(torch.bfloat16).contiguous())
            self.register_buffer("b0_f32", self.b0.float())
            # the scale each conv's output is stored at
            outs = {0: s[1], 1: s[10][64:], 2: s[3], 3: s[7][128:], 4: s[5],
                    5: s[6], 6: s[7][:128], 7: s[8], 8: s[9], 9: s[10][:64],
                    10: s[11]}
            for i, v in outs.items():
                self.register_buffer(f"so{i}", v.float().contiguous())
        self.scales = s  # the 12 calibrated scales, for inspection

    def forward(self, x: torch.Tensor, *, route: str = "kernel"
                ) -> torch.Tensor:
        return self.body(self.first_conv(x, route=route), route=route).to(
            x.dtype)

    @staticmethod
    def _check_route(route: str) -> bool:
        if route not in ROUTES:
            raise ValueError(f"unknown route {route!r}; choose from {ROUTES}")
        return route == "plain"

    @torch.inference_mode()
    def first_conv(self, x: torch.Tensor, *, route: str = "kernel"
                   ) -> torch.Tensor:
        """Conv 0: x NHWC in [-1, 1] → its s8 output at ``s[1]``.  The only
        step whose kernel and plain version may differ (K2 sums its bf16
        products in another order than the plain f32 conv)."""
        q8 = (conv3x3.conv3x3_bias_relu_q8_plain if self._check_route(route)
              else conv3x3.conv3x3_bias_relu_q8)
        return q8(x.to(torch.bfloat16).contiguous(), self.wf0, self.b0_f32,
                  self.so0)

    @torch.inference_mode()
    def body(self, h: torch.Tensor, *, route: str = "kernel"
             ) -> torch.Tensor:
        """Everything after conv 0: its s8 output → the bf16 tanh output.
        Integer sums and single IEEE roundings only, so the kernel and plain
        routes agree bit for bit on the same ``h``."""
        plain = self._check_route(route)
        k5 = conv3x3_s8.conv3x3_s8_plain if plain else conv3x3_s8.conv3x3_s8
        k6 = (convt2x2_s8.convt2x2_s8_plain if plain
              else convt2x2_s8.convt2x2_s8)

        def conv(i, h, relu=True, out=True, x2=None):
            return k5(h, getattr(self, f"w{i}"), getattr(self, f"ws{i}"),
                      getattr(self, f"b{i}"), relu=relu,
                      out_scale=getattr(self, f"so{i}") if out else None,
                      x2=x2)

        def up(i, h):
            return k6(h, getattr(self, f"w{i}"), getattr(self, f"ws{i}"),
                      getattr(self, f"b{i}"), out_scale=getattr(self, f"so{i}"))

        e1 = conv(1, h)                                    # stored s8
        e2 = conv(3, conv(2, maxpool_s8(e1)))              # stored s8
        bo = conv(5, conv(4, maxpool_s8(e2)))
        d2a = up(6, bo)
        if d2a.shape[1:3] != e2.shape[1:3]:                # skip-crop quirk
            e2 = e2[:, : d2a.shape[1], : d2a.shape[2]]
        d2 = conv(8, conv(7, d2a, x2=e2))
        d1a = up(9, d2)
        if d1a.shape[1:3] != e1.shape[1:3]:                # skip-crop quirk
            e1 = e1[:, : d1a.shape[1], : d1a.shape[2]]
        if self.quant_last:
            y = conv(11, conv(10, d1a, x2=e1), relu=False, out=False)
        else:
            h = conv(10, d1a, out=False, x2=e1)
            k2 = (conv3x3.conv3x3_bias_relu_plain if plain
                  else conv3x3.conv3x3_bias_relu)
            y = k2(h, self.wf11, torch.zeros(3, device=h.device),
                   relu=False) + self.b11
        return torch.tanh(y)
