"""Post-training int8 quantization for the serving path: the generic
transform.

Port of ``celebrity_image_denoiser_tpu/ops/quant.py`` (the design is in its
docstring): a transform over the existing model code.  Calibration records,
per conv, the per-input-channel ``max|x|`` of its input on a batch in the
serving domain; the transform then replays each conv positionally as

    x_i8 = clamp(round(x / s_c), ±127)       s_c = act_scale(amax), per
                                             input channel, folded into
                                             the weight (SmoothQuant-style)
    y = f32(conv_s32(x_i8, w_i8)) · w_scale  per output channel, then cast
                                             to x's dtype; + correction

with the bias added in x's dtype by the layer, as the float path adds it.
Convs the skip policy names (3-channel image-side layers) run the float
path.

In PyTorch idiom:

* **calibration** is a forward hook on every ``nn.Conv2d`` /
  ``nn.ConvTranspose2d`` of the model, over one float32 forward that calls
  those modules — ``DenoiseGenerator``'s ``route="autograd"``.  Its kernel
  and plain routes hide conv 1 of each pair inside the fused pair, so
  calibration never goes through them.  The hooks see the JAX package's
  call order (for the U-Net: ``down1.0`` … ``bottleneck.2``, ``up2``,
  ``upconv2.0``, ``upconv2.2``, ``up1``, ``upconv1.0``, ``upconv1.2``).
* **the replay** cannot be a forward hook (it must replace the float conv,
  not follow it), so ``ops/conv.py``'s layer functions consult
  ``conv_hook`` first, as the JAX package's ``ops.conv2d`` does; the int8
  products run the hand-written kernels ``conv3x3_s8`` (3×3, stride 1,
  padding 1, at most ``conv3x3_s8.MAX_CIN`` input channels) and
  ``convt2x2_s8`` (2×2, stride 2) on the card, and an exact float64 product
  on the CPU for any other geometry.  On a card a geometry with no kernel
  raises ``NoInt8Kernel``, a ``ValueError``: the serving ladder then moves
  down a rung, while a kernel that fails stays loud.

Replay is positional, so a model whose conv sequence changed since
calibration fails loudly: over-consumed, a shape mismatch, under-consumed
(three ``ValueError``s, as in the JAX package).  ``bias_correct=True`` runs
one more pass on a subsample of the calibration batch that records, per
conv, the mean per-output-channel error of the int8 conv against the float
conv on the quantized cascade's own inputs, and replays it as an additive
constant.

Not ported here: ``fake_quant`` / ``_FakeQuant`` (quantization-aware
training) and ``make_indexed_skip`` / ``ESRGAN_TRUNK_CALLS`` (they come with
the esrgan family); ``ROADMAP.md`` lists them.
"""

from __future__ import annotations

import contextlib
import contextvars
import inspect
from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_MODE = contextvars.ContextVar("cid_torch_quant_mode", default=None)


class _Int8Apply:
    """Replays quantized entries positionally; ``entries[i] is None`` means
    'run this conv in float' (skip policy)."""

    def __init__(self, entries: List[Optional[tuple]]):
        self.entries = entries
        self.i = 0


class _BiasCorrectCollect(_Int8Apply):
    """The replay, recording per conv the per-output-channel mean of (float
    conv − int8 conv) on the quantized cascade's own inputs, applied at once
    so deeper corrections see the corrected cascade (sequential)."""

    def __init__(self, entries: List[Optional[tuple]]):
        super().__init__(entries)
        self.corrections: List[Optional[torch.Tensor]] = []


@contextlib.contextmanager
def _mode(m):
    tok = _MODE.set(m)
    try:
        yield
    finally:
        _MODE.reset(tok)


def default_skip_policy(weight: torch.Tensor) -> bool:
    """Skip quantization for convs with fewer than 8 input or output
    channels (the 3-channel image-side layers)."""
    return int(weight.shape[0]) < 8 or int(weight.shape[1]) < 8


def act_scale(amax_c: torch.Tensor) -> torch.Tensor:
    """Per-channel int8 activation scale from per-channel ``max|x|``, each
    channel floored at 1% of the busiest channel's.  Bit-identical to the
    JAX package's: the s8 program slices these scales per concat half."""
    amax_c = amax_c.float()
    return torch.clamp_min(torch.maximum(amax_c, 0.01 * amax_c.max()),
                           1e-12) / 127.0


def quantize_weight(weight: torch.Tensor, out_axis: int = 0):
    """Symmetric per-output-channel int8 weight quantization → (w_i8,
    scale (C_out,) f32)."""
    k = weight.float()
    out_axis %= k.dim()
    dims = tuple(i for i in range(k.dim()) if i != out_axis)
    amax = k.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    w_i8 = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return w_i8, scale.reshape(-1)


def quantize_activation(x: torch.Tensor, s_c: torch.Tensor) -> torch.Tensor:
    """x (N, C, …) → s8 at per-channel scales s_c: true division, round half
    to even, clip to ±127."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return torch.clamp(torch.round(x.float() / s_c.view(shape)), -127,
                       127).to(torch.int8)


def fold_and_quantize(weight: torch.Tensor, s_c: torch.Tensor,
                      transposed: bool):
    """Fold per-input-channel activation scales into ``weight``
    (conv(x/s_c, w·s_c) == conv(x, w)) and quantize it per output channel.
    PyTorch's layouts: (C_out, C_in, kH, kW) for a conv, (C_in, C_out, kH,
    kW) for a transpose conv.  A grouped conv (in-axis narrower than s_c)
    takes one scalar scale."""
    out_axis, in_axis = (1, 0) if transposed else (0, 1)
    if int(weight.shape[in_axis]) != int(s_c.shape[0]):
        s_c = s_c.max().reshape(1)
    shape = [1] * weight.dim()
    shape[in_axis] = -1
    w_i8, w_scale = quantize_weight(weight.float() * s_c.view(shape),
                                    out_axis)
    return w_i8, w_scale, s_c


# ---------------------------------------------------------------------------
# calibration: forward hooks on the conv modules
def _float_forward(model: nn.Module, x_nhwc: torch.Tensor) -> torch.Tensor:
    """The model's float forward through its conv modules (NHWC in/out)."""
    kwargs = {}
    if "route" in inspect.signature(model.forward).parameters:
        kwargs["route"] = "autograd"
    y = model(x_nhwc.permute(0, 3, 1, 2), **kwargs)
    return y.permute(0, 2, 3, 1) if y.dim() == 4 else y


def calibrate(model: nn.Module, calib_x: torch.Tensor,
              quantile: Optional[float] = None) -> List[tuple]:
    """One float32 forward over ``calib_x`` (NHWC, the serving domain) with
    a forward hook on every conv module: per call, (per-input-channel
    ``max|x|`` — or its ``quantile`` — f32, the module's weight, whether it
    is a transpose conv, the input's spatial size)."""
    taps: List[tuple] = []

    def hook(module, inputs, _output):
        x = inputs[0].detach().float()
        flat = x.abs().transpose(0, 1).reshape(x.shape[1], -1)
        if quantile is None:
            amax = flat.amax(dim=1)
        else:
            amax = torch.quantile(flat, quantile, dim=1)
        taps.append((amax, module.weight.detach(),
                     isinstance(module, nn.ConvTranspose2d),
                     int(x.shape[2]) * int(x.shape[3])))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.inference_mode():
            _float_forward(model, calib_x.float())
    finally:
        for h in handles:
            h.remove()
    return taps


# ---------------------------------------------------------------------------
# the replay (called by ops/conv.py before the float conv)
def int8_conv2d(x_i8: torch.Tensor, w_i8: torch.Tensor,
                w_scale: torch.Tensor, stride, padding) -> torch.Tensor:
    """f32(conv_s32(x_i8, w_i8)) · w_scale, NCHW, PyTorch weight layout."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8

    c_in = int(x_i8.shape[1])
    if tuple(w_i8.shape[2:]) == (3, 3) and _pair(stride) == (1, 1) \
            and _pair(padding) == (1, 1) and c_in % conv3x3_s8.CHUNK == 0 \
            and c_in <= conv3x3_s8.MAX_CIN:
        y = conv3x3_s8.conv3x3_s8(x_i8.permute(0, 2, 3, 1).contiguous(),
                                  w_i8.permute(0, 2, 3, 1).contiguous(),
                                  w_scale)
        return y.permute(0, 3, 1, 2)
    _no_kernel(x_i8, "conv", w_i8.shape, stride)
    acc = F.conv2d(x_i8.double(), w_i8.double(), stride=stride,
                   padding=padding).to(torch.int32)
    return acc.float() * w_scale.view(1, -1, 1, 1)


def int8_conv_transpose2d(x_i8: torch.Tensor, w_i8: torch.Tensor,
                          w_scale: torch.Tensor, stride) -> torch.Tensor:
    """The transpose conv's counterpart of ``int8_conv2d`` (no padding)."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import convt2x2_s8

    c_in, c_out = int(w_i8.shape[0]), int(w_i8.shape[1])
    if tuple(w_i8.shape[2:]) == (2, 2) and _pair(stride) == (2, 2) \
            and convt2x2_s8.fits(c_in, c_out):
        y = convt2x2_s8.convt2x2_s8(x_i8.permute(0, 2, 3, 1).contiguous(),
                                    w_i8.permute(2, 3, 1, 0).contiguous(),
                                    w_scale)
        return y.permute(0, 3, 1, 2)
    _no_kernel(x_i8, "transpose conv", w_i8.shape, stride)
    acc = F.conv_transpose2d(x_i8.double(), w_i8.double(),
                             stride=stride).to(torch.int32)
    return acc.float() * w_scale.view(1, -1, 1, 1)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class NoInt8Kernel(ValueError):
    """No int8 kernel takes this conv's geometry on this device.  A
    ``ValueError``, as a builder's other refusals are, so that the serving
    ladder moves down a rung; a kernel that fails raises ``RuntimeError``."""


def _no_kernel(x, what, shape, stride):
    if x.device.type != "cpu":
        raise NoInt8Kernel(
            f"no int8 kernel for a {what} of weight {tuple(shape)} at stride "
            f"{stride} on {x.device} (the kernels take 3x3 stride-1 padding-1 "
            "convs of at most 256 input channels and 2x2 stride-2 transpose "
            "convs, channels a multiple of 32; see ops/cuda/convt2x2_s8.py::"
            "fits)")


def conv_hook(x: torch.Tensor, weight: torch.Tensor, run_int8: Callable,
              run_float: Callable) -> Optional[torch.Tensor]:
    """Called by ``ops/conv.py`` before its float conv.  Under a replay:
    ``run_int8(x_i8, w_i8, w_scale)`` gives the f32 dequantized product and
    ``run_float(x_f32, w_f32)`` the float conv (bias excluded); returns the
    int8 path's output in x's dtype before the bias, or None for the float
    path."""
    mode = _MODE.get()
    if mode is None:
        return None
    if mode.i >= len(mode.entries):
        raise ValueError(
            f"int8 replay over-consumed: conv call #{mode.i} but only "
            f"{len(mode.entries)} entries were calibrated — the model's "
            "conv call sequence changed since quantize_apply() calibrated "
            "it (re-calibrate after any model/topology edit)")
    entry = mode.entries[mode.i]
    mode.i += 1
    if entry is None:
        if isinstance(mode, _BiasCorrectCollect):
            mode.corrections.append(None)
        return None
    w_i8, w_scale, s_c = entry[:3]
    corr = entry[3] if len(entry) > 3 else None
    if tuple(w_i8.shape) != tuple(weight.shape):
        raise ValueError(
            f"int8 replay mismatch at conv call #{mode.i - 1}: calibrated "
            f"kernel shape {tuple(w_i8.shape)} != traced kernel shape "
            f"{tuple(weight.shape)} — re-calibrate with quantize_apply()")
    xf = x.float()
    y = run_int8(quantize_activation(xf, s_c), w_i8, w_scale).to(x.dtype)
    if isinstance(mode, _BiasCorrectCollect):
        y_f = run_float(xf, weight.float())
        corr = (y_f - y.float()).mean(dim=(0, 2, 3))
        mode.corrections.append(corr)
    if corr is not None:
        y = y + corr.to(y.dtype).view(1, -1, 1, 1)
    return y


# ---------------------------------------------------------------------------
class QuantizedApply:
    """``qapply(x) -> y``: the model's forward with every calibrated conv
    replayed in int8; x and y NHWC, as the JAX package's ``qapply``."""

    def __init__(self, model: nn.Module, entries: List[Optional[tuple]]):
        self.model = model
        self.entries = entries

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ctx = _Int8Apply(list(self.entries))
        with torch.inference_mode(), _mode(ctx):
            y = _float_forward(self.model, x)
        if ctx.i != len(ctx.entries):
            raise ValueError(
                f"int8 replay under-consumed: {ctx.i} conv calls traced but "
                f"{len(ctx.entries)} entries were calibrated — the model's "
                "conv call sequence changed since quantize_apply() "
                "calibrated it (re-calibrate after any model/topology edit)")
        return y


def bias_correct_subsample(calib_x: torch.Tensor) -> torch.Tensor:
    """≤ 8 images strided over the batch, centre-cropped to ≤ 48² (NHWC):
    the means converge on far fewer pixels than the ranges need."""
    sub = calib_x[:: max(1, calib_x.shape[0] // 8)][:8]
    if sub.dim() == 4 and sub.shape[1] > 48 and sub.shape[2] > 48:
        h0 = (sub.shape[1] - 48) // 2
        w0 = (sub.shape[2] - 48) // 2
        sub = sub[:, h0:h0 + 48, w0:w0 + 48, :]
    return sub


def quantize_apply(model: nn.Module, calib_x: torch.Tensor,
                   skip: Callable = default_skip_policy,
                   act_quantile: Optional[float] = None,
                   bias_correct: bool = False) -> QuantizedApply:
    """Build the int8 eval forward for ``model`` from ``calib_x`` (NHWC, the
    serving domain, on the model's device); see the module docstring."""
    taps = calibrate(model, calib_x, act_quantile)
    if not taps:
        raise ValueError("no convs were traced — nothing to quantize")
    entries: List[Optional[tuple]] = []
    for amax_c, weight, transposed, _ in taps:
        if skip(weight):
            entries.append(None)
            continue
        entries.append(fold_and_quantize(weight, act_scale(amax_c),
                                         transposed))
    if bias_correct:
        ctx = _BiasCorrectCollect(list(entries))
        with torch.inference_mode(), _mode(ctx):
            _float_forward(model, bias_correct_subsample(calib_x).float())
        if len(ctx.corrections) != len(entries):
            raise ValueError(
                f"bias-correction pass traced {len(ctx.corrections)} convs "
                f"but {len(entries)} were calibrated")
        entries = [None if e is None else (*e, c)
                   for e, c in zip(entries, ctx.corrections)]
    return QuantizedApply(model, entries)


def quantized_fraction(model: nn.Module, calib_x: torch.Tensor,
                       skip: Callable = default_skip_policy) -> float:
    """Fraction of conv FLOPs the policy quantizes (input positions × weight
    size per conv); one image is enough, since only shapes count."""
    tot = q = 0.0
    for _, weight, _, spatial in calibrate(model, calib_x[:1]):
        f = float(weight.numel()) * spatial
        tot += f
        if not skip(weight):
            q += f
    return q / max(tot, 1.0)
