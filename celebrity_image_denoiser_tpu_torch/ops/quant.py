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
  products run the hand-written kernels ``conv3x3_s8`` (K5: 3×3, stride 1,
  padding 1, at most ``conv3x3_s8.MAX_CIN`` input channels) and
  ``convt2x2_s8`` (K6: 2×2, stride 2, no padding) on the card, and an exact
  float64 product on the CPU for any other geometry.  The cGAN's 4×4
  stride-2 padding-1 convs and transpose convs reach K5 on the card through
  exact rewrites (``s2d_conv4x4_s8``, ``d2s_convt4x4_s8``: zero taps add
  nothing to an integer sum).  On a card a geometry with no kernel raises
  ``NoInt8Kernel``, a ``ValueError``: the serving ladder then moves down a
  rung, while a kernel that fails stays loud.  ``quantize_apply`` lays
  out a rewrite's weights once, when it builds the entries of a model on
  the card (``rewrite_weights``).

Replay is positional, so a model whose conv sequence changed since
calibration fails loudly: over-consumed, a shape mismatch, under-consumed
(three ``ValueError``s, as in the JAX package).  ``bias_correct=True`` runs
one more pass on a subsample of the calibration batch that records, per
conv, the mean per-output-channel error of the int8 conv against the float
conv on the quantized cascade's own inputs, and replays it as an additive
constant.

``make_indexed_skip`` / ``ESRGAN_TRUNK_CALLS`` are esrgan's second rung: the
convs whose input is the residual trunk stay float.

``fake_quant`` is the quantization-aware mode (``_FakeQuant:81``,
``_ste_round:105``, ``fake_quant:112``, its branch of ``conv_hook``
:194-230): every conv the skip policy takes runs the serving arithmetic in
float32 with straight-through rounding — a per-input-channel scale of the
batch's own ``max|x|`` (no gradient) folded into the weight (a grouped conv
takes the largest, a scalar), a per-output-channel weight scale (no
gradient), ``x`` and the folded weight rounded and clipped to ±127, the
float conv of the two with autograd, one dequant multiply, cast back to
x's dtype — so gradients reach the weights through the quantizer.  It
fires wherever the layers of ``ops/conv.py`` run: a generator's
``route="autograd"``, where QAT runs it in eval mode with gradients on.
The clip is ``min(max(v, -127), 127)``, whose gradient halves where ``v``
sits on a bound, as ``jnp.clip``'s does.
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


class _FakeQuant:
    """The quantization-aware mode: convs the ``skip`` policy takes run the
    int8 arithmetic in float32 with straight-through rounding."""

    def __init__(self, skip: Callable):
        self.skip = skip


@contextlib.contextmanager
def fake_quant(skip: Optional[Callable] = None):
    """Context manager: the layers of ``ops/conv.py`` run inside simulate
    the int8 serving path with straight-through gradients.  ``skip``
    defaults to the serving policy; a stateful policy
    (``make_indexed_skip``) must be fresh for each forward."""
    mode = _FakeQuant(skip or default_skip_policy)
    with _mode(mode):
        yield mode


def _ste_round(v: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through (identity) gradient."""
    return v + (torch.round(v) - v).detach()


def _clip127(v: torch.Tensor) -> torch.Tensor:
    """Clip to ±127 as ``jnp.clip`` does: a value on a bound takes half
    the gradient."""
    return torch.minimum(torch.maximum(v, v.new_tensor(-127.0)),
                         v.new_tensor(127.0))


def _fake_quant_conv(x: torch.Tensor, weight: torch.Tensor, run: Callable,
                     transposed: bool) -> torch.Tensor:
    """The ``_FakeQuant`` branch of the JAX hook in PyTorch's layouts
    ((C_out, C_in, kH, kW), or (C_in, C_out, kH, kW) transposed); NCHW
    ``x``; the product before the bias, in x's dtype."""
    xf = x.float()
    s_c = act_scale(xf.detach().abs().amax(dim=(0, 2, 3)))
    out_axis, in_axis = (1, 0) if transposed else (0, 1)
    if int(weight.shape[in_axis]) != int(s_c.shape[0]):
        s_c = s_c.max().reshape(1)  # grouped conv: one scalar scale
    fold = [1] * weight.dim()
    fold[in_axis] = -1
    wf = weight.float() * s_c.view(fold)
    dims = tuple(i for i in range(wf.dim()) if i != out_axis)
    w_scale = torch.clamp_min(wf.detach().abs().amax(dim=dims, keepdim=True),
                              1e-12) / 127.0
    x_q = _ste_round(_clip127(xf / s_c.view(1, -1, 1, 1)))
    w_q = _ste_round(_clip127(wf / w_scale))
    y = run(x_q, w_q)
    return (y * w_scale.reshape(1, -1, 1, 1)).to(x.dtype)


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
                w_scale: torch.Tensor, stride, padding,
                rewrite: Optional[tuple] = None) -> torch.Tensor:
    """f32(conv_s32(x_i8, w_i8)) · w_scale, NCHW, PyTorch weight layout.
    ``rewrite``: the 4×4 stride-2 rewrite's weights from ``rewrite_weights``
    (None: laid out for this call)."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8

    c_in = int(x_i8.shape[1])
    geometry = (tuple(w_i8.shape[2:]), _pair(stride), _pair(padding))
    if geometry == ((3, 3), (1, 1), (1, 1)) and _k5_takes(c_in):
        y = conv3x3_s8.conv3x3_s8(x_i8.permute(0, 2, 3, 1).contiguous(),
                                  w_i8.permute(0, 2, 3, 1).contiguous(),
                                  w_scale)
        return y.permute(0, 3, 1, 2)
    if x_i8.device.type != "cpu" and geometry == S2_4X4 and \
            _k5_takes(4 * c_in):
        return s2d_conv4x4_s8(
            x_i8, *(rewrite or rewrite_weights(w_i8, w_scale, False)))
    _no_kernel(x_i8, "conv", w_i8.shape, stride, padding)
    acc = F.conv2d(x_i8.double(), w_i8.double(), stride=stride,
                   padding=padding).to(torch.int32)
    return acc.float() * w_scale.view(1, -1, 1, 1)


def int8_conv_transpose2d(x_i8: torch.Tensor, w_i8: torch.Tensor,
                          w_scale: torch.Tensor, stride, padding=0,
                          rewrite: Optional[tuple] = None) -> torch.Tensor:
    """The transpose conv's counterpart of ``int8_conv2d`` (PyTorch's
    ``(C_in, C_out, kH, kW)`` weight, no output padding)."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import convt2x2_s8

    c_in, c_out = int(w_i8.shape[0]), int(w_i8.shape[1])
    geometry = (tuple(w_i8.shape[2:]), _pair(stride), _pair(padding))
    if geometry == ((2, 2), (2, 2), (0, 0)) and convt2x2_s8.fits(c_in, c_out):
        y = convt2x2_s8.convt2x2_s8(x_i8.permute(0, 2, 3, 1).contiguous(),
                                    w_i8.permute(2, 3, 1, 0).contiguous(),
                                    w_scale)
        return y.permute(0, 3, 1, 2)
    if x_i8.device.type != "cpu" and geometry == S2_4X4 and _k5_takes(c_in):
        return d2s_convt4x4_s8(
            x_i8, *(rewrite or rewrite_weights(w_i8, w_scale, True)))
    _no_kernel(x_i8, "transpose conv", w_i8.shape, stride, padding)
    acc = F.conv_transpose2d(x_i8.double(), w_i8.double(), stride=stride,
                             padding=padding).to(torch.int32)
    return acc.float() * w_scale.view(1, -1, 1, 1)


# ---------------------------------------------------------------------------
# the 4×4 stride-2 padding-1 convs on K5: exact rewrites
#
# Per axis, output i of the conv reads padded-input rows 2i + a, a = 0..3,
# which are x rows 2(i + t - 1) + p for K5's tap t = 0..2 and the phase
# p = 0, 1 of a space-to-depth of x: a = 2t + p - 1.  Output 2m + q of the
# transpose conv reads x rows m + t - 1 with kernel row a = q + 3 - 2t.  The
# (t, p) or (t, q) pairs whose a falls outside 0..3 get zero weights: 16 of
# the 36 (tap, phase) products per output are real, so K5 issues 2.25× the
# useful multiply-adds.
S2_4X4 = ((4, 4), (2, 2), (1, 1))  # (kernel, stride, padding)


def _k5_takes(c_in: int) -> bool:
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8

    return c_in % conv3x3_s8.CHUNK == 0 and c_in <= conv3x3_s8.MAX_CIN


def s2d_conv4x4_weight(w_i8: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 4, 4) → K5's (C_out, 3, 3, 4·C_in): input channel
    (2·py + px)·C_in + c of tap (ty, tx) is ``w[:, c, 2ty+py-1,
    2tx+px-1]``, zero where that is outside the kernel."""
    c_out, c_in = int(w_i8.shape[0]), int(w_i8.shape[1])
    w3 = w_i8.new_zeros((c_out, 3, 3, 2, 2, c_in))
    for ty in range(3):
        for tx in range(3):
            for py in range(2):
                for px in range(2):
                    ay, ax = 2 * ty + py - 1, 2 * tx + px - 1
                    if 0 <= ay < 4 and 0 <= ax < 4:
                        w3[:, ty, tx, py, px] = w_i8[:, :, ay, ax]
    return w3.reshape(c_out, 3, 3, 4 * c_in)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → contiguous NHWC (N, ⌈H/2⌉, ⌈W/2⌉, 4·C), channel
    (2·py + px)·C + c holding pixel (2i + py, 2j + px); an odd extent gets
    the zero row or column that the 4×4 conv's padding puts there."""
    n, c, h, w = x.shape
    x = x.permute(0, 2, 3, 1)
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    return x.reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, h2, w2, 4 * c).contiguous()


def s2d_conv4x4_s8(x_i8: torch.Tensor, w3: torch.Tensor,
                   w_scale: torch.Tensor) -> torch.Tensor:
    """The 4×4 stride-2 padding-1 conv of s8 ``x_i8`` (N, C, H, W) as K5's
    3×3 conv of its ``space_to_depth``, weights from
    ``s2d_conv4x4_weight``; the f32 product (N, C_out, ⌊H/2⌋, ⌊W/2⌋), an
    NCHW view of NHWC memory."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8

    h, w = x_i8.shape[2:]
    y = conv3x3_s8.conv3x3_s8(space_to_depth(x_i8), w3, w_scale)
    return y[:, :h // 2, :w // 2].permute(0, 3, 1, 2)


def d2s_convt4x4_weight(w_i8: torch.Tensor) -> torch.Tensor:
    """(C_in, C_out, 4, 4) → K5's (4·C_out, 3, 3, C_in): output channel
    (2·qy + qx)·C_out + o of tap (ty, tx) is ``w[:, o, qy+3-2ty,
    qx+3-2tx]``, zero where that is outside the kernel."""
    c_in, c_out = int(w_i8.shape[0]), int(w_i8.shape[1])
    w3 = w_i8.new_zeros((2, 2, c_out, 3, 3, c_in))
    for qy in range(2):
        for qx in range(2):
            for ty in range(3):
                for tx in range(3):
                    ay, ax = qy + 3 - 2 * ty, qx + 3 - 2 * tx
                    if 0 <= ay < 4 and 0 <= ax < 4:
                        w3[qy, qx, :, ty, tx] = w_i8[:, :, ay, ax].T
    return w3.reshape(4 * c_out, 3, 3, c_in)


def rewrite_weights(w_i8: torch.Tensor, w_scale: torch.Tensor,
                    transposed: bool) -> Optional[tuple]:
    """A 4×4 weight's rewrite in K5's layout with its scales: (``s2d_conv4x4
    _weight``, ``w_scale``) for a conv, (``d2s_convt4x4_weight``, ``w_scale``
    repeated per phase) for a transpose conv; None for another kernel size.
    The replay takes it only at stride 2 padding 1."""
    if tuple(w_i8.shape[2:]) != (4, 4):
        return None
    if transposed:
        return d2s_convt4x4_weight(w_i8), w_scale.repeat(4)
    return s2d_conv4x4_weight(w_i8), w_scale


def d2s_convt4x4_s8(x_i8: torch.Tensor, w3: torch.Tensor,
                    w_scale4: torch.Tensor) -> torch.Tensor:
    """The 4×4 stride-2 padding-1 transpose conv of s8 ``x_i8`` (N, C, H,
    W) as K5's 3×3 conv with an output channel group per output phase
    (weights from ``d2s_convt4x4_weight``, ``w_scale4`` the scales repeated
    per phase), then depth-to-space: the f32 product (N, C_out, 2H, 2W), an
    NCHW view of NHWC memory."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8

    n, _, h, w = x_i8.shape
    c_out = int(w3.shape[0]) // 4
    y = conv3x3_s8.conv3x3_s8(x_i8.permute(0, 2, 3, 1).contiguous(), w3,
                              w_scale4)
    y = y.view(n, h, w, 2, 2, c_out).permute(0, 1, 3, 2, 4, 5).reshape(
        n, 2 * h, 2 * w, c_out)
    return y.permute(0, 3, 1, 2)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class NoInt8Kernel(ValueError):
    """No int8 kernel takes this conv's geometry on this device.  A
    ``ValueError``, as a builder's other refusals are, so that the serving
    ladder moves down a rung; a kernel that fails raises ``RuntimeError``."""


def _no_kernel(x, what, shape, stride, padding=0):
    if x.device.type != "cpu":
        raise NoInt8Kernel(
            f"no int8 kernel for a {what} of weight {tuple(shape)} at stride "
            f"{stride} padding {padding} on {x.device} (the kernels take 3x3 "
            "stride-1 padding-1 convs of at most 256 input channels, 4x4 "
            "stride-2 padding-1 convs of at most 64, 4x4 stride-2 padding-1 "
            "transpose convs of at most 256 and 2x2 stride-2 transpose convs "
            "without padding, channels a multiple of 32 (8 for the 4x4 "
            "convs); see ops/cuda/convt2x2_s8.py::fits)")


def conv_hook(x: torch.Tensor, weight: torch.Tensor, run_int8: Callable,
              run_float: Callable, transposed: bool = False
              ) -> Optional[torch.Tensor]:
    """Called by ``ops/conv.py`` before its float conv.  Under a replay:
    ``run_int8(x_i8, w_i8, w_scale, rewrite)`` gives the f32 dequantized
    product (``rewrite``: the entry's ``rewrite_weights``, or None) and
    ``run_float(x_f32, w_f32)`` the float conv (bias excluded, with
    autograd); returns the int8 path's output in x's dtype before the bias,
    or None for the float path.  Under ``fake_quant`` the conv (a transpose
    conv when ``transposed``) is simulated through ``run_float``."""
    mode = _MODE.get()
    if mode is None:
        return None
    if isinstance(mode, _FakeQuant):
        if mode.skip(weight):
            return None  # the float path, as the serving skip
        return _fake_quant_conv(x, weight, run_float, transposed)
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
    rewrite = entry[4] if len(entry) > 4 else None
    if tuple(w_i8.shape) != tuple(weight.shape):
        raise ValueError(
            f"int8 replay mismatch at conv call #{mode.i - 1}: calibrated "
            f"kernel shape {tuple(w_i8.shape)} != traced kernel shape "
            f"{tuple(weight.shape)} — re-calibrate with quantize_apply()")
    xf = x.float()
    y = run_int8(quantize_activation(xf, s_c), w_i8, w_scale,
                 rewrite).to(x.dtype)
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
    serving domain, on the model's device); see the module docstring.  An
    entry is (w_i8, w_scale, s_c, bias correction or None, the weights'
    ``rewrite_weights`` on a card or None)."""
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
        corrections = ctx.corrections
    else:
        corrections = [None] * len(entries)
    entries = [None if e is None else
               (*e, c, None if e[0].device.type == "cpu" else
                rewrite_weights(e[0], e[1], tap[2]))
               for e, c, tap in zip(entries, corrections, taps)]
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


def make_indexed_skip(float_call_indices,
                      base: Callable = default_skip_policy) -> Callable:
    """A skip policy by call index (``make_indexed_skip:416``): ``base``, or
    the conv's index in the call order is in ``float_call_indices``.  It
    counts the calls it sees, so build a fresh one per ``quantize_apply``."""
    float_set = set(int(i) for i in float_call_indices)
    count = [-1]

    def skip(weight: torch.Tensor) -> bool:
        count[0] += 1
        return bool(base(weight)) or count[0] in float_set
    return skip


# ESRGANGenerator(num_residuals=8) conv calls whose input is the residual
# trunk: block b's first conv is call 1 + 2b; block 0's input is the head's
# output and stays int8 (``ESRGAN_TRUNK_CALLS:447``)
ESRGAN_TRUNK_CALLS = tuple(1 + 2 * b for b in range(1, 8))
