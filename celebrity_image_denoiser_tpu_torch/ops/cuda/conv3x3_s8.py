"""3×3 'same' int8 convolution with the s8 program's epilogue (NHWC, K5).

No Pallas original: the JAX package runs these convs in XLA
(``ops/quant_unet.py::_conv_q:55`` and the generic transform's replay,
``ops/quant.py:247-251``), and PyTorch has no CUDA int8 convolution, so the
port carries them in ``csrc/conv3x3_s8.cu`` (see its header for the design).

On a CUDA tensor ``conv3x3_s8`` launches that kernel or raises; on a CPU
tensor it runs ``conv3x3_s8_plain``.  ``LAUNCHES`` counts the kernel's
launches.  The plain version is exact in integers: it convolves in float64
(every sum of products of s8 stays far below 2^53) and converts to int32, as
an f32 sum would not be (a 3×3×256 conv reaches 9·256·127² > 2^24).  The
epilogue rounds where ``_conv_q`` rounds:

* ``bias`` given: ``h = bf16(f32(acc)·w_scale)``, ``h = h + bias`` in bf16,
  ReLU if asked; out bf16, or with ``out_scale`` s8 =
  ``clamp(round(h / out_scale), ±127)`` (``_q:49``, round half to even);
* ``bias=None``: the raw f32 product ``f32(acc)·w_scale`` (the generic
  transform adds its correction and the layer's bias itself).

``x2`` (optional) stands for ``cat([x, x2], 3)`` and may be a strided view
with contiguous channels (the U-Net's cropped skip): the kernel reads both
in place.  Every channel count must be a multiple of 32, and the input's
at most 256: the kernel keeps a 64-channel output block's weights in
shared memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # launches of csrc/conv3x3_s8.cu

CHUNK = 32  # the kernel walks input channels 32 at a time
MAX_CIN = 256  # its weight slice (9 x Cin x 64 bytes) stays in shared memory
MODE_S8, MODE_BF16, MODE_F32 = 0, 1, 2


def quantize_s8(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``quant_unet._q``: true division by the per-channel scale, round half
    to even, clip to ±127, s8."""
    return torch.clamp(torch.round(h.float() / scale), -127, 127).to(
        torch.int8)


def epilogue(acc: torch.Tensor, w_scale: torch.Tensor,
             bias: Optional[torch.Tensor], relu: bool,
             out_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``_conv_q``'s epilogue on an int32 accumulator (channels last):
    ``bf16(f32(acc)·w_scale) + bias`` in bf16, ReLU, then ``quantize_s8``
    with ``out_scale``; with ``bias=None`` the f32 product alone."""
    y = acc.float() * w_scale
    if bias is None:
        return y
    h = y.to(torch.bfloat16) + bias
    h = torch.relu(h) if relu else h
    return h if out_scale is None else quantize_s8(h, out_scale)


def conv3x3_s32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact s8 conv: x (N,H,W,Cin) s8, w (Cout,3,3,Cin) s8 → (N,H,W,Cout)
    int32, on x's device: nine float64 matrix products, one per tap, whose
    integer sums are exact in any order (no FFT or Winograd algorithm that a
    library conv might pick)."""
    _, h, wd, _ = x.shape
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    wt = w.double()
    y = sum(xp[:, dy:dy + h, dx:dx + wd] @ wt[:, dy, dx].T
            for dy in range(3) for dx in range(3))
    return y.to(torch.int32)


def conv3x3_s8_plain(x, w, w_scale, bias=None, *, relu: bool = False,
                     out_scale=None, x2=None) -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3_s8``."""
    if x2 is not None:
        x = torch.cat([x, x2], dim=3)
    return epilogue(conv3x3_s32(x, w), w_scale, bias, relu, out_scale)


def _vec(t: torch.Tensor, n: int, dtype, what: str) -> None:
    if t.dim() != 1 or t.shape[0] != n or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous ({n},) {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def check_epilogue_args(cout, w_scale, bias, relu, out_scale) -> int:
    """The kernel mode of these epilogue arguments; raises on what the
    kernels do not take."""
    _vec(w_scale, cout, torch.float32, "w_scale")
    if bias is None:
        if relu or out_scale is not None:
            raise ValueError("the raw f32 product (bias=None) takes neither "
                             "relu nor out_scale")
        return MODE_F32
    _vec(bias, cout, torch.bfloat16, "bias")
    if out_scale is None:
        return MODE_BF16
    _vec(out_scale, cout, torch.float32, "out_scale")
    return MODE_S8


def _check_s8_image(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.int8 or t.dim() != 4:
        raise TypeError(f"{what} must be an s8 (N,H,W,C) tensor, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.shape[3] % CHUNK or t.stride(3) != 1:
        raise ValueError(f"{what} must have contiguous channels, a multiple "
                         f"of {CHUNK}, got {tuple(t.shape)} strides "
                         f"{t.stride()}")


def conv3x3_s8(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *, relu: bool = False,
               out_scale: Optional[torch.Tensor] = None,
               x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N,H,W,Ca) s8 contiguous, x2 (N,H,W,Cb) s8 or None, w (Cout,3,3,
    Ca+Cb) s8, w_scale (Cout,) f32, bias (Cout,) bf16 or None, out_scale
    (Cout,) f32 or None → (N,H,W,Cout) s8, bf16 or f32 (see the module
    docstring)."""
    _check_s8_image(x, "x")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    cin = x.shape[3]
    if x2 is not None:
        _check_s8_image(x2, "x2")
        if x2.shape[:3] != x.shape[:3] or x2.device != x.device:
            raise ValueError(f"x2 {tuple(x2.shape)} must match x "
                             f"{tuple(x.shape)} but for channels")
        cin += x2.shape[3]
    if cin > MAX_CIN:
        raise ValueError(f"the kernel takes at most {MAX_CIN} input "
                         f"channels, got {cin}")
    if w.dtype != torch.int8 or w.dim() != 4 or tuple(w.shape[1:]) != (
            3, 3, cin) or not w.is_contiguous():
        raise ValueError(f"w must be contiguous s8 (Cout, 3, 3, {cin}), got "
                         f"{w.dtype} {tuple(w.shape)}")
    cout = w.shape[0]
    mode = check_epilogue_args(cout, w_scale, bias, relu, out_scale)
    tensors = [t for t in (x, x2, w, w_scale, bias, out_scale) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all arguments must be on one device")
    if x.device.type == "cpu":
        return conv3x3_s8_plain(x, w, w_scale, bias, relu=relu,
                                out_scale=out_scale, x2=x2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, wd, ca = x.shape
    dtype = {MODE_S8: torch.int8, MODE_BF16: torch.bfloat16,
             MODE_F32: torch.float32}[mode]
    y = torch.empty((n, h, wd, cout), dtype=dtype, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device), _build.LAUNCH_LOCK:
        rc = lib.cid_conv3x3_s8(
            x.data_ptr(), None if x2 is None else x2.data_ptr(), w.data_ptr(),
            w_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            None if out_scale is None else out_scale.data_ptr(), y.data_ptr(),
            n, h, wd, ca, 0 if x2 is None else x2.shape[3], cout, int(relu),
            mode, *((0, 0, 0) if x2 is None else x2.stride()[:3]), stream)
        _build.check(rc, "conv3x3_s8")
        LAUNCHES += 1
    return y
