"""Fused U-Net double conv: relu(conv3x3(relu(conv3x3(x) + b1)) + b2).

Port of ``celebrity_image_denoiser_tpu/ops/pallas/double_conv.py::
double_conv3x3_relu`` (:108): both convs 'same', the intermediate kept on
chip in x's dtype and zero outside the image for conv2.  The CUDA kernel is
``csrc/double_conv3x3_relu.cu`` (see its header for the design); ``kpack``
and ``tile_h`` were MXU/TPU choices and have no counterpart here.

On a CUDA tensor ``double_conv3x3_relu`` launches the kernel or raises; on a
CPU tensor it runs ``double_conv3x3_relu_plain``.  ``LAUNCHES`` counts the
kernel's launches.  The kernel has no backward, as its Pallas original has
none: with autograd recording and an argument that requires a gradient the
entry point raises on either device (``conv3x3.refuse_grad``).

An optional second input ``x2`` makes the input ``torch.cat([x, x2], dim=3)``
(``conv3x3``'s docstring has the rules): the U-Net's ``upconv2`` pair reads
the upsampled tensor and the cropped skip tensor through two pointers, in
bf16 and in f32.

In float32 the kernel runs three TF32 products per multiply on the tensor
cores and takes both weights split and K-major (``conv3x3.tf32_weights``):
``w1_tf32`` and ``w2_tf32``, made once by a caller that keeps its weights,
else made here for the one call.
"""

from __future__ import annotations

from typing import Optional

import torch

from celebrity_image_denoiser_tpu_torch.ops.conv import conv2d
from celebrity_image_denoiser_tpu_torch.ops.cuda import _build
from celebrity_image_denoiser_tpu_torch.ops.cuda.conv3x3 import (
    check_second_input,
    check_tf32_weights,
    refuse_grad,
    tf32_weights,
    two_pointer_ok,
)

LAUNCHES = 0  # launches of csrc/double_conv3x3_relu.cu

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w1, b1, w2, b2, c0: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C0), got {tuple(x.shape)}")
    if w1.dim() != 4 or tuple(w1.shape[:3]) != (3, 3, c0):
        raise ValueError(f"w1 must be (3, 3, {c0}, C1), got {tuple(w1.shape)}")
    c1 = w1.shape[3]
    if w2.dim() != 4 or tuple(w2.shape[:3]) != (3, 3, c1):
        raise ValueError(f"w2 must be (3, 3, {c1}, C2), got {tuple(w2.shape)}")
    if tuple(b1.shape) != (c1,) or tuple(b2.shape) != (w2.shape[3],):
        raise ValueError(f"b1/b2 must be ({c1},)/({w2.shape[3]},), got "
                         f"{tuple(b1.shape)}/{tuple(b2.shape)}")
    if x.dtype not in _DTYPES or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"x, w1, w2 must share a dtype of {_DTYPES}, got "
                        f"{x.dtype}, {w1.dtype}, {w2.dtype}")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError(f"b1/b2 must be float32, got {b1.dtype}/{b2.dtype}")
    ts = (x, w1, b1, w2, b2)
    if len({t.device for t in ts}) != 1:
        raise ValueError("x, w1, b1, w2, b2 must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("x, w1, b1, w2, b2 must be contiguous (NHWC / HWIO)")


def double_conv3x3_relu_plain(x, w1, b1, w2, b2,
                              x2: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version: conv1 in f32 + b1, ReLU, cast to x's dtype (the
    intermediate's storage type; conv2d's zero padding is the 'zero
    outside the image' rule), then conv2 in f32 + b2, ReLU, cast."""
    if x2 is not None:
        x = torch.cat([x, x2], dim=3)

    def conv(t, w, b):
        return torch.relu(conv2d(t.float(), w.permute(3, 2, 0, 1).float(),
                                 b.float(), padding=1))

    h = conv(x.permute(0, 3, 1, 2), w1, b1).to(x.dtype)
    y = conv(h, w2, b2).to(x.dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def double_conv3x3_relu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor,
                        x2: Optional[torch.Tensor] = None, *,
                        w1_tf32: Optional[torch.Tensor] = None,
                        w2_tf32: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """x (N,H,W,C0) f32 or bf16; w1 (3,3,C0,C1), w2 (3,3,C1,C2) in x's
    dtype; b1, b2 f32.  Any C0 (3 included) and any H, W.  With ``x2``
    (N,H,W,Cb) the input is ``cat([x, x2], 3)`` and w1 (3,3,C0+Cb,C1).
    ``w1_tf32``, ``w2_tf32``: ``tf32_weights`` of w1 and w2 (read in f32 on
    the card; made here when absent)."""
    if x2 is not None:
        check_second_input(x, x2)
        if not two_pointer_ok(x, x2):
            x, x2 = torch.cat([x, x2], dim=3), None
    _check(x, w1, b1, w2, b2,
           x.shape[-1] + (0 if x2 is None else x2.shape[3]))
    refuse_grad("double_conv3x3_relu", x, w1, b1, w2, b2,
                *(() if x2 is None else (x2,)))
    if x.device.type == "cpu":
        return double_conv3x3_relu_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, w, ca = x.shape
    cb = 0 if x2 is None else x2.shape[3]
    c0 = ca + cb
    c1, c2 = w1.shape[3], w2.shape[3]
    y = torch.empty((n, h, w, c2), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or c0 == 0 or c1 == 0:
        raise ValueError(f"empty double conv: x {tuple(x.shape)}, C1={c1}, "
                         f"C2={c2}")
    tf32 = x.dtype == torch.float32
    if tf32:
        w1_tf32 = tf32_weights(w1) if w1_tf32 is None else w1_tf32
        w2_tf32 = tf32_weights(w2) if w2_tf32 is None else w2_tf32
        check_tf32_weights(w1_tf32, w1)
        check_tf32_weights(w2_tf32, w2)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = (0, 0, 0) if x2 is None else x2.stride()[:3]
    x2p = None if x2 is None else x2.data_ptr()
    with torch.cuda.device(x.device), _build.LAUNCH_LOCK:
        if tf32:
            rc = lib.cid_double_conv3x3_relu_tf32(
                x.data_ptr(), x2p, w1_tf32.data_ptr(), b1.data_ptr(),
                w2_tf32.data_ptr(), b2.data_ptr(), y.data_ptr(), n, h, w, ca,
                cb, c1, c2, *strides, stream)
        else:
            rc = lib.cid_double_conv3x3_relu(
                x.data_ptr(), x2p, w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), b2.data_ptr(), y.data_ptr(), n, h, w, ca, cb,
                c1, c2, *strides, _build.dtype_code(x.dtype), stream)
        _build.check(rc, "double_conv3x3_relu")
        LAUNCHES += 1
    return y
