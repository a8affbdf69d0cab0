"""Fused U-Net double conv: relu(conv3x3(relu(conv3x3(x) + b1)) + b2).

Port of ``celebrity_image_denoiser_tpu/ops/pallas/double_conv.py::
double_conv3x3_relu`` (:108): both convs 'same', the intermediate kept on
chip in x's dtype and zero outside the image for conv2.  The CUDA kernel is
``csrc/double_conv3x3_relu.cu`` (see its header for the design); ``kpack``
and ``tile_h`` were MXU/TPU choices and have no counterpart here.

On a CUDA tensor ``double_conv3x3_relu`` launches the kernel or raises; on a
CPU tensor it runs ``double_conv3x3_relu_plain``.  ``LAUNCHES`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from celebrity_image_denoiser_tpu_torch.ops.conv import conv2d
from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # launches of csrc/double_conv3x3_relu.cu

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w1, b1, w2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C0), got {tuple(x.shape)}")
    c0 = x.shape[3]
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


def double_conv3x3_relu_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: conv1 in f32 + b1, ReLU, cast to x's dtype (the
    intermediate's storage type; conv2d's zero padding is the 'zero
    outside the image' rule), then conv2 in f32 + b2, ReLU, cast."""
    def conv(t, w, b):
        return torch.relu(conv2d(t.float(), w.permute(3, 2, 0, 1).float(),
                                 b.float(), padding=1))

    h = conv(x.permute(0, 3, 1, 2), w1, b1).to(x.dtype)
    y = conv(h, w2, b2).to(x.dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def double_conv3x3_relu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """x (N,H,W,C0) f32 or bf16; w1 (3,3,C0,C1), w2 (3,3,C1,C2) in x's
    dtype; b1, b2 f32.  Any C0 (3 included) and any H, W."""
    _check(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return double_conv3x3_relu_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, w, c0 = x.shape
    c1, c2 = w1.shape[3], w2.shape[3]
    y = torch.empty((n, h, w, c2), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or c0 == 0 or c1 == 0:
        raise ValueError(f"empty double conv: x {tuple(x.shape)}, C1={c1}, "
                         f"C2={c2}")
    lib = _build.library()
    code = _build.dtype_code(x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.cid_double_conv3x3_relu(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), n, h, w, c0, c1, c2, code, stream)
    _build.check(rc, "double_conv3x3_relu")
    LAUNCHES += 1
    return y
