"""K8: depthwise 3×3 'same' convolution over NHWC float32, with an optional
gated-GELU epilogue (Restormer's ``qkv_dwconv`` and GDFN's ``dwconv`` +
gate; ``csrc/dwconv3x3.cu`` has the design).

``dwconv3x3(x, w)``: x (N, H, W, C) f32, w (3, 3, C) f32 (``tap_weights``
of the published (C, 1, 3, 3) weight) → (N, H, W, C).  ``gate=True``: C
even, the output (N, H, W, C/2) is ``gelu(y[..., :C/2]) * y[..., C/2:]``
of the conv's output y, GELU in its exact erf form.  No bias.  Without
the gate, with C a multiple of 4 and 16-byte aligned tensors, the kernel
runs its float4 body (four channels a thread), which gives the scalar
body's bits.

On a CUDA tensor the entry point launches the kernel or raises; on a CPU
tensor it runs ``dwconv3x3_plain``.  ``LAUNCHES`` counts the launches.  The
kernel has no backward: with autograd recording and an argument that
requires a gradient the entry point raises (``conv3x3.refuse_grad``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build
from celebrity_image_denoiser_tpu_torch.ops.cuda.conv3x3 import refuse_grad

LAUNCHES = 0  # launches of csrc/dwconv3x3.cu


def tap_weights(weight: torch.Tensor) -> torch.Tensor:
    """The published depthwise weight (C, 1, 3, 3) → the kernel's (3, 3, C),
    contiguous."""
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (1, 3, 3):
        raise ValueError(f"weight must be (C, 1, 3, 3), got "
                         f"{tuple(weight.shape)}")
    return weight[:, 0].permute(1, 2, 0).contiguous()


def dwconv3x3_plain(x: torch.Tensor, w: torch.Tensor, *,
                    gate: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the grouped conv, then the gate (F.gelu, exact
    form).  NHWC in, NHWC out."""
    c = x.shape[3]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1),
                 padding=1, groups=c).permute(0, 2, 3, 1)
    if gate:
        y = F.gelu(y[..., :c // 2]) * y[..., c // 2:]
    return y.contiguous()


def _check(x: torch.Tensor, w: torch.Tensor, gate: bool) -> None:
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous f32 (N, H, W, C), got "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[3]
    if tuple(w.shape) != (3, 3, c) or w.dtype != torch.float32 \
            or not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"w must be contiguous f32 (3, 3, {c}) on "
                         f"{x.device}, got {tuple(w.shape)} {w.dtype} on "
                         f"{w.device}")
    if gate and c % 2:
        raise ValueError(f"the gate needs an even channel count, got {c}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def dwconv3x3(x: torch.Tensor, w: torch.Tensor, *,
              gate: bool = False) -> torch.Tensor:
    """K8: x (N, H, W, C) f32, w (3, 3, C) f32 → (N, H, W, C), or with
    ``gate`` (N, H, W, C/2) = gelu(first half) · second half."""
    _check(x, w, gate)
    refuse_grad("dwconv3x3", x, w)
    if x.device.type == "cpu":
        return dwconv3x3_plain(x, w, gate=gate)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, wd, c = x.shape
    y = torch.empty((n, h, wd, c // 2 if gate else c), dtype=x.dtype,
                    device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device), _build.LAUNCH_LOCK:
        rc = lib.cid_dwconv3x3(x.data_ptr(), w.data_ptr(), y.data_ptr(), n,
                               h, wd, c, int(gate), stream)
        _build.check(rc, "dwconv3x3")
        LAUNCHES += 1
    return y
