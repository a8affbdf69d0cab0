"""2×2 stride-2 int8 transpose convolution with the s8 program's epilogue
(NHWC, K6).

No Pallas original: the JAX package runs it in XLA (``ops/quant_unet.py::
_convt_q:62``, and the generic transform's replay of ``ops/conv.py::
conv2d_transpose``).  For a 2×2 kernel at stride 2 the fractionally-strided
conv with the flipped, axis-swapped kernel is one product per output pixel:
``y[n, 2i+a, 2j+b, co] = Σ_ci x[n, i, j, ci] · W[a, b, co, ci]`` with ``W``
the layer's (kH, kW, Cout, Cin) kernel as the JAX package holds it — a GEMM
``[N·H·W, Cin] × [Cin, 4·Cout]``, ``csrc/convt2x2_s8.cu``.

On a CUDA tensor ``convt2x2_s8`` launches that kernel or raises; on a CPU
tensor it runs ``convt2x2_s8_plain`` (exact: float64 products and sums,
converted to int32).  The epilogue is ``conv3x3_s8``'s (bf16 or s8 out with
a bias, the raw f32 product without); there is no ReLU.  ``LAUNCHES``
counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build
from celebrity_image_denoiser_tpu_torch.ops.cuda.conv3x3_s8 import (
    CHUNK,
    MODE_BF16,
    MODE_F32,
    MODE_S8,
    check_epilogue_args,
    epilogue,
)

LAUNCHES = 0  # launches of csrc/convt2x2_s8.cu
MAX_CIN = 256  # the kernel stages all of K at once


def fits(cin: int, cout: int) -> bool:
    """Whether the kernel takes these channels: Cin a multiple of 32 up to
    256 and Cout even."""
    return cin % CHUNK == 0 and 0 < cin <= MAX_CIN and cout % 2 == 0


def convt2x2_s32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact: x (N,H,W,Cin) s8, w (2,2,Cout,Cin) s8 → (N,2H,2W,Cout) int32."""
    n, h, wd, _ = x.shape
    cout = w.shape[2]
    y = torch.einsum("nhwc,abdc->nhawbd", x.double(), w.double())
    return y.reshape(n, 2 * h, 2 * wd, cout).to(torch.int32)


def convt2x2_s8_plain(x, w, w_scale, bias=None, *, out_scale=None
                      ) -> torch.Tensor:
    """Plain PyTorch version of ``convt2x2_s8``."""
    return epilogue(convt2x2_s32(x, w), w_scale, bias, False, out_scale)


def convt2x2_s8(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (N,H,W,Cin) s8 contiguous, Cin a multiple of 32 up to 256; w
    (2,2,Cout,Cin) s8, Cout even; w_scale (Cout,) f32; bias (Cout,) bf16 or
    None; out_scale (Cout,) f32 or None → (N,2H,2W,Cout) s8, bf16 or f32."""
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous s8 (N,H,W,Cin), got "
                         f"{x.dtype} {tuple(x.shape)}")
    cin = x.shape[3]
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[:2] != (2, 2) \
            or w.shape[3] != cin or not w.is_contiguous():
        raise ValueError(f"w must be contiguous s8 (2, 2, Cout, {cin}), got "
                         f"{w.dtype} {tuple(w.shape)}")
    cout = w.shape[2]
    if not fits(cin, cout):
        raise ValueError(f"the kernel takes Cin a multiple of {CHUNK} up to "
                         f"{MAX_CIN} and Cout even, got Cin {cin}, Cout "
                         f"{cout}")
    mode = check_epilogue_args(cout, w_scale, bias, False, out_scale)
    tensors = [t for t in (x, w, w_scale, bias, out_scale) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("all arguments must be on one device")
    if x.device.type == "cpu":
        return convt2x2_s8_plain(x, w, w_scale, bias, out_scale=out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, wd, _ = x.shape
    dtype = {MODE_S8: torch.int8, MODE_BF16: torch.bfloat16,
             MODE_F32: torch.float32}[mode]
    y = torch.empty((n, 2 * h, 2 * wd, cout), dtype=dtype, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device), _build.LAUNCH_LOCK:
        rc = lib.cid_convt2x2_s8(
            x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if out_scale is None else out_scale.data_ptr(), y.data_ptr(),
            n, h, wd, cin, cout, mode, stream)
        _build.check(rc, "convt2x2_s8")
        LAUNCHES += 1
    return y
