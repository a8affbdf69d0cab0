"""3×3 'same' convolution with fused bias and optional ReLU (NHWC / HWIO).

Port of ``celebrity_image_denoiser_tpu/ops/pallas/conv_fused.py``: its two
entry points ``conv3x3_bias_relu`` (:143, halo-window DMA) and
``conv3x3_bias_relu_v2`` (:85, shifted inputs) compute the same function and
differ only in TPU data movement, so both run one CUDA kernel,
``csrc/conv3x3_bias_relu.cu`` (see its header for the design).

On a CUDA tensor the entry points launch that kernel or raise; on a CPU
tensor they run ``conv3x3_bias_relu_plain``, the plain PyTorch version of the
same function.  ``LAUNCHES`` counts the kernel's launches (both entry
points), so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import torch

from celebrity_image_denoiser_tpu_torch.ops.conv import conv2d
from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # launches of csrc/conv3x3_bias_relu.cu, from either entry point

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"kernel must be (3, 3, {cin}, Cout), got "
                         f"{tuple(kernel.shape)}")
    if tuple(bias.shape) != (kernel.shape[3],):
        raise ValueError(f"bias must be ({kernel.shape[3]},), got "
                         f"{tuple(bias.shape)}")
    if x.dtype not in _DTYPES or kernel.dtype != x.dtype:
        raise TypeError(f"x and kernel must share a dtype of {_DTYPES}, got "
                        f"{x.dtype} and {kernel.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if not (x.device == kernel.device == bias.device):
        raise ValueError("x, kernel and bias must be on one device")
    if not (x.is_contiguous() and kernel.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("x, kernel and bias must be contiguous (NHWC / HWIO)")


def conv3x3_bias_relu_plain(x: torch.Tensor, kernel: torch.Tensor,
                            bias: torch.Tensor, *, relu: bool = True
                            ) -> torch.Tensor:
    """Plain PyTorch version: f32 conv (products of x's dtype, f32 sums),
    + bias, ReLU if asked, cast to x's dtype.  NHWC in, NHWC out."""
    y = conv2d(x.permute(0, 3, 1, 2).float(),
               kernel.permute(3, 2, 0, 1).float(), bias.float(), padding=1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def _run(x, kernel, bias, relu: bool) -> torch.Tensor:
    _check(x, kernel, bias)
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, kernel, bias, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, w, cin = x.shape
    cout = kernel.shape[3]
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or cin == 0:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, kernel "
                         f"{tuple(kernel.shape)}")
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.cid_conv3x3_bias_relu(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
            n, h, w, cin, cout, int(relu), _build.dtype_code(x.dtype), stream)
    _build.check(rc, "conv3x3_bias_relu")
    LAUNCHES += 1
    return y


def conv3x3_bias_relu(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, *, relu: bool = True
                      ) -> torch.Tensor:
    """Port of ``conv_fused.conv3x3_bias_relu`` (K2).  x (N,H,W,Cin) f32 or
    bf16; kernel (3,3,Cin,Cout) in x's dtype; bias (Cout,) f32.  Any H, W."""
    return _run(x, kernel, bias, relu)


def conv3x3_bias_relu_v2(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, *, relu: bool = True
                         ) -> torch.Tensor:
    """Port of ``conv_fused.conv3x3_bias_relu_v2`` (K1): the same function
    and the same CUDA kernel as ``conv3x3_bias_relu``."""
    return _run(x, kernel, bias, relu)
