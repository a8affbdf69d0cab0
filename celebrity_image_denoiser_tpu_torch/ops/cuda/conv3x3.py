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

The kernel has no backward, as its Pallas originals have none (the JAX
trainer differentiates through XLA's convs, never through a Pallas call).
So with autograd recording and an argument that requires a gradient the
entry points raise — on either device — instead of returning a tensor cut
off from the graph; a trainer uses the model's ``route="autograd"``.

Every entry point takes an optional second input ``x2``: the conv then runs
on ``torch.cat([x, x2], dim=3)``.  ``x2`` may be a strided view with
contiguous channels (the U-Net's cropped skip tensor).  Where the kernel can
read the two channel ranges through two pointers (its wgmma paths: bf16 with
``x``'s channels a multiple of 32, f32 with them a multiple of 8) the
concatenation is never written to device memory; everywhere else the
wrapper concatenates first.

In float32 with Cout > 4 the kernel runs three TF32 products per multiply
on the tensor cores (``csrc/conv3x3_bias_relu.cu``'s header), and takes its
weights split and K-major: ``tf32_weights(kernel)``.  A caller that keeps
its weights (the models' caches) makes that copy once and passes it as
``kernel_tf32``; without it the wrapper makes it for the one call.

``conv3x3_bias_relu_q8`` is K2 with an s8 output, the first conv of the int8
U-Net (``ops/quant_unet.py:73,182-183``): bf16 in, and the JAX program's
order instead of the fused f32 bias — the conv rounded to bf16, the bias
added in bf16, ReLU, then ``clamp(round(h / scale), ±127)`` — so that the
64-channel bf16 activation is never written.  Same kernel, same
``LAUNCHES``.
"""

from __future__ import annotations

from typing import Optional

import torch

from celebrity_image_denoiser_tpu_torch.ops.conv import conv2d
from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # launches of csrc/conv3x3_bias_relu.cu, from either entry point

_DTYPES = (torch.float32, torch.bfloat16)


def check_second_input(x: torch.Tensor, x2: torch.Tensor) -> None:
    """``x2`` must match ``x`` in all but channels and strides."""
    if x.dim() != 4 or x2.dim() != 4 or x2.shape[:3] != x.shape[:3]:
        raise ValueError(f"x2 must be (N, H, W, C2) like x {tuple(x.shape)}, "
                         f"got {tuple(x2.shape)}")
    if x2.dtype != x.dtype or x2.device != x.device:
        raise TypeError("x and x2 must share dtype and device, got "
                        f"{x.dtype}/{x.device} and {x2.dtype}/{x2.device}")
    if x2.shape[3] < 1 or x2.stride(3) != 1:
        raise ValueError("x2 must have contiguous channels (stride "
                         f"{x2.stride()})")


def two_pointer_ok(x: torch.Tensor, x2: torch.Tensor) -> bool:
    """Whether the tensor-core kernels read ``x`` and ``x2`` in place (see
    the module docstring); the alternative is to concatenate first."""
    chunk = {torch.bfloat16: 32, torch.float32: 8}.get(x.dtype)
    return (x.device.type == "cuda" and chunk is not None
            and x.shape[3] % chunk == 0)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to TF32 (nearest, ties away from zero: PTX's
    ``cvt.rna.tf32.f32``), in f32 with the low 13 bits zero.  NaN and
    infinity pass unchanged."""
    bits = t.contiguous().view(torch.int32)
    r = torch.bitwise_and(bits + 0x1000, -0x2000)
    special = torch.bitwise_and(bits, 0x7FFFFFFF) >= 0x7F800000
    return torch.where(special, bits, r).view(torch.float32)


def tf32_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO f32 (3, 3, Cin, Cout) → the f32 tensor-core kernels' weights:
    (ceil(Cout / 64), ceil(Cin / 8), 9, 2, 64, 8) f32, [pass, chunk, tap,
    hi/lo, n, k] = hi or lo of w[tap, 8 chunk + k, 64 pass + n] with hi =
    tf32(w) and lo = tf32(w - hi), zero beyond Cin and Cout: each output
    channel's 8 input channels contiguous (the K-major B tile wgmma takes
    for 32-bit types), one tap's hi and lo tiles of a chunk 4096 bytes in a
    row, as the kernels stage them."""
    if kernel.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3) \
            or kernel.dtype != torch.float32:
        raise ValueError(f"kernel must be f32 (3, 3, Cin, Cout), got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    cin, cout = kernel.shape[2], kernel.shape[3]
    p, c8 = -(-cout // 64), -(-cin // 8)
    with torch.no_grad():
        w = kernel.new_zeros((9, 8 * c8, 64 * p))
        w[:, :cin, :cout] = kernel.reshape(9, cin, cout)
        hi = round_tf32(w)
        lo = round_tf32(w - hi)
        split = torch.stack([hi, lo])                 # (2, 9, Cin8, Cout64)
        split = split.view(2, 9, c8, 8, p, 64)
        return split.permute(4, 2, 1, 0, 5, 3).contiguous()


def check_tf32_weights(wk: torch.Tensor, kernel: torch.Tensor) -> None:
    """``wk`` must be ``tf32_weights``' layout for ``kernel``'s shape, on its
    device."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    want = (-(-cout // 64), -(-cin // 8), 9, 2, 64, 8)
    if tuple(wk.shape) != want or wk.dtype != torch.float32 \
            or wk.device != kernel.device or not wk.is_contiguous():
        raise ValueError(f"split weights must be contiguous f32 {want} on "
                         f"{kernel.device} (tf32_weights), got "
                         f"{tuple(wk.shape)} {wk.dtype} on {wk.device}")


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           cin: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
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
                            bias: torch.Tensor, *, relu: bool = True,
                            x2: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version: f32 conv (products of x's dtype, f32 sums),
    + bias, ReLU if asked, cast to x's dtype.  NHWC in, NHWC out."""
    if x2 is not None:
        x = torch.cat([x, x2], dim=3)
    y = conv2d(x.permute(0, 3, 1, 2).float(),
               kernel.permute(3, 2, 0, 1).float(), bias.float(), padding=1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through ``name``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (the Pallas kernels have none "
            "either), and an argument requires a gradient; call it "
            "under torch.no_grad() / torch.inference_mode(), or train "
            "through the model's route='autograd'")


def _run(x, kernel, bias, relu: bool, x2, kernel_tf32) -> torch.Tensor:
    if x2 is not None:
        check_second_input(x, x2)
        # the narrow-output kernels (bf16 Cout <= 8, f32 Cout <= 4) take one
        # input
        narrow = kernel.shape[-1] <= (8 if x.dtype == torch.bfloat16 else 4)
        if not two_pointer_ok(x, x2) or narrow:
            x, x2 = torch.cat([x, x2], dim=3), None
    _check(x, kernel, bias, x.shape[-1] + (0 if x2 is None else x2.shape[3]))
    refuse_grad("conv3x3_bias_relu", x, kernel, bias,
                *(() if x2 is None else (x2,)))
    if x.device.type == "cpu":
        return conv3x3_bias_relu_plain(x, kernel, bias, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, w, ca = x.shape
    cb = 0 if x2 is None else x2.shape[3]
    cin = ca + cb
    cout = kernel.shape[3]
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0 or cin == 0:
        raise ValueError(f"empty conv: x {tuple(x.shape)}, kernel "
                         f"{tuple(kernel.shape)}")
    tf32 = x.dtype == torch.float32 and cout > 4
    if tf32:
        if kernel_tf32 is None:
            kernel_tf32 = tf32_weights(kernel)
        check_tf32_weights(kernel_tf32, kernel)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    strides = (0, 0, 0) if x2 is None else x2.stride()[:3]
    with torch.cuda.device(x.device), _build.LAUNCH_LOCK:
        if tf32:
            rc = lib.cid_conv3x3_bias_relu_tf32(
                x.data_ptr(), None if x2 is None else x2.data_ptr(),
                kernel_tf32.data_ptr(), bias.data_ptr(), y.data_ptr(), n, h,
                w, ca, cb, cout, int(relu), *strides, stream)
        else:
            rc = lib.cid_conv3x3_bias_relu(
                x.data_ptr(), None if x2 is None else x2.data_ptr(),
                kernel.data_ptr(), bias.data_ptr(), y.data_ptr(), n, h, w,
                ca, cb, cout, int(relu), *strides,
                _build.dtype_code(x.dtype), stream)
        _build.check(rc, "conv3x3_bias_relu")
        LAUNCHES += 1
    return y


def conv3x3_bias_relu(x: torch.Tensor, kernel: torch.Tensor,
                      bias: torch.Tensor, *, relu: bool = True,
                      x2: Optional[torch.Tensor] = None,
                      kernel_tf32: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Port of ``conv_fused.conv3x3_bias_relu`` (K2).  x (N,H,W,Cin) f32 or
    bf16; kernel (3,3,Cin,Cout) in x's dtype; bias (Cout,) f32.  Any H, W.
    With ``x2`` (N,H,W,C2) the input is ``cat([x, x2], 3)`` and the kernel
    (3,3,Cin+C2,Cout).  ``kernel_tf32``: ``tf32_weights(kernel)``, made
    once by a caller that keeps its weights (read in f32 with Cout > 4 on
    the card; made here when absent)."""
    return _run(x, kernel, bias, relu, x2, kernel_tf32)


def conv3x3_bias_relu_q8_plain(x: torch.Tensor, kernel: torch.Tensor,
                               bias: torch.Tensor, scale: torch.Tensor, *,
                               relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3_bias_relu_q8`` (``_conv_f`` then
    ``_q``)."""
    from celebrity_image_denoiser_tpu_torch.ops.cuda.conv3x3_s8 import (
        quantize_s8,
    )

    y = conv2d(x.permute(0, 3, 1, 2).float(),
               kernel.permute(3, 2, 0, 1).float(), padding=1)
    h = y.to(torch.bfloat16).permute(0, 2, 3, 1) + bias.to(torch.bfloat16)
    return quantize_s8(torch.relu(h) if relu else h, scale).contiguous()


def conv3x3_bias_relu_q8(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, scale: torch.Tensor, *,
                         relu: bool = True) -> torch.Tensor:
    """x (N,H,W,Cin) bf16, kernel (3,3,Cin,Cout) bf16 with Cout > 8, bias
    (Cout,) f32 (added as bf16), scale (Cout,) f32 → (N,H,W,Cout) s8."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    _check(x, kernel, bias, x.shape[-1])
    cout = kernel.shape[3]
    if cout <= 8:
        raise ValueError(f"the s8 output needs Cout > 8, got {cout}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (cout,) \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous ({cout},) float32 on "
                         f"{x.device}")
    refuse_grad("conv3x3_bias_relu_q8", x, kernel, bias)
    if x.device.type == "cpu":
        return conv3x3_bias_relu_q8_plain(x, kernel, bias, scale, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    global LAUNCHES
    n, h, w, cin = x.shape
    y = torch.empty((n, h, w, cout), dtype=torch.int8, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device), _build.LAUNCH_LOCK:
        rc = lib.cid_conv3x3_bias_relu_q8(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), y.data_ptr(), n, h, w, cin, cout, int(relu),
            stream)
        _build.check(rc, "conv3x3_bias_relu_q8")
        LAUNCHES += 1
    return y


def conv3x3_bias_relu_v2(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, *, relu: bool = True,
                         x2: Optional[torch.Tensor] = None,
                         kernel_tf32: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Port of ``conv_fused.conv3x3_bias_relu_v2`` (K1): the same function
    and the same CUDA kernel as ``conv3x3_bias_relu``."""
    return _run(x, kernel, bias, relu, x2, kernel_tf32)
