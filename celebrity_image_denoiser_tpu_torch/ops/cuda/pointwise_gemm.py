"""K9: a 1×1 conv over NHWC float32 pixel rows as a GEMM on the tensor
cores, BiasFree LayerNorm folded in as a row scale, the residual add in
its epilogue (Restormer's 1×1 convs; ``csrc/pointwise_gemm.cu`` has the
design).

``pointwise_gemm(a, w)``: a (N, H, W, K) f32 whose channels are contiguous
and whose pixel rows lie a constant stride apart (a channel slice of a
wider NHWC tensor, such as the v of MDTA's qkv, is one); w (Cout, K) f32,
or (N, Cout, K) for a weight per image → y (N, H, W, Cout) f32:

    y = r · (a · wᵀ) + residual

with r = 1 / sqrt(var(a) + 1e-5) over each pixel's K channels (the
variance centred, as ``torch.var(unbiased=False)``) where ``layer_norm``
is set, else 1, and residual (N, H, W, Cout) where given.  A BiasFree
LayerNorm before the conv, ``LN(x) · Wᵀ`` with ``LN(x) = x / sqrt(var(x)
+ 1e-5) · g``, is ``r · (x · (W · diag(g))ᵀ)``: the caller folds ``g``
into ``w``.

The kernel takes its weights split into TF32 hi and lo and laid out as
its B tiles: ``gemm_weights(w)``.  A caller that keeps its weights makes
that once and passes it as ``w_tf32``; without it the wrapper makes it
for the one call (MDTA's per-image weights).

On a CUDA tensor the entry point launches the kernel or raises; on a CPU
tensor it runs ``pointwise_gemm_plain`` (the same arithmetic: the GEMM,
then the row scale, then the residual).  ``LAUNCHES`` counts the
launches.  No backward (``conv3x3.refuse_grad``).
"""

from __future__ import annotations

from typing import Optional

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build
from celebrity_image_denoiser_tpu_torch.ops.cuda.conv3x3 import (
    refuse_grad,
    round_tf32,
)

LAUNCHES = 0  # launches of csrc/pointwise_gemm.cu
LN_EPS = 1e-5
PASS = 128  # output channels a pass of the kernel (its wgmma N)


def gemm_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cout, K) f32, or (N, Cout, K) → the kernel's split weights:
    (ceil(Cout / 128), 4 ceil(K / 32), 2, 128, 8) f32 (one such block an
    image), [pass, k8 step, hi/lo, n, k] = hi or lo of w[128 pass + n, 8
    step + k] with hi = tf32(w) and lo = tf32(w - hi), zero beyond Cout
    and K: one k8 step's hi and lo B tiles (K-major, as wgmma takes 32-bit
    types) 8192 bytes in a row, as the kernel stages them."""
    if w.dim() not in (2, 3) or w.dtype != torch.float32:
        raise ValueError(f"w must be f32 (Cout, K) or (N, Cout, K), got "
                         f"{tuple(w.shape)} {w.dtype}")
    with torch.no_grad():
        w3 = w if w.dim() == 3 else w.unsqueeze(0)
        b, cout, k = w3.shape
        p, k8 = -(-cout // PASS), 4 * -(-k // 32)
        wp = w3.new_zeros((b, PASS * p, 8 * k8))
        wp[:, :cout, :k] = w3
        hi = round_tf32(wp)
        lo = round_tf32(wp - hi)
        split = torch.stack([hi, lo], 1).view(b, 2, p, PASS, k8, 8)
        split = split.permute(0, 2, 4, 1, 3, 5).contiguous()
        return split if w.dim() == 3 else split[0]


def _rows_stride(a: torch.Tensor) -> Optional[int]:
    """The stride between a's pixel rows where one stride walks all of
    them (channels contiguous), else None."""
    n, h, w, k = a.shape
    lda = a.stride(2) if w > 1 else (a.stride(1) if h > 1 else
                                     (a.stride(0) if n > 1 else k))
    if k > 1 and a.stride(3) != 1:
        return None
    if (h > 1 and a.stride(1) != w * lda) or \
            (n > 1 and a.stride(0) != h * w * lda) or lda < k:
        return None
    return lda


def _check(a, w, residual, w_tf32) -> None:
    if a.dim() != 4 or a.dtype != torch.float32 or _rows_stride(a) is None:
        raise ValueError(f"a must be f32 (N, H, W, K) with contiguous "
                         f"channels and one stride between pixel rows, got "
                         f"{tuple(a.shape)} {a.dtype} strides {a.stride()}")
    n, _, _, k = a.shape
    if w.dtype != torch.float32 or w.device != a.device or not (
            (w.dim() == 2 and w.shape[1] == k) or
            (w.dim() == 3 and tuple(w.shape[::2]) == (n, k))):
        raise ValueError(f"w must be f32 (Cout, {k}) or ({n}, Cout, {k}) on "
                         f"{a.device}, got {tuple(w.shape)} {w.dtype} on "
                         f"{w.device}")
    cout = w.shape[-2]
    if residual is not None and (
            tuple(residual.shape) != (*a.shape[:3], cout)
            or residual.dtype != torch.float32
            or residual.device != a.device or not residual.is_contiguous()):
        raise ValueError(f"residual must be contiguous f32 "
                         f"{(*a.shape[:3], cout)} on {a.device}, got "
                         f"{tuple(residual.shape)}")
    if w_tf32 is not None:
        want = ((n,) if w.dim() == 3 else ()) + (
            -(-cout // PASS), 4 * -(-k // 32), 2, PASS, 8)
        if tuple(w_tf32.shape) != want or w_tf32.dtype != torch.float32 \
                or w_tf32.device != a.device or not w_tf32.is_contiguous():
            raise ValueError(f"split weights must be contiguous f32 {want} "
                             f"on {a.device} (gemm_weights), got "
                             f"{tuple(w_tf32.shape)}")
    if a.numel() == 0 or cout == 0:
        raise ValueError(f"empty GEMM: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}")


def pointwise_gemm_plain(a: torch.Tensor, w: torch.Tensor, *,
                         layer_norm: bool = False,
                         residual: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: the f32 GEMM, then the row scale r, then
    the residual.  NHWC in, NHWC out."""
    n, h, wd, k = a.shape
    rows = a.reshape(n, h * wd, k)
    y = torch.matmul(rows, w.transpose(-1, -2))
    if layer_norm:
        var = rows.var(-1, keepdim=True, unbiased=False)
        y = y * (1 / torch.sqrt(var + LN_EPS))
    y = y.view(n, h, wd, -1)
    if residual is not None:
        y = y + residual
    return y.contiguous()


def pointwise_gemm(a: torch.Tensor, w: torch.Tensor, *,
                   layer_norm: bool = False,
                   residual: Optional[torch.Tensor] = None,
                   w_tf32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9: a (N, H, W, K) f32, w (Cout, K) or (N, Cout, K) f32 → (N, H, W,
    Cout) f32 = r · (a · wᵀ) + residual (the module docstring).
    ``w_tf32``: ``gemm_weights(w)``, made once by a caller that keeps its
    weights (made here when absent)."""
    _check(a, w, residual, w_tf32)
    refuse_grad("pointwise_gemm", a, w,
                *(() if residual is None else (residual,)))
    if a.device.type == "cpu":
        return pointwise_gemm_plain(a, w, layer_norm=layer_norm,
                                    residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    global LAUNCHES
    n, h, wd, k = a.shape
    cout = w.shape[-2]
    if w_tf32 is None:
        w_tf32 = gemm_weights(w)
    per_image = w.dim() == 3
    y = torch.empty((n, h, wd, cout), dtype=torch.float32, device=a.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device), _build.LAUNCH_LOCK:
        rc = lib.cid_pointwise_gemm(
            a.data_ptr(), _rows_stride(a), w_tf32.data_ptr(),
            w_tf32[0].numel() if per_image else 0,
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            n if per_image else 1, h * wd if per_image else n * h * wd, k,
            cout, int(layer_norm), stream)
        _build.check(rc, "pointwise_gemm")
        LAUNCHES += 1
    return y
