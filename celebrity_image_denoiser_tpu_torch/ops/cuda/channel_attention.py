"""K7: the core of Restormer's transposed channel attention (MDTA), from the
depthwise conv's output to each head's softmaxed d × d attention matrix
(``csrc/mdta_attention.cu`` has the design).

``channel_attention(qkv, heads, temperature)``: qkv (N, H, W, 3C) f32 (q,
k and v, C channels each, as ``qkv.chunk(3)`` cuts the published tensor),
temperature (heads,) f32 → A (N, heads, d, d) f32 with d = C / heads ≤ 96
(Restormer's largest head):

    A = softmax over j of (q_i · k_j) / (|q_i| |k_j|) · temperature

q_i and k_j a head's channels over all H·W pixels, |·| their L2 norm
clamped below at 1e-12, as ``F.normalize`` clamps it.

On a CUDA tensor the entry point launches the kernel or raises; on a CPU
tensor it runs ``channel_attention_plain`` (the published equations:
``F.normalize``, then ``q @ k.T · temperature``, then the softmax).
``LAUNCHES`` counts the launches.  No backward (``conv3x3.refuse_grad``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build
from celebrity_image_denoiser_tpu_torch.ops.cuda.conv3x3 import refuse_grad

LAUNCHES = 0  # launches of csrc/mdta_attention.cu
MAX_HEAD = 96


def heads_of(qkv: torch.Tensor, heads: int) -> tuple:
    """(q, k) of ``qkv`` as (N, heads, d, H·W) views."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    flat = qkv.reshape(n, h * w, c3)

    def part(i):
        return flat[..., i * c:(i + 1) * c].reshape(
            n, h * w, heads, c // heads).permute(0, 2, 3, 1)
    return part(0), part(1)


def channel_attention_plain(qkv: torch.Tensor, heads: int,
                            temperature: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, as ``restormer_arch.py::Attention`` computes
    it."""
    q, k = heads_of(qkv, heads)
    q = F.normalize(q, dim=-1)
    k = F.normalize(k, dim=-1)
    attn = (q @ k.transpose(-2, -1)) * temperature.view(1, heads, 1, 1)
    return attn.softmax(dim=-1)


def _check(qkv: torch.Tensor, heads: int, temperature: torch.Tensor) -> int:
    if qkv.dim() != 4 or qkv.dtype != torch.float32 \
            or not qkv.is_contiguous() or qkv.shape[3] % 3:
        raise ValueError(f"qkv must be contiguous f32 (N, H, W, 3C), got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    c = qkv.shape[3] // 3
    if heads < 1 or c % heads or not 1 <= c // heads <= MAX_HEAD:
        raise ValueError(f"{c} channels do not split into {heads} heads of "
                         f"at most {MAX_HEAD}")
    if tuple(temperature.shape) != (heads,) \
            or temperature.dtype != torch.float32 \
            or temperature.device != qkv.device:
        raise ValueError(f"temperature must be f32 ({heads},) on "
                         f"{qkv.device}, got {tuple(temperature.shape)} "
                         f"{temperature.dtype} on {temperature.device}")
    if qkv.numel() == 0:
        raise ValueError(f"empty input {tuple(qkv.shape)}")
    return c // heads


def channel_attention(qkv: torch.Tensor, heads: int,
                      temperature: torch.Tensor) -> torch.Tensor:
    """K7: qkv (N, H, W, 3C) f32, temperature (heads,) f32 → (N, heads, d,
    d) f32."""
    d = _check(qkv, heads, temperature)
    refuse_grad("channel_attention", qkv, temperature)
    if qkv.device.type == "cpu":
        return channel_attention_plain(qkv, heads, temperature)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    global LAUNCHES
    n, h, w, c3 = qkv.shape
    temperature = temperature.contiguous()
    lib = _build.library()
    with torch.cuda.device(qkv.device):
        splits = lib.cid_mdta_splits(n, heads, h * w)
    part = torch.empty(lib.cid_mdta_workspace(n, heads, d, splits),
                       dtype=torch.float32, device=qkv.device)
    count = torch.zeros(n * heads, dtype=torch.int32, device=qkv.device)
    attn = torch.empty((n, heads, d, d), dtype=torch.float32,
                       device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device), _build.LAUNCH_LOCK:
        rc = lib.cid_mdta_attention(
            qkv.data_ptr(), temperature.data_ptr(), part.data_ptr(),
            count.data_ptr(), attn.data_ptr(), n, h * w, c3 // 3, heads,
            splits, stream)
        _build.check(rc, "channel_attention")
        LAUNCHES += 1
    return attn
