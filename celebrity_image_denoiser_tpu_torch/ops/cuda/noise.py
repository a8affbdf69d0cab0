"""Fused uint8 → [-1, 1] normalisation with additive Gaussian noise.

Port of ``celebrity_image_denoiser_tpu/ops/pallas/noise_kernel.py::
fused_normalize_gaussian_noise`` (:46), the training input stage: for every
element of a uint8 NHWC batch

    out = clip(x·(1/255) + (σ/255)·n, 0, 1)·2 − 1,     n ~ N(0, 1)

with σ on the 0-255 scale (noise v1's gaussian).  The CUDA kernel is
``csrc/normalize_gaussian_noise.cu`` (see its header for the design).

The stream.  The TPU kernel draws from its core's hardware generator; this
port draws from Philox4x32-10, written out in the kernel and here, so the
plain version reproduces the kernel bit for bit:

* ``i`` is the flat element index over the whole tensor, 64 bits;
* counter ``(lo32(i>>1), hi32(i>>1), 0, 0)``, key ``(lo32(seed),
  hi32(seed))``;
* an even ``i`` takes output words 0, 1 as ``(a, b)``, an odd ``i`` words
  2, 3;
* ``u1 = (a>>8)·2⁻²⁴ + 2⁻²⁵`` ∈ (0, 1], ``u2 = (b>>8)·2⁻²⁴`` ∈ [0, 1)
  (``noise_kernel.py:33-36``); ``n = sqrt(−2·ln u1)·cos(2π·u2)``.

The output depends on (seed, index) only — deterministic per (seed, shape),
as the original.

On a CUDA tensor ``fused_normalize_gaussian_noise`` launches the kernel or
raises; on a CPU tensor it runs ``fused_normalize_gaussian_noise_plain``.
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import math

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # launches of csrc/normalize_gaussian_noise.cu

_OUT_DTYPES = (torch.float32, torch.bfloat16)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # key increments (Weyl constants)
_MASK32 = 0xFFFFFFFF


def _check(seed, x: torch.Tensor, sigma, out_dtype) -> int:
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise TypeError(f"seed must be a Python int, got {type(seed).__name__}")
    if not -(1 << 63) <= seed < (1 << 64):
        raise ValueError(f"seed must fit 64 bits, got {seed}")
    if x.dtype != torch.uint8:
        raise TypeError(f"x must be uint8, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"x is empty: {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {_OUT_DTYPES}, got "
                        f"{out_dtype}")
    if not math.isfinite(float(sigma)) or float(sigma) < 0:
        raise ValueError(f"sigma must be finite and >= 0, got {sigma}")
    return seed & ((1 << 64) - 1)


def _mulhilo(m: int, c: torch.Tensor):
    """High and low 32-bit words of ``m·c`` for 32-bit ``m`` and ``c`` held
    in int64: the full product would overflow the sign bit, so ``c`` is
    split into 16-bit halves."""
    ch, cl = c >> 16, c & 0xFFFF
    ph, pl_ = ch * m, cl * m                      # each below 2^48
    hi = (ph + (pl_ >> 16)) >> 16
    lo = (((ph & 0xFFFF) << 16) + (pl_ & _MASK32)) & _MASK32
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``counter`` a
    4-tuple, ``key`` a 2-tuple (tensors or ints); returns the four output
    words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniform_bits(seed: int, n: int, device, index_offset: int = 0):
    """The two 32-bit words ``(a, b)`` of the stream for elements
    ``index_offset .. index_offset + n - 1``, as int64 tensors."""
    seed &= (1 << 64) - 1
    i = torch.arange(index_offset, index_offset + n, dtype=torch.int64,
                     device=device)
    pair = i >> 1
    zero = torch.zeros_like(pair)
    w = philox4x32_10((pair & _MASK32, (pair >> 32) & _MASK32, zero, zero),
                      (seed & _MASK32, seed >> 32))
    odd = (i & 1).bool()
    return torch.where(odd, w[2], w[0]), torch.where(odd, w[3], w[1])


def normals_from_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Box-Muller on the top 24 bits of each word, in float32."""
    u1 = (a >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = (b >> 8).to(torch.float32) * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def normalize_add_noise(x_uint8: torch.Tensor, normal: torch.Tensor,
                        sigma: float = 25.0,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """The transform alone, given the normals (same shape as ``x_uint8``)."""
    x01 = x_uint8.to(torch.float32) * (1.0 / 255.0)
    noisy = torch.clamp(x01 + (float(sigma) / 255.0) * normal, 0.0, 1.0)
    return (noisy * 2.0 - 1.0).to(out_dtype)


def fused_normalize_gaussian_noise_plain(
        seed: int, x_uint8: torch.Tensor, sigma: float = 25.0,
        out_dtype: torch.dtype = torch.bfloat16, *,
        _index_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the same Philox stream in integer tensor ops
    and the same float32 transform, on x's device.  ``_index_offset`` shifts
    the element index, so a slice of a larger tensor can be checked against
    the kernel's output for the whole."""
    seed = _check(seed, x_uint8, sigma, out_dtype)
    a, b = uniform_bits(seed, x_uint8.numel(), x_uint8.device, _index_offset)
    normal = normals_from_bits(a, b).reshape(x_uint8.shape)
    return normalize_add_noise(x_uint8, normal, sigma, out_dtype)


def fused_normalize_gaussian_noise(
        seed: int, x_uint8: torch.Tensor, sigma: float = 25.0,
        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x_uint8 (N, H, W, C) uint8 → (N, H, W, C) ``out_dtype`` in [-1, 1]
    with Gaussian noise of ``sigma`` on the 0-255 scale.  ``seed`` is a
    Python int of up to 64 bits."""
    seed = _check(seed, x_uint8, sigma, out_dtype)
    if x_uint8.device.type == "cpu":
        return fused_normalize_gaussian_noise_plain(seed, x_uint8, sigma,
                                                    out_dtype)
    if x_uint8.device.type != "cuda":
        raise ValueError(f"unsupported device {x_uint8.device}")
    global LAUNCHES
    y = torch.empty(x_uint8.shape, dtype=out_dtype, device=x_uint8.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x_uint8.device).cuda_stream
    with torch.cuda.device(x_uint8.device):
        rc = lib.cid_normalize_gaussian_noise(
            x_uint8.data_ptr(), y.data_ptr(), x_uint8.numel(), seed,
            float(sigma) / 255.0, _build.dtype_code(out_dtype), stream)
    _build.check(rc, "fused_normalize_gaussian_noise")
    LAUNCHES += 1
    return y

