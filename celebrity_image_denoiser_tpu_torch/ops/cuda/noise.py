"""The training input stage on the card: noise and normalisation in one
launch.

Port of ``celebrity_image_denoiser_tpu/ops/pallas/noise_kernel.py::
fused_normalize_gaussian_noise`` (:46) — for every element of a uint8 NHWC
batch

    out = clip(x·(1/255) + (σ/255)·n, 0, 1)·2 − 1,     n ~ N(0, 1)

with σ on the 0-255 scale (noise v1's gaussian) — and of what surrounds it
in the JAX package's input stage: ``data/noise.py::random_noise_batch``
(:207-229), one compiled program in which each sample takes the noise kind
it drew, and the trainer's normalisation of the clean batch.  The CUDA
kernel is ``csrc/normalize_gaussian_noise.cu`` (see its header for the
design); it has two entries:

* ``noise_batch(kinds, seed, x, types)`` → ``(noisy, clean)``, float32 in
  [-1, 1]: sample n takes variant-1 kind ``types[kinds[n]]`` (gaussian,
  salt_pepper, speckle, poisson, uniform); ``clean`` is
  ``x.to(float32) / 255.0 * 2.0 - 1.0`` as PyTorch computes it on the card.
  ``kinds`` and the one-element ``seed`` are device tensors (the trainer
  draws both on the card): nothing comes to the host.
* ``fused_normalize_gaussian_noise(seed, x)``, the counterpart of the Pallas
  function: every element gaussian, one output, the seed a Python int.

The stream.  The TPU kernel draws from its core's hardware generator; this
port draws from Philox4x32-10, written out in the kernel and here, so the
plain version reproduces the kernel bit for bit:

* ``i`` is the flat element index over the whole tensor, 64 bits;
* counter ``(lo32(i>>1), hi32(i>>1), 0, 0)``, key ``(lo32(seed),
  hi32(seed))``;
* an even ``i`` takes output words 0, 1 as ``(a, b)``, an odd ``i`` words
  2, 3;
* ``u1 = (a>>8)·2⁻²⁴ + 2⁻²⁵`` ∈ (0, 1], ``u2 = (b>>8)·2⁻²⁴`` ∈ [0, 1)
  (``noise_kernel.py:33-36``); ``n = sqrt(−2·ln u1)·cos(2π·u2)``;
* uniform: ``u = (a>>8)·2⁻²⁴``; salt & pepper: ``u_salt``, ``u_pepper`` from
  ``(a, b)`` of the pixel's channel-0 element; poisson: the word ``a``
  inverted against ``poisson_tables``.

A sample that draws gaussian gets exactly what the gaussian-only entry
gives at that index.  The output depends on (seed, index, kinds) only.

On a CUDA tensor each entry launches the kernel or raises; on a CPU tensor
it runs its plain version (``noise_batch_plain``,
``fused_normalize_gaussian_noise_plain``).  ``LAUNCHES`` counts the
kernel's launches by ``noise_batch``, ``GAUSSIAN_LAUNCHES`` those by
``fused_normalize_gaussian_noise``.

The variant-1 parameters, the kind codes and the per-kind functions of the
draws (``*_from_draws``) are defined here, once: the plain version is made
of them, and ``data/noise.py`` draws from a generator and calls them.
"""

from __future__ import annotations

import functools
import math

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # launches of csrc/normalize_gaussian_noise.cu by noise_batch
GAUSSIAN_LAUNCHES = 0  # ... by fused_normalize_gaussian_noise

# the kernel's kind codes (csrc/noise.cuh); their order is data/noise.py's
# NOISE_TYPES
KIND_CODES = {"gaussian": 0, "salt_pepper": 1, "speckle": 2, "poisson": 3,
              "uniform": 4}
MAX_TYPES = 8  # 4 bits a type in the kernel's code word
# noise variant 1 (the JAX package's data/noise.py:47-86): uint8-domain
# parameters, gaussian and uniform on the 0-255 scale
GAUSSIAN_SIGMA = 25.0
SPECKLE_SIGMA = 0.1
UNIFORM_HIGH = 25.0
SALT_PROB = PEPPER_PROB = 0.02
_WAITING = ("variants 2 and 3 of the noise functions are not ported yet "
            "(ROADMAP.md queue 1 item 10)")
POISSON_GUIDE_SHIFT = 22  # the guide's buckets: a >> 22

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


def uniform_bits(seed, n: int, device, index_offset: int = 0):
    """The two 32-bit words ``(a, b)`` of the stream for elements
    ``index_offset .. index_offset + n - 1``, as int64 tensors; ``seed`` a
    Python int or a one-element int64 tensor on ``device`` (read there)."""
    if isinstance(seed, torch.Tensor):
        s = seed.reshape(()).to(torch.int64)
        key = (s & _MASK32, (s >> 32) & _MASK32)
    else:
        seed &= (1 << 64) - 1
        key = (seed & _MASK32, seed >> 32)
    i = torch.arange(index_offset, index_offset + n, dtype=torch.int64,
                     device=device)
    pair = i >> 1
    zero = torch.zeros_like(pair)
    w = philox4x32_10((pair & _MASK32, (pair >> 32) & _MASK32, zero, zero),
                      key)
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
    global GAUSSIAN_LAUNCHES
    y = torch.empty(x_uint8.shape, dtype=out_dtype, device=x_uint8.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x_uint8.device).cuda_stream
    with torch.cuda.device(x_uint8.device), _build.LAUNCH_LOCK:
        rc = lib.cid_normalize_gaussian_noise(
            x_uint8.data_ptr(), y.data_ptr(), x_uint8.numel(), seed,
            float(sigma) / 255.0, _build.dtype_code(out_dtype), stream)
        _build.check(rc, "fused_normalize_gaussian_noise")
        GAUSSIAN_LAUNCHES += 1
    return y


# ---------------------------------------------------------------------------
# variant 1: each kind as a pure function of its draws; images float in
# [0, 1], any leading dims
def check_variant(variant: int) -> None:
    """Raise unless ``variant`` is 1, the one that is ported."""
    if variant in (2, 3):
        raise NotImplementedError(_WAITING)
    if variant != 1:
        raise ValueError(f"unknown noise variant {variant!r} (variants: "
                         "1|2|3)")


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def gaussian_v1_from_draws(img, normal, mean=0.0, sigma=GAUSSIAN_SIGMA):
    return _clip01(img + (mean / 255.0 + (sigma / 255.0) * normal))


def salt_pepper_v1_from_draws(img, u_salt, u_pepper, salt_prob=SALT_PROB,
                              pepper_prob=PEPPER_PROB):
    c = img.shape[-1]
    p_salt = 1.0 - math.exp(-salt_prob * c)
    p_pepper = 1.0 - math.exp(-pepper_prob * c)
    out = torch.where(u_salt < p_salt, torch.ones_like(img), img)
    return torch.where(u_pepper < p_pepper, torch.zeros_like(img), out)


def speckle_v1_from_draws(img, normal, sigma=SPECKLE_SIGMA):
    return _clip01(img + img * (sigma * normal))


def poisson_v1_from_draws(img, counts):
    return _clip01(counts.to(img.dtype) / 255.0)


def uniform_v1_from_draws(img, u, low=0.0, high=UNIFORM_HIGH):
    return _clip01(img + (low / 255.0 + u * ((high - low) / 255.0)))


# ---------------------------------------------------------------------------
# the whole input stage: noise_batch
_TABLES: dict = {}


def poisson_tables(device):
    """The exact Poisson inversion, built once on the host in float64 and
    kept on ``device``: for λ = 0..255 and k = 0..255 the threshold
    ``T[λ, k] = ceil(P(K ≤ k | λ)·2³²) − 1``, so that for a uniform 32-bit
    word ``a`` the count ``#{k : T[λ, k] < a}`` (at most 255) has P(count ≤
    k) = P(K ≤ k) to within 2⁻³².  Returns ``(keys, table, guide)``:
    ``keys`` int64 ``λ·2³² + T[λ, k]`` flattened (sorted: the plain
    version's ``searchsorted``), ``table`` the thresholds as 32-bit words
    (int32 bits, the kernel's), ``guide`` (256, 1025) uint8, the count at
    ``a = j·2²²`` for j = 0..1024 (a word's count lies between those at the
    ends of its bucket, where the kernel's search starts)."""
    dev = device if isinstance(device, torch.device) else torch.device(
        device)
    if dev not in _TABLES:
        lam = torch.arange(256, dtype=torch.float64)[:, None]
        k = torch.arange(256, dtype=torch.float64)[None, :]
        logp = k * torch.log(lam.clamp(min=1e-300)) - lam - torch.lgamma(k + 1)
        pmf = torch.where(lam == 0, (k == 0).double(), torch.exp(logp))
        cdf = torch.cumsum(pmf, dim=1).clamp(max=1.0)
        t = (torch.ceil(cdf * 2.0 ** 32) - 1).clamp(0, 2 ** 32 - 1).to(
            torch.int64)
        t = torch.cummax(t, dim=1).values  # sums can wobble at the top
        keys = (torch.arange(256, dtype=torch.int64)[:, None] << 32) + t
        starts = (torch.arange((1 << (32 - POISSON_GUIDE_SHIFT)) + 1,
                               dtype=torch.int64) << POISSON_GUIDE_SHIFT)
        guide = torch.searchsorted(t, starts[None, :].expand(256, -1)
                                   .contiguous()).clamp(max=255)
        table = torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)
        _TABLES[dev] = (keys.reshape(-1).to(dev), table.contiguous().to(dev),
                        guide.to(torch.uint8).contiguous().to(dev))
    return _TABLES[dev]


def x01(x_uint8: torch.Tensor) -> torch.Tensor:
    """``x.to(float32) / 255.0``, as the trainer normalised its clean batch.
    PyTorch computes it on the card as the product with RN(1/255), which
    the kernel does, and on the CPU as the quotient (126 of the 256 values
    differ in the last bit)."""
    return x_uint8.to(torch.float32) / 255.0


def poisson_counts(x_uint8: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K ~ Poisson(λ = x) from the words ``a`` (same shape), capped at 255:
    the table's thresholds each word passes."""
    keys = poisson_tables(x_uint8.device)[0]
    lam = x_uint8.to(torch.int64)
    pos = torch.searchsorted(keys, ((lam << 32) + a).reshape(-1))
    return (pos.reshape(a.shape) - lam * 256).clamp(max=255)


@functools.lru_cache(maxsize=None)
def _codes(types: tuple) -> int:
    """The kernel's code word: 4 bits per entry of ``types``, 0xF beyond."""
    if not 1 <= len(types) <= MAX_TYPES:
        raise ValueError(f"types must name 1 to {MAX_TYPES} kinds, got "
                         f"{types}")
    codes = 0
    for j in range(MAX_TYPES):
        if j < len(types):
            if types[j] not in KIND_CODES:
                raise ValueError(f"unknown noise kind {types[j]!r} (kinds: "
                                 f"{tuple(KIND_CODES)})")
            code = KIND_CODES[types[j]]
        else:
            code = 0xF
        codes |= code << (4 * j)
    return codes


def _check_batch(kinds, seed, x, types, variant) -> int:
    """The code word of ``types``, once the arguments are checked (on the
    training path every step: the common case is a few comparisons)."""
    check_variant(variant)
    if x.dtype != torch.uint8 or x.dim() != 4 or x.numel() == 0 \
            or not x.is_contiguous():
        raise ValueError(f"x must be non-empty contiguous uint8 (N, H, W, C), "
                         f"got {x.dtype} {tuple(x.shape)}")
    if kinds.dtype != torch.int64 or kinds.shape != x.shape[:1] \
            or not kinds.is_contiguous():
        raise ValueError(f"kinds must be contiguous int64 ({x.shape[0]},), "
                         f"got {kinds.dtype} {tuple(kinds.shape)}")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError(f"seed must be a one-element int64 tensor, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if kinds.device != x.device or seed.device != x.device:
        raise ValueError(f"kinds on {kinds.device}, seed on {seed.device}, "
                         f"x on {x.device}: all on one device")
    return _codes(tuple(types))


def noise_batch_plain(kinds: torch.Tensor, seed: torch.Tensor,
                      x_uint8: torch.Tensor, types=tuple(KIND_CODES),
                      variant: int = 1):
    """Plain PyTorch version of ``noise_batch``: the stream's words fed into
    the variant-1 functions above that the CPU tests hold against JAX
    (``*_from_draws``), every kind computed for the whole batch and each
    sample's picked; ``x / 255`` as PyTorch computes it on x's device.  No
    host sync either."""
    _check_batch(kinds, seed, x_uint8, types, variant)
    shape = x_uint8.shape
    a, b = (w.reshape(shape) for w in uniform_bits(
        seed, x_uint8.numel(), x_uint8.device))
    img = x01(x_uint8)
    clean = img * 2.0 - 1.0
    normal = normals_from_bits(a, b)

    def u24(w):
        return (w >> 8).to(torch.float32) * 2.0 ** -24

    def salt_pepper():
        # the words of each pixel's channel-0 element
        return salt_pepper_v1_from_draws(img, u24(a[..., :1]),
                                         u24(b[..., :1]))

    def one(kind):
        if kind == "gaussian":
            return normalize_add_noise(x_uint8, normal, GAUSSIAN_SIGMA,
                                       torch.float32)
        if kind == "salt_pepper":
            noisy01 = salt_pepper()
        elif kind == "speckle":
            noisy01 = speckle_v1_from_draws(img, normal)
        elif kind == "uniform":
            noisy01 = uniform_v1_from_draws(img, u24(a))
        else:
            noisy01 = poisson_v1_from_draws(img, poisson_counts(x_uint8, a))
        return noisy01 * 2.0 - 1.0

    noisy = torch.full(shape, float("nan"), device=x_uint8.device)
    pick = kinds.view(-1, 1, 1, 1)
    for j, kind in enumerate(types):
        noisy = torch.where(pick == j, one(kind), noisy)
    return noisy, clean


@functools.lru_cache(maxsize=None)
def _constants(channels: int):
    """The kernel's per-kind constants: σ/255 (gaussian), σ (speckle),
    (high − low)/255 (uniform), and the salt and pepper thresholds
    1 − e^(−p·C), each rounded to float by the call."""
    return (GAUSSIAN_SIGMA / 255.0, SPECKLE_SIGMA, UNIFORM_HIGH / 255.0,
            1.0 - math.exp(-SALT_PROB * channels),
            1.0 - math.exp(-PEPPER_PROB * channels))


def noise_batch(kinds: torch.Tensor, seed: torch.Tensor,
                x_uint8: torch.Tensor, types=tuple(KIND_CODES),
                variant: int = 1):
    """x_uint8 (N, H, W, C) uint8 → ``(noisy, clean)``, (N, H, W, C) float32
    in [-1, 1], in one launch: sample n takes noise kind ``types[kinds[n]]``
    (``kinds`` (N,) int64 on x's device, each in ``range(len(types))``; any
    other index gives NaN) with the stream of ``seed`` (a one-element int64
    tensor on x's device, read there)."""
    codes = _check_batch(kinds, seed, x_uint8, types, variant)
    if x_uint8.device.type == "cpu":
        return noise_batch_plain(kinds, seed, x_uint8, types, variant)
    if x_uint8.device.type != "cuda":
        raise ValueError(f"unsupported device {x_uint8.device}")
    global LAUNCHES
    # one allocation for both outputs: the host's time is the step's
    noisy, clean = torch.empty((2, *x_uint8.shape), dtype=torch.float32,
                               device=x_uint8.device).unbind(0)
    _, table, guide = poisson_tables(x_uint8.device)
    n, h, w, c = x_uint8.shape
    lib = _build.library()
    stream = torch.cuda.current_stream(x_uint8.device).cuda_stream
    with torch.cuda.device(x_uint8.device), _build.LAUNCH_LOCK:
        rc = lib.cid_noise_batch(
            x_uint8.data_ptr(), noisy.data_ptr(), clean.data_ptr(),
            kinds.data_ptr(), codes, seed.data_ptr(), 0, n * h * w * c,
            h * w * c, c, table.data_ptr(), guide.data_ptr(),
            *_constants(c), _build.dtype_code(torch.float32), stream)
        _build.check(rc, "noise_batch")
        LAUNCHES += 1
    return noisy, clean
