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

* ``noise_batch(kinds, seed, x, types, variant, domain)`` → ``(noisy,
  clean)``, float32 in [-1, 1] (``domain="tanh"``) or on [0, 1]
  (``"unit"``): sample n takes kind ``types[kinds[n]]`` (gaussian,
  salt_pepper, speckle, poisson, uniform) of noise ``variant`` 1, 2 or 3
  (the JAX package's ``data/noise.py:45-170``, with its on-device poisson
  scale of 256 in variants 2 and 3); ``clean`` is ``x.to(float32) / 255.0``
  as PyTorch computes it on the card, ``* 2.0 - 1.0`` in [-1, 1].
  ``kinds`` and the one-element ``seed`` are device tensors (the trainer
  draws both on the card): nothing comes to the host.
* ``blind_noise_batch(seed, x, domain)``: the same kernel with every sample
  gaussian at a σ of its own, drawn from the stream per sample in
  U[5, 50]/255 (``blind_gaussian_batch``, ``noise.py:232-242``).
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
* uniform: ``u = (a>>8)·2⁻²⁴``; poisson: the word ``a`` inverted against
  ``poisson_tables``; salt & pepper: ``u_a = (a>>8)·2⁻²⁴`` and ``u_b =
  (b>>8)·2⁻²⁴``, in variant 1 from ``(a, b)`` of the pixel's channel-0
  element (``u_a`` salt, ``u_b`` pepper), in variants 2 and 3 from the
  element's own (variant 2: ``u_a`` whether it flips, ``u_b`` whether to
  salt; variant 3: ``u_a`` salt, ``u_b`` pepper);
* the blind σ of sample n: ``u_n = (w₀>>8)·2⁻²⁴`` from word 0 of the block
  at counter ``(lo32(n), hi32(n), 1, 0)`` (the third word sets it apart
  from every element's counter), ``σ_n = (5 + u_n·45)·RN(1/255)``.

A sample that draws gaussian gets exactly what the gaussian-only entry
gives at that index.  The output depends on (seed, index, kinds) only.
With ``first_sample = k`` the batch entries take x as samples ``k ..`` of
a larger batch: their element indices and blind-σ blocks are those
samples', so each rank of a data-parallel step writes its rows of the
whole batch's launch, bit for bit.

On a CUDA tensor each entry launches the kernel or raises; on a CPU tensor
it runs its plain version (``noise_batch_plain``,
``fused_normalize_gaussian_noise_plain``).  ``LAUNCHES`` counts the
kernel's launches by ``noise_batch``, ``GAUSSIAN_LAUNCHES`` those by
``fused_normalize_gaussian_noise``; ``blind_noise_batch`` counts in
``LAUNCHES`` too (the same kernel, dncnn's input stage).

The variants' parameters, the kind codes and the per-kind functions of the
draws (``*_from_draws``) are defined here, once: the plain version is made
of them, and ``data/noise.py`` draws from a generator and calls them.
"""

from __future__ import annotations

import functools
import math

import torch

from celebrity_image_denoiser_tpu_torch.ops.cuda import _build

LAUNCHES = 0  # launches by noise_batch and blind_noise_batch
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
# variant 2 (noise.py:91-119): skimage style, uniform on the 0-255 scale
SP2_AMOUNT = 0.05
UNIFORM2_LOW, UNIFORM2_HIGH = -50.0, 50.0
# variant 3 (noise.py:124-167): float [0, 1] parameters
GAUSSIAN3_VAR = 0.01
SP3_AMOUNT = 0.004
UNIFORM3_LOW, UNIFORM3_HIGH = -0.05, 0.05
POISSON_VALS = 256.0  # variants 2 and 3: Pois(x·vals)/vals
BLIND_SIGMA = (5.0, 50.0)  # blind_gaussian_batch, 0-255 scale
VARIANTS = (1, 2, 3)
DOMAINS = ("tanh", "unit")  # outputs in [-1, 1] or on [0, 1]
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
# each kind of each variant as a pure function of its draws; images float
# in [0, 1], any leading dims
def check_variant(variant: int) -> None:
    """Raise unless ``variant`` is 1, 2 or 3."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown noise variant {variant!r} (variants: "
                         "1|2|3)")


def check_domain(domain: str) -> None:
    if domain not in DOMAINS:
        raise ValueError(f"unknown output domain {domain!r}; choose from "
                         f"{DOMAINS}")


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


def salt_pepper_v2_from_draws(img, u_flip, u_salted, amount=SP2_AMOUNT):
    """skimage ``random_noise(mode='s&p', amount)``: each *element* flips
    with probability ``amount``, half of them to salt, half to pepper."""
    flip = u_flip < amount
    salted = u_salted < 0.5
    out = torch.where(flip & salted, torch.ones_like(img), img)
    return torch.where(flip & ~salted, torch.zeros_like(img), out)


def poisson_v2_from_draws(img, counts, vals=POISSON_VALS):
    """skimage poisson: ``Pois(img · vals) / vals`` given the counts."""
    return _clip01(counts.to(img.dtype) / vals)


def uniform_v2_from_draws(img, u, low=UNIFORM2_LOW, high=UNIFORM2_HIGH):
    return uniform_v1_from_draws(img, u, low, high)


def gaussian_v3_from_draws(img, normal, var=GAUSSIAN3_VAR):
    return _clip01(img + (var ** 0.5) * normal)


def salt_pepper_v3_from_draws(img, u_salt, u_pepper, amount=SP3_AMOUNT):
    """Per element: salt where ``u_salt < amount / 2``, then pepper where
    ``u_pepper < amount / 2`` (pepper written last)."""
    half = amount * 0.5
    out = torch.where(u_salt < half, torch.ones_like(img), img)
    return torch.where(u_pepper < half, torch.zeros_like(img), out)


def speckle_v3_from_draws(img, normal):
    return _clip01(img + img * normal)


def uniform_v3_from_draws(img, u, low=UNIFORM3_LOW, high=UNIFORM3_HIGH):
    return _clip01(img + (low + u * (high - low)))


def blind_gaussian_from_draws(img, normal, sigma01):
    """``clip(img + σ·n)`` with one σ per sample (``sigma01`` (N,) on the
    [0, 1] scale); img NHWC."""
    return _clip01(img + sigma01.view((-1,) + (1,) * (img.dim() - 1))
                   * normal)


# ---------------------------------------------------------------------------
# the whole input stage: noise_batch
_TABLES: dict = {}


def poisson_tables(device, variant: int = 1):
    """The exact Poisson inversion of ``variant``, built once on the host in
    float64 and kept on ``device``: for byte x = 0..255 (λ = x in variant
    1, λ = x·256/255 in variants 2 and 3) and k = 0..255 the threshold
    ``T[x, k] = ceil(P(K ≤ k | λ)·2³²) − 1``, so that for a uniform 32-bit
    word ``a`` the count ``#{k : T[x, k] < a}`` (at most 256) has P(count ≤
    k) = P(K ≤ k) to within 2⁻³².  Returns ``(keys, table, guide)``:
    ``keys`` int64 ``x·2³² + T[x, k]`` flattened (sorted: the plain
    version's ``searchsorted``), ``table`` the thresholds as 32-bit words
    (int32 bits, the kernel's), ``guide`` (256, 1025) uint8, the count at
    ``a = j·2²²`` for j = 0..1024, capped at 255 (a word's count lies
    between those at the ends of its bucket, where the kernel's search
    starts)."""
    check_variant(variant)
    dev = device if isinstance(device, torch.device) else torch.device(
        device)
    scale = 1.0 if variant == 1 else POISSON_VALS / 255.0
    if (dev, scale) not in _TABLES:
        lam = torch.arange(256, dtype=torch.float64)[:, None] * scale
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
        _TABLES[(dev, scale)] = (
            keys.reshape(-1).to(dev), table.contiguous().to(dev),
            guide.to(torch.uint8).contiguous().to(dev))
    return _TABLES[(dev, scale)]


def x01(x_uint8: torch.Tensor) -> torch.Tensor:
    """``x.to(float32) / 255.0``, as the trainer normalised its clean batch.
    PyTorch computes it on the card as the product with RN(1/255), which
    the kernel does, and on the CPU as the quotient (126 of the 256 values
    differ in the last bit)."""
    return x_uint8.to(torch.float32) / 255.0


def poisson_counts(x_uint8: torch.Tensor, a: torch.Tensor,
                   variant: int = 1) -> torch.Tensor:
    """K ~ Poisson(λ) of each byte (λ of ``variant``, ``poisson_tables``)
    from the words ``a`` (same shape): the table's thresholds each word
    passes, capped where the output saturates (255 in variant 1, 256 in 2
    and 3)."""
    keys = poisson_tables(x_uint8.device, variant)[0]
    lam = x_uint8.to(torch.int64)
    pos = torch.searchsorted(keys, ((lam << 32) + a).reshape(-1))
    return (pos.reshape(a.shape) - lam * 256).clamp(
        max=255 if variant == 1 else 256)


def blind_sigmas(seed: torch.Tensor, n: int, device,
                 first_sample: int = 0) -> torch.Tensor:
    """The blind σ of samples ``first_sample .. first_sample + n - 1`` on
    the [0, 1] scale, float32 (n,): ``(lo + u·(hi − lo))·RN(1/255)``,
    ``u`` from the stream's per-sample block (counter ``(lo32(s), hi32(s),
    1, 0)``, word 0)."""
    s = seed.reshape(()).to(torch.int64)
    key = (s & _MASK32, (s >> 32) & _MASK32)
    i = torch.arange(first_sample, first_sample + n, dtype=torch.int64,
                     device=device)
    w0 = philox4x32_10((i & _MASK32, (i >> 32) & _MASK32,
                        torch.ones_like(i), torch.zeros_like(i)), key)[0]
    u = (w0 >> 8).to(torch.float32) * 2.0 ** -24
    lo, hi = BLIND_SIGMA
    return (u * (hi - lo) + lo) * (1.0 / 255.0)


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


def _check_first_sample(first_sample) -> int:
    if isinstance(first_sample, bool) or not isinstance(first_sample, int) \
            or first_sample < 0:
        raise ValueError(f"first_sample must be an int >= 0, got "
                         f"{first_sample!r}")
    return first_sample


def _check_x_seed(seed, x) -> None:
    if x.dtype != torch.uint8 or x.dim() != 4 or x.numel() == 0 \
            or not x.is_contiguous():
        raise ValueError(f"x must be non-empty contiguous uint8 (N, H, W, C), "
                         f"got {x.dtype} {tuple(x.shape)}")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError(f"seed must be a one-element int64 tensor, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    if seed.device != x.device:
        raise ValueError(f"seed on {seed.device}, x on {x.device}: both on "
                         "one device")


def _check_batch(kinds, seed, x, types, variant, domain) -> int:
    """The code word of ``types``, once the arguments are checked (on the
    training path every step: the common case is a few comparisons)."""
    check_variant(variant)
    check_domain(domain)
    _check_x_seed(seed, x)
    if kinds.dtype != torch.int64 or kinds.shape != x.shape[:1] \
            or not kinds.is_contiguous():
        raise ValueError(f"kinds must be contiguous int64 ({x.shape[0]},), "
                         f"got {kinds.dtype} {tuple(kinds.shape)}")
    if kinds.device != x.device:
        raise ValueError(f"kinds on {kinds.device}, x on {x.device}: all on "
                         "one device")
    return _codes(tuple(types))


def _u24(w):
    return (w >> 8).to(torch.float32) * 2.0 ** -24


def _words(seed, x_uint8, first_sample: int = 0):
    """The words ``(a, b)`` of x's elements, x being samples
    ``first_sample ..`` of a larger batch."""
    shape = x_uint8.shape
    return tuple(w.reshape(shape) for w in uniform_bits(
        seed, x_uint8.numel(), x_uint8.device,
        first_sample * x_uint8[0].numel()))


def _kind_plain(kind, variant, x_uint8, img, a, b, normal):
    """One kind of ``variant`` over the whole batch on [0, 1], from the
    stream's words: the ``*_from_draws`` functions above."""
    if kind == "gaussian":  # x·RN(1/255), the gaussian-only entry's x01
        g_img = x_uint8.to(torch.float32) * (1.0 / 255.0)
        return (gaussian_v3_from_draws(g_img, normal) if variant == 3
                else gaussian_v1_from_draws(g_img, normal))
    if kind == "speckle":
        return (speckle_v3_from_draws(img, normal) if variant == 3
                else speckle_v1_from_draws(img, normal))
    if kind == "uniform":
        return {1: uniform_v1_from_draws, 2: uniform_v2_from_draws,
                3: uniform_v3_from_draws}[variant](img, _u24(a))
    if kind == "poisson":
        counts = poisson_counts(x_uint8, a, variant)
        return (poisson_v1_from_draws(img, counts) if variant == 1
                else poisson_v2_from_draws(img, counts))
    if variant == 1:  # the words of each pixel's channel-0 element
        return salt_pepper_v1_from_draws(img, _u24(a[..., :1]),
                                         _u24(b[..., :1]))
    return (salt_pepper_v2_from_draws(img, _u24(a), _u24(b)) if variant == 2
            else salt_pepper_v3_from_draws(img, _u24(a), _u24(b)))


def _in_domain(v01: torch.Tensor, domain: str) -> torch.Tensor:
    return v01 if domain == "unit" else v01 * 2.0 - 1.0


def noise_batch_plain(kinds: torch.Tensor, seed: torch.Tensor,
                      x_uint8: torch.Tensor, types=tuple(KIND_CODES),
                      variant: int = 1, domain: str = "tanh",
                      first_sample: int = 0):
    """Plain PyTorch version of ``noise_batch``: the stream's words fed into
    the functions above that the CPU tests hold against JAX
    (``*_from_draws``), every kind computed for the whole batch and each
    sample's picked; ``x / 255`` as PyTorch computes it on x's device.  No
    host sync either."""
    _check_batch(kinds, seed, x_uint8, types, variant, domain)
    a, b = _words(seed, x_uint8, _check_first_sample(first_sample))
    img = x01(x_uint8)
    normal = normals_from_bits(a, b)
    noisy = torch.full(x_uint8.shape, float("nan"), device=x_uint8.device)
    pick = kinds.view(-1, 1, 1, 1)
    for j, kind in enumerate(types):
        one = _in_domain(_kind_plain(kind, variant, x_uint8, img, a, b,
                                     normal), domain)
        noisy = torch.where(pick == j, one, noisy)
    return noisy, _in_domain(img, domain)


def blind_noise_batch_plain(seed: torch.Tensor, x_uint8: torch.Tensor,
                            domain: str = "unit", first_sample: int = 0):
    """Plain PyTorch version of ``blind_noise_batch``."""
    check_domain(domain)
    _check_x_seed(seed, x_uint8)
    first_sample = _check_first_sample(first_sample)
    a, b = _words(seed, x_uint8, first_sample)
    img = x01(x_uint8)
    sigma = blind_sigmas(seed, x_uint8.shape[0], x_uint8.device,
                         first_sample)
    noisy = blind_gaussian_from_draws(img, normals_from_bits(a, b), sigma)
    return _in_domain(noisy, domain), _in_domain(img, domain)


@functools.lru_cache(maxsize=None)
def _constants(variant: int, channels: int):
    """The kernel's per-kind constants of ``variant``: the gaussian σ and
    the uniform's range and low end on [0, 1], the speckle σ, and the salt
    & pepper thresholds of words a and b, each rounded to float by the
    call."""
    if variant == 1:
        sp = (1.0 - math.exp(-SALT_PROB * channels),
              1.0 - math.exp(-PEPPER_PROB * channels))
        return (GAUSSIAN_SIGMA / 255.0, SPECKLE_SIGMA, UNIFORM_HIGH / 255.0,
                0.0) + sp
    if variant == 2:
        return (GAUSSIAN_SIGMA / 255.0, SPECKLE_SIGMA,
                (UNIFORM2_HIGH - UNIFORM2_LOW) / 255.0, UNIFORM2_LOW / 255.0,
                SP2_AMOUNT, 0.5)
    return (GAUSSIAN3_VAR ** 0.5, 1.0, UNIFORM3_HIGH - UNIFORM3_LOW,
            UNIFORM3_LOW, SP3_AMOUNT * 0.5, SP3_AMOUNT * 0.5)


def _launch(label, x, kinds, codes, seed, variant, domain, consts, table,
            guide, first_sample):
    global LAUNCHES
    # one allocation for both outputs: the host's time is the step's
    noisy, clean = torch.empty((2, *x.shape), dtype=torch.float32,
                               device=x.device).unbind(0)
    n, h, w, c = x.shape
    lo, hi = BLIND_SIGMA
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device), _build.LAUNCH_LOCK:
        rc = lib.cid_noise_batch(
            x.data_ptr(), noisy.data_ptr(), clean.data_ptr(), kinds, codes,
            seed.data_ptr(), 0, first_sample, n * h * w * c, h * w * c, c,
            table, guide,
            variant, int(domain == "unit"), *consts, lo, hi - lo,
            _build.dtype_code(torch.float32), stream)
        _build.check(rc, label)
        LAUNCHES += 1
    return noisy, clean


def noise_batch(kinds: torch.Tensor, seed: torch.Tensor,
                x_uint8: torch.Tensor, types=tuple(KIND_CODES),
                variant: int = 1, domain: str = "tanh",
                first_sample: int = 0):
    """x_uint8 (N, H, W, C) uint8 → ``(noisy, clean)``, (N, H, W, C) float32
    in [-1, 1] or on [0, 1] (``domain``), in one launch: sample n takes
    noise kind ``types[kinds[n]]`` of ``variant`` (``kinds`` (N,) int64 on
    x's device, each in ``range(len(types))``; any other index gives NaN)
    with the stream of ``seed`` (a one-element int64 tensor on x's device,
    read there).  ``first_sample``: x is samples ``first_sample ..
    first_sample + N - 1`` of a larger batch (a rank's share of a
    data-parallel step) and draws what they draw in a launch over that
    batch, bit for bit; 0 (the default) for a whole batch."""
    codes = _check_batch(kinds, seed, x_uint8, types, variant, domain)
    first_sample = _check_first_sample(first_sample)
    if x_uint8.device.type == "cpu":
        return noise_batch_plain(kinds, seed, x_uint8, types, variant, domain,
                                 first_sample)
    if x_uint8.device.type != "cuda":
        raise ValueError(f"unsupported device {x_uint8.device}")
    _, table, guide = poisson_tables(x_uint8.device, variant)
    return _launch("noise_batch", x_uint8, kinds.data_ptr(), codes, seed,
                   variant, domain, _constants(variant, x_uint8.shape[3]),
                   table.data_ptr(), guide.data_ptr(), first_sample)


def blind_noise_batch(seed: torch.Tensor, x_uint8: torch.Tensor,
                      domain: str = "unit", first_sample: int = 0):
    """x_uint8 (N, H, W, C) uint8 → ``(noisy, clean)`` in ``domain``, in one
    launch of the noise kernel: every sample gaussian with its own σ,
    ``U[BLIND_SIGMA]/255`` drawn from the stream of ``seed`` (a one-element
    int64 tensor on x's device, read there; ``blind_sigmas``).
    ``first_sample`` as in ``noise_batch``: the σ and the normals of
    samples ``first_sample ..`` of a larger batch."""
    check_domain(domain)
    _check_x_seed(seed, x_uint8)
    first_sample = _check_first_sample(first_sample)
    if x_uint8.device.type == "cpu":
        return blind_noise_batch_plain(seed, x_uint8, domain, first_sample)
    if x_uint8.device.type != "cuda":
        raise ValueError(f"unsupported device {x_uint8.device}")
    return _launch("blind_noise_batch", x_uint8, None, 0, seed, 0, domain,
                   (0.0,) * 6, None, None, first_sample)
