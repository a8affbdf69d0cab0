"""The port's noise path against the JAX package, on the CPU.

* ``ops/cuda/noise.py`` (K4, the fused normalise + Gaussian-noise kernel's
  plain version, which is what runs on a CPU tensor): its Philox4x32-10
  against known answers and an independent numpy implementation; the
  uniforms' ranges; the transform, given the same normals, against the
  formula of ``ops/pallas/noise_kernel.py:33-42``; the moments and the
  determinism that ``tests/test_pallas.py:78-93`` asks of the Pallas kernel
  (which has no CPU interpret path, ``test_pallas.py:71-75``); and its
  distribution against ``noise_kernel.xla_normalize_gaussian_noise``, the
  JAX package's own stand-in with the same semantics and another stream.
  (The CUDA source itself runs under the g++ emulation in
  ``test_torch_port_kernels.py``.)
* ``data/noise.py``: the five variant-1 kinds, by distribution as
  ``tests/test_noise.py`` holds the JAX functions, and exactly (1e-6) when
  both sides are given the same draws; ``random_noise_batch``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu.data import noise as jax_noise
from celebrity_image_denoiser_tpu.ops.pallas import noise_kernel as jax_kernel
from celebrity_image_denoiser_tpu_torch.data import noise as port_noise
from celebrity_image_denoiser_tpu_torch.ops.cuda import noise as k4

PHILOX_KAT = [  # Random123 kat_vectors: counter, key, output
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def np_philox4x32_10(counter, key):
    """An independent Philox4x32-10: numpy uint64 products, vectorised over
    the leading axis of ``counter`` (…, 4) and ``key`` (…, 2)."""
    c = np.array(counter, dtype=np.uint64).reshape(-1, 4).copy()
    k = np.array(key, dtype=np.uint64).reshape(-1, 2).copy()
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask, sh = np.uint64(0xFFFFFFFF), np.uint64(32)
    for _ in range(10):
        p0, p1 = m0 * c[:, 0], m1 * c[:, 2]          # below 2^64: no overflow
        c = np.stack([(p1 >> sh) ^ c[:, 1] ^ k[:, 0], p1 & mask,
                      (p0 >> sh) ^ c[:, 3] ^ k[:, 1], p0 & mask], axis=1)
        k = np.stack([(k[:, 0] + np.uint64(0x9E3779B9)) & mask,
                      (k[:, 1] + np.uint64(0xBB67AE85)) & mask], axis=1)
    return c


def _port_philox(counter, key):
    cols = tuple(torch.from_numpy(np.asarray(counter, np.int64)[:, j].copy())
                 for j in range(4))
    keys = tuple(torch.from_numpy(np.asarray(key, np.int64)[:, j].copy())
                 for j in range(2))
    return torch.stack(k4.philox4x32_10(cols, keys), dim=1).numpy()


@pytest.mark.parametrize("counter, key, want", PHILOX_KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got_np = np_philox4x32_10([counter], [key])[0]
    got_port = _port_philox([counter], [key])[0]
    assert tuple(int(v) for v in got_np) == want
    assert tuple(int(v) for v in got_port) == want


def test_philox_matches_independent_numpy():
    rng = np.random.default_rng(1)
    counter = rng.integers(0, 2 ** 32, (4096, 4), dtype=np.uint64)
    key = rng.integers(0, 2 ** 32, (4096, 2), dtype=np.uint64)
    np.testing.assert_array_equal(
        _port_philox(counter.astype(np.int64), key.astype(np.int64)),
        np_philox4x32_10(counter, key).astype(np.int64))


def test_stream_definition_and_uniform_ranges():
    """Element i reads counter (lo32(i>>1), hi32(i>>1), 0, 0) under key
    (lo32(seed), hi32(seed)): words 0,1 when i is even, 2,3 when odd — also
    past 2^32 pairs, where the counter's second word starts counting."""
    seed = (0xDEADBEEF << 32) | 0x12345678
    for offset in (0, 7, (1 << 33) + 3):
        n = 1001
        a, b = k4.uniform_bits(seed, n, "cpu", offset)
        i = np.arange(offset, offset + n, dtype=np.uint64)
        pair = i >> np.uint64(1)
        ctr = np.stack([pair & np.uint64(0xFFFFFFFF), pair >> np.uint64(32),
                        np.zeros_like(pair), np.zeros_like(pair)], axis=1)
        key = np.tile(np.array([[0x12345678, 0xDEADBEEF]], np.uint64), (n, 1))
        w = np_philox4x32_10(ctr, key).astype(np.int64)
        odd = (i & np.uint64(1)).astype(bool)
        np.testing.assert_array_equal(a.numpy(), np.where(odd, w[:, 2], w[:, 0]))
        np.testing.assert_array_equal(b.numpy(), np.where(odd, w[:, 3], w[:, 1]))
    # the extreme words give the ends of the ranges: u1 in (0, 1], u2 in [0, 1)
    ext = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    u1 = (ext >> 8).float() * 2.0 ** -24 + 2.0 ** -25
    u2 = (ext >> 8).float() * 2.0 ** -24
    assert 0.0 < u1.min().item() and u1.max().item() <= 1.0
    assert u2.min().item() == 0.0 and u2.max().item() < 1.0
    n = k4.normals_from_bits(ext, ext)
    assert torch.isfinite(n).all()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_transform_exact_given_the_same_normals(out_dtype):
    """clip(x/255 + σ/255·n, 0, 1)·2 − 1 on the same normals: 1e-6 in f32
    (x·(1/255) against x/255 is one ulp); bf16 is that rounded once."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (3, 9, 7, 3), dtype=np.uint8)
    n = rng.standard_normal(x.shape).astype(np.float32)
    want = np.clip(x.astype(np.float32) / 255.0
                   + np.float32(25.0 / 255.0) * n, 0.0, 1.0) * 2.0 - 1.0
    got = k4.normalize_add_noise(torch.from_numpy(x), torch.from_numpy(n),
                                 25.0, out_dtype)
    assert got.dtype == out_dtype and got.shape == x.shape
    if out_dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    else:
        ref = torch.from_numpy(want).to(torch.bfloat16)
        assert (got.float() - ref.float()).abs().max().item() <= 2.0 ** -7
        assert (got == ref).float().mean().item() > 0.99


def test_moments_and_determinism():
    """tests/test_pallas.py:78-93, on the port's function."""
    xu = torch.full((2, 64, 64, 3), 128, dtype=torch.uint8)
    o = k4.fused_normalize_gaussian_noise(42, xu, sigma=25.0,
                                          out_dtype=torch.float32).numpy()
    d = (o - (128 / 255 * 2 - 1)) * 255 / 2
    assert abs(d.mean()) < 1.0
    assert abs(d.std() - 25.0) < 2.0
    assert o.min() >= -1.0 and o.max() <= 1.0
    o2 = k4.fused_normalize_gaussian_noise(42, xu, sigma=25.0,
                                           out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(o, o2)
    o3 = k4.fused_normalize_gaussian_noise(43, xu, sigma=25.0,
                                           out_dtype=torch.float32).numpy()
    assert (o3 != o).any()
    # the default output type is bfloat16, as the original's
    assert k4.fused_normalize_gaussian_noise(42, xu).dtype == torch.bfloat16


def test_distribution_matches_the_jax_stand_in():
    """Against ``xla_normalize_gaussian_noise`` on the same uint8 image:
    another stream, so moments and quantiles of the output (196,608
    samples; tolerances a few standard errors wide)."""
    rng = np.random.default_rng(4)
    x = rng.integers(40, 216, (4, 64, 64, 3), dtype=np.uint8)
    ref = np.asarray(jax_kernel.xla_normalize_gaussian_noise(
        jax.random.PRNGKey(0), jnp.asarray(x), 25.0, jnp.float32))
    got = k4.fused_normalize_gaussian_noise(
        7, torch.from_numpy(x), 25.0, torch.float32).numpy()
    base = x.astype(np.float32) / 255.0 * 2 - 1
    dr, dg = (ref - base).ravel(), (got - base).ravel()
    assert abs(dg.mean() - dr.mean()) < 2e-3
    assert abs(dg.std() - dr.std()) < 2e-3
    q = [0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]
    np.testing.assert_allclose(np.quantile(dg, q), np.quantile(dr, q),
                               atol=6e-3)
    # normality of the port's own normals: skew and excess kurtosis near 0
    a, b = k4.uniform_bits(7, 200_000, "cpu")
    z = k4.normals_from_bits(a, b).double().numpy()
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1) < 0.01
    assert abs((z ** 3).mean()) < 0.03 and abs((z ** 4).mean() - 3) < 0.08
    # neighbours share a Philox block (words 0,1 and 2,3): uncorrelated
    assert abs(np.corrcoef(z[0::2], z[1::2])[0, 1]) < 0.01


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 9, 7, 3), (2, 5, 5, 4)],
                         ids=["one", "ragged", "c4"])
def test_odd_sizes_and_index_offset(shape):
    """Any shape; and a slice checked at its offset equals the whole."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)
    whole = k4.fused_normalize_gaussian_noise(9, x, 25.0, torch.float32)
    assert whole.shape == x.shape
    last = x[-1:].contiguous()
    part = k4.fused_normalize_gaussian_noise_plain(
        9, last, 25.0, torch.float32,
        _index_offset=x.numel() - last.numel())
    assert torch.equal(part, whole[-1:])


@pytest.mark.parametrize("bad, exc", [
    (lambda x: (1, x.float()), TypeError),                 # not uint8
    (lambda x: (1, x[0]), ValueError),                     # not 4-D
    (lambda x: (1, x.transpose(1, 2)), ValueError),        # not contiguous
    (lambda x: (1.5, x), TypeError),                       # seed not an int
    (lambda x: (1 << 64, x), ValueError),                  # seed too wide
    (lambda x: (1, x[:0]), ValueError),                    # empty
    (lambda x: (1, x.to("meta")), ValueError),             # no quiet fallback
], ids=["dtype", "ndim", "strides", "seedtype", "seedwide", "empty", "meta"])
def test_k4_wrapper_refuses(bad, exc):
    x = torch.zeros(2, 4, 6, 3, dtype=torch.uint8)
    with pytest.raises(exc):
        k4.fused_normalize_gaussian_noise(*bad(x))
    with pytest.raises(TypeError):
        k4.fused_normalize_gaussian_noise(1, x, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        k4.fused_normalize_gaussian_noise(1, x, sigma=-1.0)


def test_k4_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.uint8).view(2, 4, 6, 3)
    before = k4.LAUNCHES
    assert torch.equal(k4.fused_normalize_gaussian_noise(5, x),
                       k4.fused_normalize_gaussian_noise_plain(5, x))
    assert k4.LAUNCHES == before


# ---------------------------------------------------------------------------
# data/noise.py: the five variant-1 kinds
IMG = torch.full((64, 64, 3), 0.5)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_gaussian_v1_sigma25():
    out = port_noise.add_noise(_gen(), IMG, "gaussian", variant=1)
    delta = (out - IMG).numpy()
    assert abs(delta.std() * 255 - 25.0) < 1.5
    assert abs(delta.mean()) < 0.01
    assert out.min() >= 0 and out.max() <= 1


def test_salt_pepper_v1_fractions():
    out = port_noise.add_noise(_gen(), IMG, "salt_pepper", variant=1).numpy()
    p_eff = 1 - np.exp(-0.02 * 3)
    salt = (out == 1.0).all(axis=-1).mean()
    pepper = (out == 0.0).all(axis=-1).mean()
    assert abs(pepper - p_eff) < 0.012
    assert abs(salt - p_eff * (1 - p_eff)) < 0.012


def test_speckle_multiplicative():
    img = torch.full((64, 64, 3), 0.8)
    out = port_noise.add_noise(_gen(), img, "speckle", variant=1)
    assert abs((out - img).numpy().std() - 0.08) < 0.01


def test_poisson_v1_mean_preserving():
    out = port_noise.add_noise(_gen(), IMG, "poisson", variant=1)
    assert abs(float(out.mean()) - 0.5) < 0.01
    assert abs(float(out.std()) - np.sqrt(127.5) / 255) < 0.01


def test_uniform_v1_range():
    o1 = port_noise.add_noise(_gen(), IMG, "uniform", variant=1).numpy() - 0.5
    assert o1.min() >= 0 and o1.max() <= 25 / 255 + 1e-6
    assert abs(o1.mean() - 12.5 / 255) < 0.002


def test_unknown_kind_and_waiting_variants():
    with pytest.raises(ValueError, match="unknown noise"):
        port_noise.add_noise(_gen(), IMG, "perlin", variant=1)
    for variant in (2, 3):
        with pytest.raises(NotImplementedError, match="item 10"):
            port_noise.add_noise(_gen(), IMG, "gaussian", variant=variant)
    for name in ("blind_gaussian_batch", "poisson_v3_exact"):
        assert not hasattr(port_noise, name)


def test_kinds_equal_jax_given_the_same_draws():
    """Each kind's pure half on the very draws the JAX function makes from
    its key (re-drawn here with the same key and shapes): 1e-6."""
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    def close(got, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0)

    normal = jax.random.normal(key, img.shape, jnp.float32)
    close(port_noise.gaussian_v1_from_draws(timg, t(normal)),
          jax_noise.gaussian_v1(key, jimg))
    close(port_noise.speckle_v1_from_draws(timg, t(normal)),
          jax_noise.speckle_v1(key, jimg))
    k1, k2 = jax.random.split(key)
    pix = img.shape[:-1] + (1,)
    close(port_noise.salt_pepper_v1_from_draws(
        timg, t(jax.random.uniform(k1, pix)), t(jax.random.uniform(k2, pix))),
        jax_noise.salt_pepper_v1(key, jimg))
    counts = jax.random.poisson(key, jimg * 255.0, img.shape)
    close(port_noise.poisson_v1_from_draws(timg, t(counts).float()),
          jax_noise.poisson_v1(key, jimg))
    u = jax.random.uniform(key, img.shape, jnp.float32)
    close(port_noise.uniform_v1_from_draws(timg, t(u)),
          jax_noise.uniform_v1(key, jimg))


def test_random_noise_batch_routes_gaussian_through_k4():
    """uint8 NHWC in, float32 [-1, 1] out; the samples that drew gaussian
    equal K4's plain version on that sub-batch with the drawn seed, and the
    rest are what the kinds' functions give from the same generator."""
    rng = np.random.default_rng(5)
    batch = torch.from_numpy(rng.integers(0, 256, (16, 8, 8, 3),
                                          dtype=np.uint8))
    out, kinds = port_noise.random_noise_batch(_gen(11), batch)
    assert out.shape == batch.shape and out.dtype == torch.float32
    assert out.min() >= -1 and out.max() <= 1
    assert len(kinds) == 16 and set(kinds) <= set(range(5))
    assert len(set(kinds)) > 1
    # replay the generator
    g = _gen(11)
    draws = torch.randint(0, 1 << 62, (17,), generator=g).tolist()
    assert kinds == [d % 5 for d in draws[:16]]
    rows = [i for i, k in enumerate(kinds) if k == 0]
    assert rows, "seed 11 draws at least one gaussian sample"
    want = k4.fused_normalize_gaussian_noise_plain(
        draws[16], batch[rows].contiguous(), 25.0, torch.float32)
    assert torch.equal(out[rows], want)
    for k, name in enumerate(port_noise.NOISE_TYPES[1:], start=1):
        rows = [i for i, kk in enumerate(kinds) if kk == k]
        if rows:
            sub = batch[rows].float() / 255.0
            want = port_noise.add_noise(g, sub, name) * 2.0 - 1.0
            assert torch.equal(out[rows], want), name
    # types=("gaussian",): every sample through K4, as one sub-batch
    out, kinds = port_noise.random_noise_batch(_gen(2), batch,
                                               types=("gaussian",))
    seed = torch.randint(0, 1 << 62, (17,), generator=_gen(2)).tolist()[16]
    assert kinds == [0] * 16
    assert torch.equal(out, k4.fused_normalize_gaussian_noise_plain(
        seed, batch, 25.0, torch.float32))
    with pytest.raises(ValueError):
        port_noise.random_noise_batch(_gen(), batch.float())
    with pytest.raises(NotImplementedError):
        port_noise.random_noise_batch(_gen(), batch, variant=2)


def test_random_noise_batch_kind_mix_matches_jax_rate():
    """Both packages draw the kind uniformly over the five: each kind's
    share over many samples is 1/5 within 3 standard errors (n = 2000 →
    ±0.027), as the JAX function's is."""
    batch = torch.zeros((2000, 1, 1, 3), dtype=torch.uint8)
    _, kinds = port_noise.random_noise_batch(_gen(0), batch)
    share = np.bincount(kinds, minlength=5) / 2000
    jidx = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2000,), 0, 5))
    jshare = np.bincount(jidx, minlength=5) / 2000
    assert np.abs(share - 0.2).max() < 0.027
    assert np.abs(jshare - 0.2).max() < 0.027
