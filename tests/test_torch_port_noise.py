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
  both sides are given the same draws; ``random_noise_batch``: one
  ``noise_batch`` on kinds and a seed drawn on the device, read nowhere.
* ``ops/cuda/noise.py::noise_batch`` (the whole input stage in one launch;
  its plain version here): each kind equal to its ``*_from_draws`` function
  on the stream's draws, the gaussian samples equal to the gaussian-only
  entry, the clean target the trainer's normalisation, and the Poisson
  inversion table against ``scipy.stats.poisson`` and JAX's ``poisson_v1``.
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
from torch_port_threads import _one_torch_thread  # noqa: F401

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
    before = k4.LAUNCHES, k4.GAUSSIAN_LAUNCHES
    assert torch.equal(k4.fused_normalize_gaussian_noise(5, x),
                       k4.fused_normalize_gaussian_noise_plain(5, x))
    assert (k4.LAUNCHES, k4.GAUSSIAN_LAUNCHES) == before


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
    # variants 2 and 3 run (tests/test_torch_port_families.py and
    # tests/test_torch_port_train_families.py hold their distributions);
    # a fourth variant is unknown
    for variant in (2, 3):
        assert port_noise.add_noise(_gen(), IMG, "gaussian",
                                    variant=variant).shape == IMG.shape
    with pytest.raises(ValueError, match="unknown noise variant"):
        port_noise.add_noise(_gen(), IMG, "gaussian", variant=4)
    assert hasattr(port_noise, "blind_gaussian_batch")
    # the renderer's variant-3 poisson with the per-image scale: vals
    # exactly JAX's, and the image equal to JAX's function given JAX's
    # counts (the port's torch.poisson draw replaced by them)
    from unittest import mock

    img = (np.random.default_rng(5).integers(0, 7, (6, 5, 3)) * 9
           / 255.0).astype(np.float32)
    vals = jax_noise.v3_poisson_vals(img)
    assert vals == 8.0  # 7 unique values
    assert port_noise.v3_poisson_vals(torch.from_numpy(img)) == vals
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_noise.poisson_v3_exact(key, img))
    counts = torch.from_numpy(np.asarray(
        jax.random.poisson(key, jnp.asarray(img) * vals, img.shape),
        np.float32))
    seen = []

    def jax_counts(lam, generator=None):
        seen.append(lam)
        return counts

    with mock.patch.object(port_noise.torch, "poisson", jax_counts):
        got = port_noise.poisson_v3_exact(_gen(), torch.from_numpy(img))
    assert torch.equal(seen[0], torch.from_numpy(img) * vals)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_variant1_parameters_are_defined_once():
    """The kernel module holds the variant's parameters, kind codes and
    ``*_from_draws`` functions and imports nothing of the data layer above
    it; ``data/noise.py`` uses those very objects, so one edit changes the
    kernel, its plain version and the generator-driven kinds together."""
    import inspect

    src = inspect.getsource(k4)
    assert "celebrity_image_denoiser_tpu_torch.data" not in src
    assert port_noise.NOISE_TYPES == tuple(k4.KIND_CODES)
    for kind in port_noise.NOISE_TYPES:
        fn = f"{kind}_v1_from_draws"
        assert getattr(port_noise, fn) is getattr(k4, fn)
    defaults = {
        port_noise.gaussian_v1: {"sigma": k4.GAUSSIAN_SIGMA},
        port_noise.salt_pepper_v1: {"salt_prob": k4.SALT_PROB,
                                    "pepper_prob": k4.PEPPER_PROB},
        port_noise.speckle_v1: {"sigma": k4.SPECKLE_SIGMA},
        port_noise.uniform_v1: {"high": k4.UNIFORM_HIGH},
    }
    for fn, want in defaults.items():
        params = inspect.signature(fn).parameters
        assert {k: params[k].default for k in want} == want
    batch = torch.zeros(2, 4, 4, 3, dtype=torch.uint8)
    noisy, _, _ = port_noise.random_noise_batch(_gen(), batch, variant=3)
    assert noisy.shape == batch.shape
    with pytest.raises(ValueError, match="unknown noise variant"):
        port_noise.random_noise_batch(_gen(), batch, variant=4)


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


def _replay(seed, n, types=5):
    """The kinds and the stream's seed ``random_noise_batch`` draws from a
    generator seeded ``seed``, for a batch of ``n``."""
    g = _gen(seed)
    kinds = torch.randint(0, types, (n,), generator=g)
    return kinds, torch.randint(0, 1 << 62, (1,), generator=g)


def test_random_noise_batch_is_one_noise_batch_launch():
    """uint8 NHWC in; the noisy batch and the clean target, float32 in
    [-1, 1], and the kinds, an int64 tensor on the batch's device, out: the
    kinds and seed drawn from the generator feed one ``noise_batch`` (its
    plain version here; on the card its one launch).  A sample that drew
    gaussian equals the gaussian-only entry at its indices; the clean
    target is the trainer's ``clean.to(float32) / 255.0 * 2.0 - 1.0``."""
    rng = np.random.default_rng(5)
    batch = torch.from_numpy(rng.integers(0, 256, (16, 8, 8, 3),
                                          dtype=np.uint8))
    noisy, clean, kinds = port_noise.random_noise_batch(_gen(11), batch)
    assert noisy.shape == clean.shape == batch.shape
    assert noisy.dtype == clean.dtype == torch.float32
    assert noisy.min() >= -1 and noisy.max() <= 1
    assert kinds.dtype == torch.int64 and kinds.shape == (16,)
    assert len(set(kinds.tolist())) > 1
    want_kinds, seed = _replay(11, 16)
    assert torch.equal(kinds, want_kinds)
    want = k4.noise_batch_plain(want_kinds, seed, batch)
    assert torch.equal(noisy, want[0]) and torch.equal(clean, want[1])
    assert torch.equal(clean, batch.to(torch.float32) / 255.0 * 2.0 - 1.0)
    rows = (kinds == 0).nonzero().flatten().tolist()
    assert rows, "seed 11 draws at least one gaussian sample"
    per = batch[0].numel()
    for r in rows:
        assert torch.equal(noisy[r], k4.fused_normalize_gaussian_noise_plain(
            int(seed), batch[r:r + 1].contiguous(), 25.0, torch.float32,
            _index_offset=r * per)[0])
    # types=("gaussian",): every sample the gaussian-only stream
    noisy, _, kinds = port_noise.random_noise_batch(_gen(2), batch,
                                                    types=("gaussian",))
    assert kinds.tolist() == [0] * 16
    assert torch.equal(noisy, k4.fused_normalize_gaussian_noise_plain(
        int(_replay(2, 16, 1)[1]), batch, 25.0, torch.float32))
    with pytest.raises(ValueError):
        port_noise.random_noise_batch(_gen(), batch.float())
    # variant 2: the same draws into the same one call, its kinds
    noisy, clean, kinds = port_noise.random_noise_batch(_gen(11), batch,
                                                        variant=2)
    want = k4.noise_batch_plain(want_kinds, seed, batch, variant=2)
    assert torch.equal(kinds, want_kinds)
    assert torch.equal(noisy, want[0]) and torch.equal(clean, want[1])
    with pytest.raises(ValueError, match="unknown noise"):
        port_noise.random_noise_batch(_gen(), batch, types=("perlin",))
    with pytest.raises(ValueError, match="unknown output domain"):
        port_noise.random_noise_batch(_gen(), batch, domain="01")


def test_input_stage_reads_nothing_back_to_the_host():
    """Nothing on the on-the-fly path brings a value to the host: no
    ``.tolist()``, ``.item()``, ``.cpu()`` or ``int(`` of a tensor in
    ``random_noise_batch``, ``noise_batch`` or its plain version."""
    import inspect

    for fn in (port_noise.random_noise_batch, k4.noise_batch,
               k4.noise_batch_plain, k4.uniform_bits, k4.poisson_counts,
               k4.x01):
        src = inspect.getsource(fn)
        for bad in (".tolist(", ".item(", ".cpu(", "int(seed", "float(seed",
                    ".numpy("):
            assert bad not in src, (fn.__name__, bad)


def test_random_noise_batch_kind_mix_matches_jax_rate():
    """Both packages draw the kind uniformly over the five: each kind's
    share over many samples is 1/5 within 3 standard errors (n = 2000 →
    ±0.027), as the JAX function's is."""
    batch = torch.zeros((2000, 1, 1, 3), dtype=torch.uint8)
    _, _, kinds = port_noise.random_noise_batch(_gen(0), batch)
    share = np.bincount(kinds.numpy(), minlength=5) / 2000
    jidx = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2000,), 0, 5))
    jshare = np.bincount(jidx, minlength=5) / 2000
    assert np.abs(share - 0.2).max() < 0.027
    assert np.abs(jshare - 0.2).max() < 0.027


# ---------------------------------------------------------------------------
# noise_batch, the whole input stage, on the CPU (its plain version)
@pytest.mark.parametrize("kind", ["gaussian", "salt_pepper", "speckle",
                                  "poisson", "uniform"])
def test_noise_batch_kinds_equal_the_from_draws_functions(kind):
    """A batch of one kind equals that kind's ``*_from_draws`` function (the
    ones held against JAX above) fed with the stream's draws, taken here
    from ``uniform_bits`` (the gaussian-only entry's stream, the seed a
    Python int), then mapped with ``·2 − 1``; gaussian equals the
    gaussian-only entry."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, 256, (2, 7, 9, 3), dtype=np.uint8))
    seed = 0x1234_5678_9ABC
    kinds = torch.full((2,), k4.KIND_CODES[kind])
    noisy, clean = k4.noise_batch(kinds, torch.tensor([seed]), x)
    a, b = (w.reshape(x.shape) for w in k4.uniform_bits(seed, x.numel(),
                                                        "cpu"))
    img = x.float() / 255.0

    def u24(w):
        return (w >> 8).float() * 2.0 ** -24

    if kind == "gaussian":
        want = k4.fused_normalize_gaussian_noise_plain(seed, x, 25.0,
                                                       torch.float32)
    else:
        if kind == "salt_pepper":
            n01 = port_noise.salt_pepper_v1_from_draws(img, u24(a[..., :1]),
                                                       u24(b[..., :1]))
        elif kind == "speckle":
            n01 = port_noise.speckle_v1_from_draws(
                img, k4.normals_from_bits(a, b))
        elif kind == "uniform":
            n01 = port_noise.uniform_v1_from_draws(img, u24(a))
        else:
            n01 = port_noise.poisson_v1_from_draws(
                img, k4.poisson_counts(x, a).float())
        want = n01 * 2.0 - 1.0
    assert torch.equal(noisy, want)
    assert torch.equal(clean, img * 2.0 - 1.0)


POISSON_LAMBDAS = [0, 1, 5, 30, 128, 255]


@pytest.mark.parametrize("lam", POISSON_LAMBDAS)
def test_poisson_table_is_the_poisson_distribution(lam):
    """The inversion table: P(count ≤ k) equals scipy's Poisson CDF to
    2⁻³² for every k < 255; 200,000 counts drawn through the stream pass a
    chi-square test against ``scipy.stats.poisson`` (p > 1e-3) and a
    two-sample chi-square test against JAX's ``poisson_v1`` at the same λ;
    counts beyond 254 lumped (the output saturates at 255)."""
    from scipy import stats

    keys, table, _ = k4.poisson_tables("cpu")
    t = (keys.view(256, 256)[lam] - (lam << 32)).double()
    cdf = stats.poisson.cdf(np.arange(255), lam)
    assert np.abs((t[:255].numpy() + 1) / 2.0 ** 32 - cdf).max() \
        <= 2.0 ** -32 + 1e-12
    n = 200_000
    x = torch.full((1, 1, n, 1), lam, dtype=torch.uint8)
    a, _ = k4.uniform_bits(99 + lam, n, "cpu")
    counts = k4.poisson_counts(x, a.view(x.shape)).flatten().numpy()
    # bins: each count with an expectation of at least 20, the tails lumped
    pmf = np.diff(np.concatenate([[0.0], cdf, [1.0]]))
    edges, acc = [0], 0.0
    for k in range(255):
        acc += pmf[k]
        if acc * n >= 20 and (1 - cdf[k]) * n >= 20:
            edges.append(k + 1)
            acc = 0.0
    edges.append(256)
    obs = np.histogram(counts, bins=edges)[0]
    exp = np.array([pmf[lo:hi].sum() for lo, hi in zip(edges, edges[1:])]) * n
    if len(obs) > 1:
        assert stats.chisquare(obs, exp).pvalue > 1e-3
    else:
        assert obs[0] == n  # lambda 0: always 0
    jc = np.asarray(jax_noise.poisson_v1(jax.random.PRNGKey(lam),
                                         jnp.full((n,), lam / 255.0,
                                                  jnp.float32)) * 255.0)
    jc = np.rint(jc).astype(np.int64)
    jobs = np.histogram(np.minimum(jc, 255), bins=edges)[0]
    if len(obs) > 1:
        assert stats.chi2_contingency(np.stack([obs, jobs])).pvalue > 1e-3
    else:
        assert jobs[0] == n


def test_noise_batch_refuses():
    x = torch.zeros(2, 4, 6, 3, dtype=torch.uint8)
    kinds, seed = torch.zeros(2, dtype=torch.int64), torch.tensor([1])
    for bad in ((kinds.int(), seed, x), (kinds[:1], seed, x),
                (kinds, seed.int(), x), (kinds, torch.tensor([1, 2]), x),
                (kinds, seed, x.float()), (kinds, seed, x[0]),
                (kinds, seed, x.transpose(1, 2)),
                (kinds.to("meta"), seed.to("meta"), x.to("meta"))):
        with pytest.raises((TypeError, ValueError)):
            k4.noise_batch(*bad)
    with pytest.raises(ValueError, match="unknown noise kind"):
        k4.noise_batch(kinds, seed, x, types=("perlin",))
    with pytest.raises(ValueError):
        k4.noise_batch(kinds, seed, x, types=("gaussian",) * 9)
    with pytest.raises(ValueError, match="unknown noise variant"):
        k4.noise_batch(kinds, seed, x, variant=0)
    with pytest.raises(ValueError, match="unknown output domain"):
        k4.noise_batch(kinds, seed, x, domain="01")
    before = k4.LAUNCHES, k4.GAUSSIAN_LAUNCHES
    k4.noise_batch(kinds, seed, x)
    k4.noise_batch(kinds, seed, x, variant=3, domain="unit")
    # the plain version launches nothing
    assert (k4.LAUNCHES, k4.GAUSSIAN_LAUNCHES) == before
