"""The dncnn, esrgan and srgan families of the port against the JAX package,
on the CPU.

The same inputs, drawn from a seed with numpy, go through the JAX function
and the port's; each test states its tolerance.

* Building blocks: ``prelu`` and the pixel shuffle bit-equal to JAX's;
  ``ops/resize.py`` within 1e-5 of ``jax.image.resize`` (bicubic and
  lanczos3, antialias on and off, up and down, odd sizes); the Pillow
  bicubic of ``data/imageio.py`` equal to Pillow's; ``pad``/``crop``
  against JAX's and ``get_padding``.
* Generators (small: dncnn depth 5, esrgan 2 blocks; JAX's init with
  BatchNorm parameters and statistics drawn from a seed) through the
  port's converter: the autograd and plain routes within 1e-5·max|ref| of
  ``model.apply(train=False)``; the plain route, whose BatchNorm is folded,
  within 5e-6·max|ref| of the autograd route; on the shipped weights at
  32², every route within 1e-4 absolute of JAX.
* The converter: the shipped npz loads all or nothing, a reference-layout
  ``.pth`` (written here with ``torch.save``) loads strictly and serves
  the same, a BatchNorm scale never lands in a PReLU.
* int8 given JAX's calibration recipe (as numpy): per-conv amaxes within
  1e-6 of the layer's largest, int8 weights and scales bit-identical given
  the same amaxes, the replay ≥ 60 dB of JAX's run op by op; esrgan's
  trunk-float rung floats exactly conv calls 3, 5, …, 15.
* Recipes: ``srgan_calibration_batch`` as ``tests/test_quant.py:637``
  holds JAX's; variant-2 noise by its distribution against JAX's.
* Serving: the port's ``ServeState(device="cpu")`` against the JAX
  ``ServeState`` on the same PNGs (float within 1 count on ≥ 99.5% of
  pixels, at the family's output size), each family labelled int8 with its
  rung, the shipped weights above 70% of their recorded margins in float
  and int8, a degraded srgan below its battery floor, and tiled requests
  equal to untiled ones.
"""

import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu.ckpt import load_checkpoint
from celebrity_image_denoiser_tpu.data import noise as jnoise
from celebrity_image_denoiser_tpu.data import synthetic as jsynthetic
from celebrity_image_denoiser_tpu.ops import activations as jact
from celebrity_image_denoiser_tpu.ops import padding as jpadding
from celebrity_image_denoiser_tpu.ops import pixelshuffle as jpixelshuffle
from celebrity_image_denoiser_tpu.ops import quant as jquant
from celebrity_image_denoiser_tpu.serve import quality as jquality
from celebrity_image_denoiser_tpu.serve.handlers import ServeState as JaxState
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.core.config import (
    default_weights_dir,
    get_padding,
)
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data import noise as port_noise
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    srgan_calibration_batch,
)
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.models.dncnn import DnCNN
from celebrity_image_denoiser_tpu_torch.models.esrgan import ESRGANGenerator
from celebrity_image_denoiser_tpu_torch.models.srgan import (
    SRGANGenerator,
    pixel_shuffle_nhwc,
)
from celebrity_image_denoiser_tpu_torch.ops import quant
from celebrity_image_denoiser_tpu_torch.ops.activations import prelu
from celebrity_image_denoiser_tpu_torch.ops.norm import fold_batch_norm
from celebrity_image_denoiser_tpu_torch.ops.padding import (
    crop_nhwc,
    pad_nhwc,
)
from celebrity_image_denoiser_tpu_torch.ops.resize import resize
from celebrity_image_denoiser_tpu_torch.serve import quality
from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

WEIGHTS = default_weights_dir()
FAMILIES = ("dncnn", "esrgan", "srgan")
# a 0.7 × the margin recorded in weights/<family>/meta.json
FLOORS = {"dncnn": 0.7 * 7.66, "esrgan": 0.7 * 6.81}
SRGAN_BATTERY_FLOOR = 0.7 * 2.291


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """This module's PyTorch CPU ops on one thread.  The suite runs six
    workers on the machine's cores; with a thread per core each of the many
    small parallel regions here waited for threads the other workers had
    preempted (the srgan int8 battery: 0.5 s alone, 90 s in the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# building blocks
def test_prelu_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 7, 3)).astype(np.float32)
    x[0, 0, :3, 0] = [0.0, -0.0, 1e-38]
    for alpha in (np.float32([0.25]), np.float32([-0.73])):
        want = np.asarray(jact.prelu(jnp.asarray(x), jnp.asarray(alpha)))
        got = prelu(_t(x), _t(alpha)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_equals_jax_bit_for_bit(r):
    x = np.random.default_rng(r).normal(size=(2, 5, 3, 4 * r * r)).astype(
        np.float32)
    want = np.asarray(jpixelshuffle.pixel_shuffle(jnp.asarray(x), r))
    got = _nhwc(torch.nn.PixelShuffle(r)(_nchw(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pixel_shuffle_nhwc(_t(x), r).numpy(), want)


@pytest.mark.parametrize("method", ["bicubic", "lanczos3"])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("src, dst", [((17, 23), (40, 9)), ((64, 64), (16, 16)),
                                      ((33, 31), (97, 130)), ((13, 15), (4, 29))])
def test_resize_matches_jax(method, antialias, src, dst):
    """Within 1e-5 of ``jax.image.resize`` on [0, 1] images (the weights are
    computed in float32 as JAX computes them; measured ≤ 1.4e-6)."""
    x = np.random.default_rng(1).random((2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + dst + (3,),
                                       method, antialias=antialias))
    got = resize(_t(x), dst, method, antialias).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_of_integer_images_rounds_and_clips_like_jax():
    from celebrity_image_denoiser_tpu.ops.resize import resize as jresize

    x = np.random.default_rng(2).integers(0, 256, (19, 11, 3), np.uint8)
    want = np.asarray(jresize(jnp.asarray(x), (7, 30)))
    got = resize(_t(x), (7, 30)).numpy()
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("src, dst", [((256, 256), (64, 64)),
                                      ((64, 64), (256, 256)),
                                      ((97, 130), (37, 300)), ((17, 5), (80, 3))])
def test_pillow_bicubic_is_pillows(src, dst):
    """``resize_bicubic_u8`` equals ``Image.resize(size, BICUBIC)`` bit for
    bit (the card machine has no Pillow)."""
    from PIL import Image

    img = np.random.default_rng(3).integers(0, 256, src + (3,), np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BICUBIC))
    np.testing.assert_array_equal(imageio.resize_bicubic_u8(img, dst), want)


@pytest.mark.parametrize("hw", [(97, 130), (64, 64), (13, 6), (1, 1)])
@pytest.mark.parametrize("divisor, scale", [(4, 1), (4, 4)])
def test_pad_and_crop_round_trip_get_padding(hw, divisor, scale):
    h, w = hw
    x = np.random.default_rng(4).random((1, h, w, 3)).astype(np.float32)
    padding = get_padding((w, h), divisor, scale)
    padded = pad_nhwc(_t(x), padding)
    assert padded.shape[1] % (divisor * scale) == 0
    assert padded.shape[2] % (divisor * scale) == 0
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jpadding.pad_nhwc(jnp.asarray(x), padding)))
    np.testing.assert_array_equal(crop_nhwc(padded, padding, (w, h)).numpy(),
                                  x)


# ---------------------------------------------------------------------------
# generators
def _small(family):
    """(JAX model, port model) of the family at a small size."""
    if family == "dncnn":
        return jax_models.DnCNN(depth=5), DnCNN(depth=5)
    if family == "esrgan":
        return (jax_models.ESRGANGenerator(num_residuals=2),
                ESRGANGenerator(num_residuals=2))
    return jax_models.SRGANGenerator(4), SRGANGenerator(4)


def _jax_init(jm, seed):
    """JAX's init, with every BatchNorm's scale, bias and running
    statistics drawn from ``seed`` (so that folding them matters)."""
    p, s = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def bn(path, a):
        leaf = str(path[-1].key)
        a = np.asarray(a, np.float32)
        if leaf == "scale":
            return (1 + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "mean" or (leaf == "bias" and a.ndim == 1):
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return a
    p = jax.tree_util.tree_map_with_path(bn, p)
    s = jax.tree_util.tree_map_with_path(bn, s)
    return p, s


def _input(family, n=2, h=21, w=19, seed=5):
    x = np.random.default_rng(seed).random((n, h, w, 3)).astype(np.float32)
    return x * 2 - 1 if family == "srgan" else x


@pytest.fixture(scope="module")
def small_models():
    out = {}
    for family in FAMILIES:
        jm, pm = _small(family)
        p, s = _jax_init(jm, 11)
        convert.load_jax_trees(pm, p, s)
        out[family] = (jm, p, s, pm.eval())
    return out


def _routes(pm, x):
    with torch.inference_mode():
        return {r: _nhwc(pm(_nchw(x), route=r))
                for r in ("autograd", "plain", "kernel")}


@pytest.mark.parametrize("family", FAMILIES)
def test_generator_routes_match_jax(small_models, family):
    """autograd and plain within 1e-5·max|ref| of ``model.apply``; on the
    CPU the kernel route is the plain route."""
    jm, p, s, pm = small_models[family]
    x = _input(family)
    want = np.asarray(jm.apply(p, s, jnp.asarray(x), train=False)[0])
    got = _routes(pm, x)
    scale = np.abs(want).max()
    for route in ("autograd", "plain"):
        assert got[route].shape == want.shape
        err = np.abs(got[route] - want).max()
        assert err <= 1e-5 * scale, (route, err / scale)
    np.testing.assert_array_equal(got["kernel"], got["plain"])


@pytest.mark.parametrize("family", FAMILIES)
def test_folded_batch_norm_matches_the_unfolded_route(small_models, family):
    """The plain route (BatchNorm folded into each conv) within
    5e-6·max|ref| of the autograd route (conv, then BatchNorm).  Measured:
    dncnn 1.0e-6, esrgan 1.5e-6, srgan 2.3e-6 (its twelve folded convs each
    round w·g once where conv then BatchNorm round twice, and its tanh
    output peaks at 0.30 here)."""
    pm = small_models[family][3]
    got = _routes(pm, _input(family, seed=6))
    scale = np.abs(got["autograd"]).max()
    assert np.abs(got["plain"] - got["autograd"]).max() <= 5e-6 * scale


def test_fold_batch_norm_is_conv_then_batch_norm():
    rng = np.random.default_rng(7)
    conv = torch.nn.Conv2d(8, 6, 3, padding=1)
    bn = torch.nn.BatchNorm2d(6).eval()
    with torch.no_grad():
        bn.weight.copy_(_t(rng.normal(1, 0.2, 6).astype(np.float32)))
        bn.bias.copy_(_t(rng.normal(0, 0.2, 6).astype(np.float32)))
        bn.running_mean.copy_(_t(rng.normal(0, 0.2, 6).astype(np.float32)))
        bn.running_var.copy_(_t(rng.uniform(0.3, 2, 6).astype(np.float32)))
    x = _t(rng.normal(size=(2, 8, 9, 7)).astype(np.float32))
    w, b = fold_batch_norm(conv.weight, conv.bias, bn)
    with torch.no_grad():
        want = bn(conv(x))
        got = torch.nn.functional.conv2d(x, w, b, padding=1)
        w0, b0 = fold_batch_norm(conv.weight, None, bn)
        got0 = torch.nn.functional.conv2d(x, w0, b0, padding=1)
        want0 = bn(torch.nn.functional.conv2d(x, conv.weight, None,
                                              padding=1))
    assert (got - want).abs().max() <= 2e-6 * want.abs().max()
    assert (got0 - want0).abs().max() <= 2e-6 * want0.abs().max()


def test_kernel_route_needs_eval_mode_and_refuses_grad():
    m = DnCNN(depth=3)
    x = torch.rand(1, 3, 8, 8)
    with pytest.raises(ValueError, match="eval"):
        m(x)
    m.eval()
    with pytest.raises(RuntimeError, match="no backward"):
        m(x, route="plain")
    m(x, route="autograd").sum().backward()  # the trainer's route
    with pytest.raises(ValueError, match="unknown route"):
        m(x, route="xla")


def test_srgan_scale_must_be_a_power_of_two():
    for bad in (0, 3, 6):
        with pytest.raises(ValueError, match="power of two"):
            SRGANGenerator(bad)
    assert len(SRGANGenerator(2).upscale) == 3


def test_registry_builds_the_ported_families_and_names_the_waiting_ones():
    """Every generator of the JAX registry is ported (the cGAN's Keras and
    torch backends last); of the discriminators, srgan's and esrgan's wait
    for their trainers."""
    from celebrity_image_denoiser_tpu.models import registry as jregistry
    from celebrity_image_denoiser_tpu_torch.models.cgan import (
        CGANKerasDiscriminator,
        CGANKerasGenerator,
    )
    from celebrity_image_denoiser_tpu_torch.models.cgan_torch import (
        CGANTorchGenerator,
    )

    assert list(registry.GENERATORS) == list(jregistry.GENERATORS)
    assert isinstance(registry.build_generator("dncnn", depth=3), DnCNN)
    assert isinstance(registry.build_generator("cgan"), CGANKerasGenerator)
    assert isinstance(registry.build_generator("cgan_torch"),
                      CGANTorchGenerator)
    with pytest.raises(ValueError, match="Unknown model"):
        registry.build_generator("vdsr")
    assert set(registry.DISCRIMINATORS) == {"denoise", "cgan"}
    assert isinstance(registry.build_discriminator("cgan"),
                      CGANKerasDiscriminator)
    with pytest.raises(ValueError):
        registry.build_discriminator("esrgan")


# ---------------------------------------------------------------------------
# the shipped weights
@pytest.fixture(scope="module")
def shipped():
    """family -> (JAX model, params, state, port model loaded by the
    converter from the same npz)."""
    out = {}
    for family, jm in (("dncnn", jax_models.DnCNN()),
                       ("esrgan", jax_models.ESRGANGenerator(8)),
                       ("srgan", jax_models.SRGANGenerator(4))):
        sections, _ = load_checkpoint(os.path.join(WEIGHTS, family))
        p, s = sections["generator"], sections.get("generator_state", {})
        pm = registry.build_generator(family)
        pm.load_state_dict({**pm.state_dict(), **convert.load_npz_state_dict(
            os.path.join(WEIGHTS, family), module=pm)}, strict=True)
        out[family] = (jm, p, s, pm.eval())
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_shipped_weights_match_jax(shipped, family):
    """At 32² (srgan: 32² LR), every route within 1e-4 absolute of JAX."""
    jm, p, s, pm = shipped[family]
    x = _input(family, n=1, h=32, w=32, seed=8)
    want = np.asarray(jm.apply(p, s, jnp.asarray(x), train=False)[0])
    for route, got in _routes(pm, x).items():
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4, (route,
                                                   np.abs(got - want).max())


# ---------------------------------------------------------------------------
# the converter
def test_shipped_npz_loads_all_or_nothing(tmp_path):
    """Each shipped npz loads whole; with one array missing the server keeps
    that family's random init (and says so), and the others still load."""
    st = ServeState(device="cpu")
    assert st.healthz()["weights_loaded"] == ["cgan", "denoise", "dncnn",
                                              "esrgan", "srgan"]
    src = os.path.join(WEIGHTS, "esrgan", "arrays.npz")
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files
                  if k != "generator.residuals.3.block.2.alpha"}
    (tmp_path / "esrgan").mkdir()
    np.savez(tmp_path / "esrgan" / "arrays.npz", **arrays)
    for family in ("dncnn", "srgan"):
        (tmp_path / family).symlink_to(os.path.abspath(
            os.path.join(WEIGHTS, family)))
    fresh = ServeState(weights_dir="/nonexistent-weights", device="cpu")
    part = ServeState(weights_dir=str(tmp_path), device="cpu")
    assert part.healthz()["weights_loaded"] == ["dncnn", "srgan"]
    for k, v in part.models["esrgan"].state_dict().items():
        assert torch.equal(v, fresh.models["esrgan"].state_dict()[k]), k


def test_batch_norm_scale_never_lands_in_a_prelu():
    m = ESRGANGenerator(num_residuals=1)
    with pytest.raises(ValueError, match="PReLU"):
        convert.jax_params_to_state_dict(
            {"residuals.0.block.2.scale": np.ones(1, np.float32)}, module=m)
    with pytest.raises(ValueError, match="BatchNorm2d"):
        convert.jax_params_to_state_dict(
            {"residuals.0.block.1.alpha": np.ones(64, np.float32)}, module=m)
    with pytest.raises(ValueError, match="module"):  # placed only by type
        convert.jax_params_to_state_dict(
            {"initial.1.alpha": np.ones(1, np.float32)})
    # and the way back: PReLU weight -> alpha, BatchNorm weight -> scale
    params, state = convert.state_dict_to_jax_params(m.state_dict(), module=m)
    assert set(params["initial"]["1"]) == {"alpha"}
    assert set(params["residuals"]["0"]["block"]["2"]) == {"alpha"}
    assert set(params["residuals"]["0"]["block"]["1"]) == {"scale", "bias"}
    assert set(state["residuals"]["0"]["block"]["4"]) == {"mean", "var"}


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_pth_loads_strictly_and_serves_the_same(tmp_path, shipped,
                                                          family):
    """A reference-layout ``.pth`` (``initial.1.weight``,
    ``residuals.N.block.2.weight``, …, with BatchNorm's
    ``num_batches_tracked``), written with ``torch.save`` from the JAX
    params, loads strictly, and the server loads it under the reference's
    file name and serves what the npz serves."""
    _, p, s, pm = shipped[family]
    sd = convert.jax_params_to_state_dict(p, module=pm)
    sd.update(convert.jax_params_to_state_dict(s, module=pm))
    sd.update({k: torch.tensor(1000) for k in pm.state_dict()
               if k.endswith("num_batches_tracked")})
    if family == "esrgan":
        assert "initial.1.weight" in sd and "residuals.3.block.2.weight" in sd
    name = {"dncnn": "dncnn_epoch_499.pth", "esrgan": "esrgan_epoch_500.pth",
            "srgan": "srgan_epoch_499.pth"}[family]
    torch.save({"generator": sd}, tmp_path / name)
    m = registry.build_generator(family)
    m.load_state_dict(convert.load_pth_state_dict(str(tmp_path / name)),
                      strict=True)
    st = ServeState(weights_dir=str(tmp_path), device="cpu")
    assert family in st.healthz()["weights_loaded"]
    img = np.random.default_rng(9).integers(0, 256, (20, 24, 3), np.uint8)
    ref = ServeState(device="cpu")
    np.testing.assert_array_equal(st.denoise_image(img, family),
                                  ref.denoise_image(img, family))


# ---------------------------------------------------------------------------
# int8 given JAX's calibration batch
def _jax_amaxes(jm, p, s, calib):
    tap = jquant._Calibrate()

    def cal(x):
        tap.taps.clear()
        with jquant._mode(tap):
            jm.apply(p, s, x, train=False)
        return [t[0] for t in tap.taps]

    return [np.asarray(a) for a in jax.jit(cal)(jnp.asarray(calib))]


def _jax_calibration(family):
    """JAX's calibration recipe of the family, as numpy, at 32² (srgan: its
    mix of clean LR, noisy LR and noisy crops at 8² LR), so that one
    compile of JAX's synthetic corpus (8 images of 32²) serves all three."""
    if family == "srgan":
        batch = jnp.concatenate([
            jsynthetic.lr_batch(0, 8, 8)[:2],
            jsynthetic.lr_batch(20, 8, 8, sigma=0.05)[:1],
            jsynthetic.calibration_batch(True, size=32)[:1, :8, :8]])
    else:
        sigmas = (0.05, 0.12, 0.25) if family == "esrgan" else (0.12,)
        batch = jsynthetic.calibration_batch(False, size=32, sigmas=sigmas)
    return np.asarray(batch)


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_quantization_matches_jax_given_its_calibration_batch(
        small_models, family):
    """Per conv: the port's amaxes within 1e-6 of the layer's largest (the
    float convs before it sum in another order); given JAX's amaxes, the
    int8 weights and scales bit-identical; and the replay from those
    entries against JAX's replay run op by op (no jit): ≥ 60 dB (measured
    81–95 dB).  The gap is the float ops before each int8 conv (the 9×9
    head, the BatchNorms, the bias corrections' absence aside): an input a
    float ulp apart can round to the next s8 step, and the step spreads
    through the convs after it."""
    jm, p, s, pm = small_models[family]
    calib = _jax_calibration(family)
    want = _jax_amaxes(jm, p, s, calib)
    taps = quant.calibrate(pm, _t(calib))
    assert len(taps) == len(want)
    jentries, pentries = [], []
    for (amax, weight, transposed, _), wamax in zip(taps, want):
        assert np.abs(amax.numpy() - wamax).max() <= 1e-6 * wamax.max()
        if quant.default_skip_policy(weight):
            jentries.append(None)
            pentries.append(None)
            continue
        kernel = jnp.asarray(weight.permute(2, 3, 1, 0).numpy())  # HWIO
        s_c = jquant.act_scale(jnp.asarray(wamax))
        jw, jscale = jquant.quantize_weight(kernel * s_c.reshape(1, 1, -1, 1))
        pw, pscale, ps_c = quant.fold_and_quantize(
            weight, quant.act_scale(_t(wamax)), transposed)
        np.testing.assert_array_equal(pw.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(jw))
        np.testing.assert_array_equal(_bits(pscale), _bits(jscale))
        np.testing.assert_array_equal(_bits(ps_c), _bits(s_c))
        jentries.append((jw, jscale, s_c))
        pentries.append((pw, pscale, ps_c))
    x = calib[:1]
    with jquant._mode(jquant._Int8Apply(list(jentries))):
        yj = np.asarray(jm.apply(p, s, jnp.asarray(x), train=False)[0])
    yt = quant.QuantizedApply(pm, pentries)(_t(x)).numpy()
    rng = 2.0 if family == "srgan" else 1.0
    mse = max(float(np.mean((yt - yj) ** 2)), 1e-20)
    assert 10 * np.log10(rng ** 2 / mse) >= 60.0


def test_esrgan_trunk_float_rung_floats_the_trunk_convs():
    m = ESRGANGenerator(8).eval()
    x = _t(_input("esrgan", n=1, h=16, w=16))
    q = quant.quantize_apply(m, x, skip=quant.make_indexed_skip(
        quant.ESRGAN_TRUNK_CALLS))
    floated = [i for i, e in enumerate(q.entries) if e is None]
    assert floated == [0, 3, 5, 7, 9, 11, 13, 15, 17]
    assert quant.ESRGAN_TRUNK_CALLS == jquant.ESRGAN_TRUNK_CALLS
    jskip = jquant.make_indexed_skip(jquant.ESRGAN_TRUNK_CALLS)
    pskip = quant.make_indexed_skip(quant.ESRGAN_TRUNK_CALLS)
    for w in (np.zeros((9, 9, 3, 64)),) + (np.zeros((3, 3, 64, 64)),) * 16:
        assert pskip(_t(w).permute(3, 2, 0, 1)) == jskip(jnp.asarray(w))


# ---------------------------------------------------------------------------
# recipes
def test_srgan_calibration_batch_recipe():
    """As ``tests/test_quant.py:637`` holds JAX's."""
    batch = srgan_calibration_batch()
    assert batch.shape == (16, 64, 64, 3)
    assert batch.min() >= -1.0 and batch.max() <= 1.0
    assert batch.min() < -0.2
    torch.testing.assert_close(batch, srgan_calibration_batch(), rtol=0,
                               atol=0)


def _stats(out, img):
    d = out - img
    return {"mean": float(d.mean()), "std": float(d.std()),
            "salt": float(np.mean(out == 1.0)),
            "pepper": float(np.mean(out == 0.0))}


@pytest.mark.parametrize("kind", ["gaussian", "salt_pepper", "speckle",
                                  "poisson", "uniform"])
def test_variant2_noise_distribution_matches_jax(kind):
    """On a constant 0.5 image of 3·10⁵ values: the mean and σ of the noise
    and the salt and pepper rates within 4 standard errors of JAX's (and
    σ within 1.5%)."""
    img = np.full((100, 100, 30), 0.5, np.float32)
    got = port_noise.add_noise(torch.Generator().manual_seed(1), _t(img),
                               kind, variant=2).numpy()
    want = np.asarray(jnoise.add_noise(jax.random.PRNGKey(1),
                                       jnp.asarray(img), kind, variant=2))
    a, b = _stats(got, img), _stats(want, img)
    n = img.size
    se = max(b["std"], 1e-3) / np.sqrt(n)
    assert abs(a["mean"] - b["mean"]) <= 4 * np.sqrt(2) * se, (a, b)
    assert abs(a["std"] - b["std"]) <= 0.015 * max(b["std"], 1e-3), (a, b)
    for k in ("salt", "pepper"):
        p = max(b[k], 1e-6)
        assert abs(a[k] - b[k]) <= 4 * np.sqrt(2 * p * (1 - p) / n) + 1e-6


def test_random_noise_batch01_draws_a_kind_per_sample():
    clean = torch.full((6, 8, 8, 3), 0.5)
    gen = torch.Generator().manual_seed(3)
    out = port_noise.random_noise_batch01(gen, clean, variant=2)
    assert out.shape == clean.shape and out.min() >= 0 and out.max() <= 1
    again = port_noise.random_noise_batch01(
        torch.Generator().manual_seed(3), clean, variant=2)
    assert torch.equal(out, again)
    with pytest.raises(NotImplementedError):  # variant 3 waits
        port_noise.random_noise_batch01(gen, clean, variant=3)


# ---------------------------------------------------------------------------
# serving, against the JAX server
def _png(img):
    return imageio.encode_png(img)


def _served(st, family, img):
    r = st.enhance(family, _png(img), "image/png", include_graph=False)
    assert set(r) == {"denoised_image_base64", "noise_graph_base64",
                      "backend"}
    return quality._decode_b64_png(r["denoised_image_base64"])


@pytest.fixture(scope="module")
def states():
    return {"jax": JaxState(quantize=None), "float": ServeState(device="cpu"),
            "int8": ServeState(device="cpu", quantize="int8")}


def _out_size(family, h, w):
    if family == "srgan":
        pl_, pt_, pr_, pb_ = get_padding((w, h), 4, 4)
        return (4 * (h + pt_ + pb_), 4 * (w + pl_ + pr_), 3)
    return (h, w, 3)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("hw", [(37, 29), (64, 64)])
def test_float_serving_matches_the_jax_server(states, family, hw):
    """The same PNG to both servers: the port's pixels within 1 count of the
    JAX server's on ≥ 99.5% of pixels, at the family's output size (srgan
    4× its padded input, dncnn uncropped, esrgan cropped at the padding
    offsets as the JAX server crops it)."""
    h, w = hw
    rng = np.random.default_rng(h * w)
    img = np.clip(rng.normal(128, 50, (h, w, 3)), 0, 255).astype(np.uint8)
    a = _served(states["jax"], family, img).astype(int)
    b = _served(states["float"], family, img).astype(int)
    assert a.shape == b.shape == _out_size(family, h, w)
    d = np.abs(a - b)
    assert d.max() <= 1 and np.mean(d == 0) >= 0.995, (d.max(),
                                                       np.mean(d == 0))
    assert states["float"].last_compute_backend() == "float"


def test_esrgan_keeps_the_jax_crop_quirk(states):
    """esrgan runs unpadded and is then cropped at the padding offsets: a
    37×29 input (padding 1, 1, 2, 2 on the JAX server's arithmetic) comes
    back shifted by one pixel with a zero column and row at the far edges,
    as the JAX server (Pillow's crop) answers."""
    img = np.full((29, 37, 3), 200, np.uint8)
    out = _served(states["float"], "esrgan", img)
    assert out.shape == (29, 37, 3)
    assert not out[-1].any() and not out[:, -1].any()
    assert out[-2, :-1].all() and out[:-1, -2].all()


@pytest.mark.parametrize("family", FAMILIES)
def test_analysis_figure_views_the_input_as_the_jax_server(states, family):
    """With the figure asked for, its input view is the JAX server's: the
    input (dncnn), the input cropped as the output is (esrgan), or the input
    upscaled to the ×4 output by Pillow's bicubic (srgan)."""
    from PIL import Image

    img = np.random.default_rng(11).integers(0, 256, (13, 18, 3), np.uint8)
    st = states["float"]
    r = st.enhance(family, _png(img), "image/png", include_graph=True)
    assert r["noise_graph_base64"]
    out = quality._decode_b64_png(r["denoised_image_base64"])
    view = st._input_view(img, family, out.shape[:2])
    assert view.shape == out.shape
    pil = Image.fromarray(img)
    if family == "srgan":  # 13x18 pads to 16x32: the view is 64x128
        want = pil.resize((out.shape[1], out.shape[0]), Image.BICUBIC)
    elif family == "esrgan":  # padding (1, 1, 1, 2)
        want = pil.crop((1, 1, 19, 14))
    else:
        want = pil
    np.testing.assert_array_equal(view, np.asarray(want))


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_serving_labels_each_family_with_its_rung(states, family):
    """Each family's ladder is built at its first request (as the JAX
    server builds it) and lands on the generic rung above 40 dB."""
    st = states["int8"]
    img = np.random.default_rng(10).integers(0, 256, (24, 20, 3), np.uint8)
    out = _served(st, family, img)
    assert st.int8_rung[family] == "int8-generic"
    assert st.int8_gate_db[family] >= 40.0
    assert out.shape == _out_size(family, 24, 20)
    assert st.last_compute_backend() == "int8"
    assert st.healthz()["int8_rungs"][family] == "int8-generic"


@pytest.mark.parametrize("quantize", ["float", "int8"])
@pytest.mark.parametrize("family", ["dncnn", "esrgan"])
def test_shipped_weights_clear_their_floor(states, family, quantize):
    floor = quality.recorded_gate_floor(WEIGHTS, family, default=1.0)
    assert floor == pytest.approx(FLOORS[family])
    gain = quality.fixture_gain_db(states[quantize], family)
    assert gain >= floor, (gain, floor)


@pytest.mark.parametrize("quantize", ["float", "int8"])
def test_shipped_srgan_beats_bicubic(states, quantize):
    """The battery gain ≥ 70% of the recorded battery_gain_db, and the
    fixture gain > 0, as ``tests/test_serve.py:369`` holds JAX's."""
    floor = quality.recorded_gate_floor(WEIGHTS, "srgan", default=0.0,
                                        key="battery_gain_db")
    assert floor == pytest.approx(SRGAN_BATTERY_FLOOR)
    assert quality.srgan_battery_gain_db(states[quantize]) >= floor
    assert quality.fixture_gain_db(states[quantize], "srgan") > 0


def test_srgan_fixture_gain_matches_the_jax_server(states):
    """The srgan fixture (Pillow's bicubic LR, the bicubic baseline) through
    both servers within 0.05 dB."""
    a = quality.fixture_gain_db(states["float"], "srgan")
    b = jquality.fixture_gain_db(states["jax"], "srgan")
    assert abs(a - b) <= 0.05, (a, b)


def test_degraded_srgan_fails_the_battery_gate(tmp_path):
    """As ``tests/test_serve.py:398``: every array of the shipped srgan
    generator perturbed by N(0, 0.15·std), the original meta kept."""
    from celebrity_image_denoiser_tpu.ckpt import save_checkpoint

    src = os.path.join(WEIGHTS, "srgan")
    sections, meta = load_checkpoint(src)
    rng = np.random.default_rng(0)

    def degrade(x):
        x = np.asarray(x)
        return x + rng.normal(0, 0.15 * float(np.std(x) + 1e-6),
                              x.shape).astype(x.dtype)

    sections = dict(sections)
    sections["generator"] = jax.tree.map(degrade, sections["generator"])
    save_checkpoint(str(tmp_path / "weights" / "srgan"), sections, meta=meta)
    st = ServeState(weights_dir=str(tmp_path / "weights"), device="cpu")
    assert "srgan" in st.healthz()["weights_loaded"]
    floor = quality.recorded_gate_floor(str(tmp_path / "weights"), "srgan",
                                        default=0.0, key="battery_gain_db")
    assert floor > 1.0
    assert quality.srgan_battery_gain_db(st) < floor


def test_tall_srgan_request_routes_through_the_tiler_and_matches():
    """A 96×32 LR request over a 64-row threshold is tiled (×4 output, the
    crop at 4× the input offsets) and equals the untiled forward, as
    ``tests/test_serve.py:602`` holds JAX's."""
    tiled = ServeState(device="cpu", tile_threshold_rows=64)
    full = ServeState(device="cpu")
    img = np.random.default_rng(5).integers(0, 256, (96, 32, 3), np.uint8)
    a = _served(tiled, "srgan", img)
    assert tiled.last_compute_backend() == "float+tiled"
    b = _served(full, "srgan", img)
    assert full.last_compute_backend() == "float"
    assert a.shape == b.shape == (384, 128, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("family", ["dncnn", "esrgan"])
def test_odd_sized_big_inputs_tile_where_the_jax_server_fails(states,
                                                              family):
    """dncnn and esrgan run unpadded: a 97×30 input over a 64-row threshold
    tiles with any extent (no pooling), equal to the untiled forward.  The
    JAX tiler wants extents divisible by 4, so the JAX server answers 500
    (``ROADMAP.md`` queue 3)."""
    from celebrity_image_denoiser_tpu.serve.handlers import EnhanceError

    img = np.random.default_rng(6).integers(0, 256, (97, 30, 3), np.uint8)
    tiled = ServeState(device="cpu", tile_threshold_rows=64)
    a = _served(tiled, family, img)
    assert tiled.last_compute_backend() == "float+tiled"
    b = _served(ServeState(device="cpu"), family, img)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    jst = states["jax"]
    jst.tile_threshold_rows = 64
    try:
        with pytest.raises(EnhanceError) as e:
            jst.enhance(family, _png(img), "image/png", include_graph=False)
    finally:
        jst.tile_threshold_rows = 2048
    assert e.value.status == 500
