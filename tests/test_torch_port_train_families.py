"""The port's trainers of the dncnn, esrgan, cgan and srgan families against
the JAX package, on the CPU.

Small shapes: batch 2 at 32² (srgan: 8² LR → 32² HR, ×4), dncnn at depth 5
and esrgan with 2 residual blocks at full width, the cgan Keras generator
and its discriminator at ``input_hw=(32, 32)``.  The same numpy inputs from
a seed go through the JAX function and its counterpart in the port; the JAX
weights are the shared starting point, carried into the port's modules by
``ckpt/convert.py``; srgan's content loss runs on the shipped
``weights/perceptual`` tower in both packages.  Tolerances are stated where
they are used.  One f32 step per family, as
``test_torch_port_train.py::test_one_f32_train_step_matches_jax``: losses
rtol 1e-4, BatchNorm running statistics atol 1e-4, parameters atol 2.5e-4
(at step 1 Adam moves each weight by about ±lr whatever its gradient's
size, so a weight whose true gradient is zero lands up to 2·lr apart).  So
the gradients are held through the optimisers' first moments, leaf by leaf
(``_assert_moments_match``).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu import metrics as jax_metrics
from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu.ckpt import checkpoint as jax_ckpt
from celebrity_image_denoiser_tpu.core import prng
from celebrity_image_denoiser_tpu.core.config import TrainConfig as JaxConfig
from celebrity_image_denoiser_tpu.data import noise as jax_noise
from celebrity_image_denoiser_tpu.train import gan_trainer as jax_trainer
from celebrity_image_denoiser_tpu.train import losses as jax_losses
from celebrity_image_denoiser_tpu.train import optim as jax_optim
from celebrity_image_denoiser_tpu.utils import tree as jax_tree
from celebrity_image_denoiser_tpu_torch import metrics as port_metrics
from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as port_ckpt
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
from celebrity_image_denoiser_tpu_torch.core.config import TrainConfig
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data import noise as port_noise
from celebrity_image_denoiser_tpu_torch.data.synthetic import synth_clean_batch
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.models.vgg import VGGFeatures
from celebrity_image_denoiser_tpu_torch.ops.cuda import noise as k4
from celebrity_image_denoiser_tpu_torch.ops.resize import resize
from celebrity_image_denoiser_tpu_torch.train import gan_trainer
from celebrity_image_denoiser_tpu_torch.train import losses as port_losses
from celebrity_image_denoiser_tpu_torch.train import optim as port_optim
from torch_port_threads import _one_torch_thread  # noqa: F401

FAMILIES = ("dncnn", "esrgan", "cgan", "srgan")
HW = 32
LR_HW = 8  # srgan's input, ×4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in jax_tree.flatten(tree).items()}


# the small configurations of each family: (JAX generator, JAX
# discriminator or None), (port generator, port discriminator or None)
def _jax_models(family):
    if family == "dncnn":
        return jax_models.DnCNN(depth=5), None
    if family == "esrgan":
        return (jax_models.ESRGANGenerator(num_residuals=2),
                jax_models.build_discriminator("esrgan", input_hw=(HW, HW)))
    if family == "cgan":
        return (jax_models.build_generator("cgan"),
                jax_models.build_discriminator("cgan", input_hw=(HW, HW)))
    return (jax_models.build_generator("srgan", scale_factor=4),
            jax_models.build_discriminator("srgan"))


def _port_models(family):
    if family == "dncnn":
        return registry.build_generator("dncnn", depth=5), None
    if family == "esrgan":
        return (registry.build_generator("esrgan", num_residuals=2),
                registry.build_discriminator("esrgan", input_hw=(HW, HW)))
    if family == "cgan":
        return (registry.build_generator("cgan"),
                registry.build_discriminator("cgan", input_hw=(HW, HW)))
    return (registry.build_generator("srgan", scale_factor=4),
            registry.build_discriminator("srgan"))


@pytest.fixture(scope="module")
def jax_nets():
    """family → (g, d, g_params, g_state, d_params, d_state): the JAX
    modules and, as the shared starting point, weights drawn by the port's
    initialisers from a seed and carried into JAX trees (JAX's own
    initialisers run op by op here, 18 s for the four families).  The
    running statistics are perturbed so that a statistic carried the wrong
    way shows."""
    out = {}
    for i, family in enumerate(FAMILIES):
        g, d = _jax_models(family)
        torch.manual_seed(10 + i)
        trees = []
        for m in _port_models(family):
            if m is None:
                trees += [{}, {}]
                continue
            for name, buf in m.named_buffers():
                if name.endswith("running_mean"):
                    buf.uniform_(-0.1, 0.1)
                elif name.endswith("running_var"):
                    buf.uniform_(0.5, 1.5)
            trees += convert.state_dict_to_jax_params(m.state_dict(),
                                                      module=m)
        out[family] = (g, d, *trees)
    return out


@pytest.fixture(scope="module")
def towers():
    """The shipped perceptual tower in both packages: (JAX, port)
    ``PerceptualDistance``.  The port's through ``default()``
    (``from_npz``); the JAX one from the same npz's ``vgg`` section (its
    ``from_npz`` also runs the tower's initialiser, op by op)."""
    sections, _ = jax_ckpt.load_checkpoint(
        os.path.join(os.path.dirname(__file__), "..", "weights",
                     "perceptual"))
    jpd = jax_metrics.PerceptualDistance(sections["vgg"], {},
                                         input_domain="unit")
    ppd = port_metrics.PerceptualDistance.default()
    assert jpd.pretrained and ppd.pretrained
    assert ppd.input_domain == "unit"
    return jpd, ppd


def _jax_perceptual(jpd):
    return jax_losses.make_vgg_perceptual(jpd.net, jpd.params, jpd.state,
                                          to_unit=True)


def _port_perceptual(ppd):
    return port_losses.make_vgg_perceptual(ppd.net, to_unit=True)


def _port_nets(family, jax_nets):
    _, _, gp, gs, dp, ds = jax_nets[family]
    pg, pd = _port_models(family)
    convert.load_jax_trees(pg, gp, gs)
    if pd is not None:
        convert.load_jax_trees(pd, dp, ds)
    return pg, pd


def _batch(family, seed=0, n=2):
    """(noisy, clean) float32 NHWC in the family's domain (srgan: the noisy
    side is the LR batch)."""
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0, 1, (n, HW, HW, 3)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.1, clean.shape), 0, 1)
    if family == "srgan":
        noisy = noisy.reshape(n, LR_HW, 4, LR_HW, 4, 3).mean(axis=(2, 4))
    if family not in ("esrgan", "dncnn"):
        noisy, clean = noisy * 2 - 1, clean * 2 - 1
    return noisy.astype(np.float32), clean.astype(np.float32)


def _assert_module_matches_trees(module, params, state, atol, what):
    got_p, got_s = convert.state_dict_to_jax_params(module.state_dict(),
                                                    module=module)
    got_p, got_s = jax_tree.flatten(got_p), jax_tree.flatten(got_s)
    want_p, want_s = _np_tree(params), _np_tree(state)
    assert set(got_p) == set(want_p) and set(got_s) == set(want_s), what
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k], v, atol=atol[0], rtol=0,
                                   err_msg=f"{what} param {k}")
    for k, v in want_s.items():
        np.testing.assert_allclose(got_s[k], v, atol=atol[1], rtol=0,
                                   err_msg=f"{what} state {k}")


def _port_moments(module, state):
    """An optimiser state's first moments as a flat JAX-named tree."""
    return jax_tree.flatten(convert.state_dict_to_jax_params(
        state.mu, module=module)[0])


def _assert_moments_close(got, want, what, rel=1e-4):
    """Two first-moment trees, leaf by leaf, within ``rel``·max|leaf| of
    ``want``.  After one step a first moment is (1 − b1)·grad, so this
    holds the gradients, which the parameters' bound cannot see (at Adam's
    first step every weight moves by about ±lr).  A bias feeding a
    train-mode BatchNorm has a gradient of exactly 0, so both sides hold
    rounding there (up to 2e-6 of the module's largest first moment,
    measured): the bound has a floor of 1e-5 of it."""
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    assert set(got) == set(want), what
    floor = 1e-5 * max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(
            np.asarray(got[k], np.float64), v,
            atol=max(rel * np.abs(v).max(), floor), rtol=0,
            err_msg=f"{what} mu {k}")


def _assert_moments_match(module, state, jax_state, what, rel=1e-4):
    """The port's first moments after a step against JAX's."""
    _assert_moments_close(_port_moments(module, state),
                          _np_tree(jax_state.mu), what, rel)


# ---------------------------------------------------------------------------
# modules
def test_adam_keras_matches_jax():
    """Three Keras-Adam steps with a changing lr: parameters and both
    moments within 1e-6 of ``optim.adam_keras``; the state is (step, mu,
    nu), as torch Adam's."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((3, 5)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    jinit, jupdate = jax_optim.adam_keras()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jinit(jp)
    pinit, pupdate = port_optim.adam_keras()
    pp = {k: _t(v) for k, v in p0.items()}
    pstate = pinit(pp)
    for i, lr in enumerate((1e-2, 1e-3, 5e-3)):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** (i - 1)
                     ).astype(np.float32) for k, v in p0.items()}
        jp, jstate = jupdate({k: jnp.asarray(v) for k, v in grads.items()},
                             jstate, jp, lr)
        pupdate({k: _t(v) for k, v in grads.items()}, pstate, pp, lr)
    assert pstate.step == int(jstate.step) == 3
    for k in p0:
        for got, want in ((pp[k], jp[k]), (pstate.mu[k], jstate.mu[k]),
                          (pstate.nu[k], jstate.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)
    # not torch's convention: eps on the uncorrected sqrt(v)
    tp = {k: _t(v) for k, v in p0.items()}
    tinit, tupdate = port_optim.adam()
    tupdate({k: torch.full_like(v, 1e-6) for k, v in tp.items()}, tinit(tp),
            tp, 1e-2)
    kp = {k: _t(v) for k, v in p0.items()}
    kinit, kupdate = port_optim.adam_keras()
    kupdate({k: torch.full_like(v, 1e-6) for k, v in kp.items()}, kinit(kp),
            kp, 1e-2)
    assert not torch.allclose(tp["w"], kp["w"], atol=1e-4, rtol=0)


def test_ssim_tf_matches_jax():
    """``tf.image.ssim`` convention (11×11 Gaussian σ 1.5, biased
    covariance): per-image values within 1e-5 of ``ssim_tf``, NHWC and HWC,
    at max_val 2 (cgan's) and 1."""
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (3, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    for mv in (2.0, 1.0):
        np.testing.assert_allclose(
            port_metrics.ssim_tf(_t(a), _t(b), max_val=mv).numpy(),
            np.asarray(jax_metrics.ssim_tf(jnp.asarray(a), jnp.asarray(b),
                                           max_val=mv)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        float(port_metrics.ssim_tf(_t(a[0]), _t(b[0]))),
        float(jax_metrics.ssim_tf(jnp.asarray(a[0]), jnp.asarray(b[0]))),
        atol=1e-5)
    assert float(port_metrics.ssim_tf(_t(a), _t(a)).min()) == \
        pytest.approx(1.0, abs=1e-6)


def test_vgg_and_perceptual_distance_match_jax_on_the_shipped_tower(towers):
    """The shipped tower (``PerceptualDistance.from_npz``, section ``vgg``)
    in both packages: the relu3_3 features and the distance within 1e-5
    relative; children indexed as torchvision's; a random tower carried
    across to JAX, in the ImageNet domain, alike."""
    jpd, ppd = towers
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (2, 24, 28, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    jf, _ = jpd.net.apply(jpd.params, jpd.state, jnp.asarray(a))
    with torch.no_grad():
        pf = ppd.net(_t(a).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    jf = np.asarray(jf)
    assert pf.shape == jf.shape == (2, 6, 7, 256)
    assert np.abs(pf.numpy() - jf).max() <= 1e-5 * np.abs(jf).max()
    want = np.asarray(jpd(jnp.asarray(a), jnp.asarray(b)))
    got = ppd(_t(a), _t(b)).numpy()
    assert got.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert [type(m).__name__ for m in ppd.net.slice][:5] == [
        "Conv2d", "ReLU", "Conv2d", "ReLU", "MaxPool2d"]
    assert not any(p.requires_grad for p in ppd.net.parameters())
    # a random tower in the ImageNet domain, carried across to JAX
    net = VGGFeatures(generator=torch.Generator().manual_seed(3))
    jr = jax_metrics.PerceptualDistance(
        convert.state_dict_to_jax_params(net.state_dict())[0], {})
    pr = port_metrics.PerceptualDistance(net)
    np.testing.assert_allclose(pr(_t(a), _t(b)).numpy(),
                               np.asarray(jr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=0)
    assert not port_metrics.PerceptualDistance(seed=3).pretrained


def test_perceptual_tower_from_a_torchvision_pth(tmp_path):
    """A torchvision-style ``.pth`` (``features.<i>.weight``, beyond index
    15 too) loads into the tower; a file that gives none of its weights is
    refused by name (``perceptual.py:103-108``)."""
    net = VGGFeatures(generator=torch.Generator().manual_seed(1))
    sd = {"features." + k[len("slice."):]: v
          for k, v in net.state_dict().items()}
    sd["features.17.weight"] = torch.zeros(512, 256, 3, 3)
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    pd = port_metrics.PerceptualDistance.from_torchvision_pth(path)
    assert pd.pretrained and pd.input_domain == "imagenet"
    for k, v in net.state_dict().items():
        assert torch.equal(pd.net.state_dict()[k], v), k
    bad = str(tmp_path / "other.pth")
    torch.save({"state_dict": {"fc.weight": torch.zeros(2, 2)}}, bad)
    with pytest.raises(ValueError, match="no VGG feature weights"):
        port_metrics.PerceptualDistance.from_torchvision_pth(bad)
    with pytest.raises(ValueError, match="input_domain"):
        port_metrics.PerceptualDistance(input_domain="lab")


def test_make_vgg_perceptual_matches_jax_in_f32(towers):
    """srgan's content loss on the shipped tower (``to_unit``): the value
    within 1e-5 relative and its gradient for the generated side within
    1e-4 of the largest, against ``jax.value_and_grad`` of
    ``make_vgg_perceptual``; the tower takes no gradient."""
    jpd, ppd = towers
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
    jloss = _jax_perceptual(jpd)
    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(x), jnp.asarray(y))
    loss = _port_perceptual(ppd)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    v = loss(xt, _t(y).permute(0, 3, 1, 2))
    (g,) = torch.autograd.grad(v, [xt])
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(g.permute(0, 2, 3, 1).numpy() - jg).max() \
        <= 1e-4 * np.abs(jg).max()
    assert not any(p.requires_grad for p in loss.parameters())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("family", ["srgan", "esrgan"])
def test_discriminators_match_jax(jax_nets, family, train):
    """SRGAN's (probabilities, BatchNorm) and ESRGAN's (logits, its Linear
    over NCHW-flattened features) discriminators given JAX's parameters:
    outputs within 1e-5 of the largest, and in train mode the running
    statistics after the forward within 1e-5; JAX trees → module → JAX
    trees is exact."""
    _, d, _, _, dp, ds = jax_nets[family]
    _, pd = _port_nets(family, jax_nets)
    _assert_module_matches_trees(pd, dp, ds, (0, 0), "D")
    pd.train(train)
    _, clean = _batch(family, seed=1)
    want, new_state = d.apply(dp, ds, jnp.asarray(clean), train=train)
    with torch.no_grad():
        got = pd(_t(clean).permute(0, 3, 1, 2))
    want = np.asarray(want)
    assert got.shape == want.shape == (2,)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * max(
        1.0, np.abs(want).max())
    _assert_module_matches_trees(pd, dp, new_state if train else ds,
                                 (0, 1e-5), "D")
    if family == "esrgan":
        assert pd.fc.weight.shape == (1, 512 * 2 * 2)
        assert tuple(dp["fc"]["kernel"].shape) == (512 * 2 * 2, 1)


def test_srgan_lr_downscale_matches_jax():
    """The on-the-fly LR input: ``ops/resize.py`` bicubic with antialias on
    the noisy HR batch, within 1e-5 of ``jax.image.resize(..., "bicubic")``
    (which antialiases a downscale)."""
    rng = np.random.default_rng(7)
    noisy01 = rng.uniform(0, 1, (2, HW, HW, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(noisy01),
                                       (2, LR_HW, LR_HW, 3), "bicubic"))
    got = resize(_t(noisy01), (LR_HW, LR_HW), "bicubic").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# noise: variants 2 and 3 and the blind-σ Gaussian on the input stage
def _u24(w):
    return (w >> 8).float() * 2.0 ** -24


@pytest.mark.parametrize("domain", ["tanh", "unit"])
@pytest.mark.parametrize("variant", [2, 3])
def test_noise_batch_variants_equal_the_from_draws_functions(variant,
                                                             domain):
    """Each kind of ``noise_batch``'s plain version in variants 2 and 3
    equals that kind's ``*_from_draws`` function of ``data/noise.py`` fed
    with the stream's draws (exact): salt & pepper per element from the
    element's own words, poisson from the variant's table (λ = x·256/255,
    counts to 256); then the domain's map."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 256, (2, 7, 9, 3), dtype=np.uint8))
    seed = 0x5678_9ABC_DEF0
    a, b = (w.reshape(x.shape) for w in k4.uniform_bits(seed, x.numel(),
                                                        "cpu"))
    img = x.float() / 255.0
    normal = k4.normals_from_bits(a, b)
    g_img = x.float() * (1.0 / 255.0)  # the gaussian-only entry's x01
    counts = k4.poisson_counts(x, a, variant)
    v2 = variant == 2
    want = {
        "gaussian": (port_noise.gaussian_v1_from_draws(g_img, normal) if v2
                     else port_noise.gaussian_v3_from_draws(g_img, normal)),
        "salt_pepper": (k4.salt_pepper_v2_from_draws if v2
                        else port_noise.salt_pepper_v3_from_draws)(
                            img, _u24(a), _u24(b)),
        "speckle": (port_noise.speckle_v1_from_draws(img, normal) if v2
                    else port_noise.speckle_v3_from_draws(img, normal)),
        "poisson": k4.poisson_v2_from_draws(img, counts),
        "uniform": (k4.uniform_v2_from_draws(img, _u24(a)) if v2
                    else port_noise.uniform_v3_from_draws(img, _u24(a))),
    }
    for kind, w in want.items():
        kinds = torch.full((2,), k4.KIND_CODES[kind])
        noisy, clean = k4.noise_batch(kinds, torch.tensor([seed]), x,
                                      variant=variant, domain=domain)
        if domain == "tanh":
            w, w_clean = w * 2.0 - 1.0, img * 2.0 - 1.0
        else:
            w_clean = img
        assert torch.equal(noisy, w), kind
        assert torch.equal(clean, w_clean)
    assert counts.max() == 256 or (x < 200).all()


@pytest.mark.parametrize("variant", [2, 3])
def test_from_draws_equal_jax_given_the_same_draws(variant):
    """The variant-2 and -3 kinds' pure halves on the very draws the JAX
    functions make from their keys (re-drawn with the same keys and
    shapes): 1e-6."""
    key = jax.random.PRNGKey(variant)
    rng = np.random.default_rng(variant)
    img = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)

    def t(a):
        return torch.from_numpy(np.array(a))

    def close(got, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0)

    fns = jax_noise._VARIANTS[variant]
    normal = t(jax.random.normal(key, img.shape, jnp.float32))
    u = t(jax.random.uniform(key, img.shape, jnp.float32))
    k1, k2 = jax.random.split(key)
    u1, u2 = (t(jax.random.uniform(k, img.shape)) for k in (k1, k2))
    counts = t(jax.random.poisson(key, jimg * 256.0, img.shape)).float()
    if variant == 2:
        close(port_noise.gaussian_v1_from_draws(timg, normal),
              fns["gaussian"](key, jimg))
        close(k4.salt_pepper_v2_from_draws(timg, u1, u2),
              fns["salt_pepper"](key, jimg))
        close(port_noise.speckle_v1_from_draws(timg, normal),
              fns["speckle"](key, jimg))
        close(k4.uniform_v2_from_draws(timg, u), fns["uniform"](key, jimg))
    else:
        close(port_noise.gaussian_v3_from_draws(timg, normal),
              fns["gaussian"](key, jimg))
        close(port_noise.salt_pepper_v3_from_draws(timg, u1, u2),
              fns["salt_pepper"](key, jimg))
        close(port_noise.speckle_v3_from_draws(timg, normal),
              fns["speckle"](key, jimg))
        close(port_noise.uniform_v3_from_draws(timg, u),
              fns["uniform"](key, jimg))
    close(k4.poisson_v2_from_draws(timg, counts), fns["poisson"](key, jimg))


def _stats(out, img):
    d = out - img
    return {"mean": float(d.mean()), "std": float(d.std()),
            "salt": float(np.mean(out == 1.0)),
            "pepper": float(np.mean(out == 0.0))}


@pytest.mark.parametrize("kind", ["gaussian", "salt_pepper", "speckle",
                                  "poisson", "uniform"])
def test_variant3_input_stage_distribution_matches_jax(kind):
    """The input stage in variant 3 on [0, 1] (``noise_batch``, esrgan's)
    over a constant image of byte 128 (98,304 values) against JAX's
    ``add_noise(variant=3)`` on the same image: the mean and σ of the noise
    within 4 standard errors and 2%, the salt and pepper rates within 4
    standard errors."""
    x = torch.full((8, 64, 64, 3), 128, dtype=torch.uint8)
    kinds = torch.full((8,), k4.KIND_CODES[kind])
    noisy, clean = k4.noise_batch(kinds, torch.tensor([99]), x, variant=3,
                                  domain="unit")
    img = clean.numpy()
    got = noisy.numpy()
    want = np.asarray(jax_noise.add_noise(jax.random.PRNGKey(9),
                                          jnp.asarray(img), kind, variant=3))
    a, b = _stats(got, img), _stats(want, img)
    n = img.size
    se = max(b["std"], 1e-3) / np.sqrt(n)
    assert abs(a["mean"] - b["mean"]) <= 4 * np.sqrt(2) * se, (a, b)
    # σ's relative standard error is about 1/sqrt(2·k), k the elements the
    # noise moves: all of them but for salt & pepper's 0.4%
    k = n * (b["salt"] + b["pepper"]) if kind == "salt_pepper" else n
    assert abs(a["std"] - b["std"]) <= max(0.02, 4 / np.sqrt(2 * k)) * max(
        b["std"], 1e-3), (a, b)
    for k in ("salt", "pepper"):
        p = max(b[k], 1e-6)
        assert abs(a[k] - b[k]) <= 4 * np.sqrt(2 * p * (1 - p) / n) + 1e-6


def test_blind_gaussian_matches_jax_by_distribution():
    """``blind_gaussian_batch`` (one launch; its plain version here) on a
    constant image of byte 128: every sample's σ within [5, 50]/255 (the
    noise's spread per sample, which clipping cannot reach at this mean),
    the stream's σ that of ``blind_sigmas``, and the σ's over 128 samples
    spread as JAX's ``blind_gaussian_batch`` spreads them (mean within 4
    standard errors of uniform's 27.5/255, Kolmogorov-Smirnov against
    JAX's σ's p > 1e-3)."""
    from scipy import stats

    n = 128
    x = torch.full((n, 32, 32, 3), 128, dtype=torch.uint8)
    gen = torch.Generator().manual_seed(5)
    seed = torch.randint(0, 1 << 62, (1,),
                         generator=torch.Generator().manual_seed(5))
    noisy, clean = port_noise.blind_gaussian_batch(gen, x)
    assert noisy.min() >= 0 and noisy.max() <= 1 and clean.max() < 1
    sig = k4.blind_sigmas(seed, n, "cpu")
    # the spread of 3072 normals: relative standard error 1.3%
    est = (noisy - clean).std(dim=(1, 2, 3))
    assert (sig >= 5 / 255).all() and (sig <= 50 / 255).all()
    np.testing.assert_allclose(est.numpy(), sig.numpy(), rtol=0.06)
    jout = np.asarray(jax_noise.blind_gaussian_batch(
        jax.random.PRNGKey(0), jnp.asarray(clean.numpy())))
    jsig = (jout - clean.numpy()).std(axis=(1, 2, 3))
    se = (45 / 255) / np.sqrt(12 * n)
    assert abs(float(sig.mean()) - 27.5 / 255) <= 4 * se
    assert stats.ks_2samp(est.numpy(), jsig).pvalue > 1e-3
    # the tanh domain is the same draws mapped
    tanh = port_noise.blind_gaussian_batch(
        torch.Generator().manual_seed(5), x, domain="tanh")[0]
    assert torch.equal(tanh, noisy * 2.0 - 1.0)


# ---------------------------------------------------------------------------
# the train step, per family, against JAX
@pytest.fixture(scope="module")
def jax_steps(jax_nets, towers):
    out = {}
    for family in FAMILIES:
        g, d = jax_nets[family][:2]
        out[family] = jax_trainer.make_train_step(
            g, d, family=family, donate=False,
            perceptual=(_jax_perceptual(towers[0]) if family == "srgan"
                        else None))
    return out


def _jax_carry(family, jax_nets, jax_steps):
    init_fn, _ = jax_steps[family]
    carry = init_fn(prng.key(2))
    _, _, gp, gs, dp, ds = jax_nets[family]
    return (gp, gs, dp, ds, carry[4], carry[5])


def _port_step(family, jax_nets, towers, **kw):
    pg, pd = _port_nets(family, jax_nets)
    init_fn, step_fn = gan_trainer.make_train_step(
        pg, pd, family=family,
        perceptual=_port_perceptual(towers[1]) if family == "srgan" else None,
        **kw)
    return pg, pd, init_fn(), step_fn


@pytest.mark.parametrize("family", FAMILIES)
def test_one_f32_train_step_matches_jax(family, jax_nets, jax_steps, towers):
    """One f32 step from the same weights and batch: losses rtol 1e-4, the
    in-step PSNR/SSIM atol 1e-3, every parameter atol 2.5e-4, the BatchNorm
    running statistics atol 1e-4 (cgan's discriminator: exactly two Keras
    updates, real then fake); dncnn has no discriminator and a d_loss of
    0.  Each optimiser's first moment, the gradient, within 1e-4 of each
    leaf's largest; srgan's generator within 5e-3, because JAX's own f32
    gradient there is the one off: against the port's float64 step
    (``compute_dtype="float64"``) the port's f32 first moments hold within
    1e-4 and JAX's do not, only within 5e-3."""
    noisy, clean = _batch(family)
    carry, ref = jax_steps[family][1](
        _jax_carry(family, jax_nets, jax_steps), jnp.asarray(noisy),
        jnp.asarray(clean), prng.key(3), 1e-4, 1e-4)
    pg, pd, opt, step_fn = _port_step(family, jax_nets, towers)
    out = step_fn(opt, _t(noisy), _t(clean), None, 1e-4, 1e-4)
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), atol=1e-3,
                                   err_msg=k)
    _assert_module_matches_trees(pg, carry[0], carry[1], (2.5e-4, 1e-4), "G")
    _assert_moments_match(pg, opt[0], carry[4], "G",
                          rel=5e-3 if family == "srgan" else 1e-4)
    if family == "srgan":
        # the float64 step decides which side's f32 gradient is off
        g64, d64 = (m.double() for m in _port_nets(family, jax_nets))
        init64, step64 = gan_trainer.make_train_step(
            g64, d64, family=family, compute_dtype="float64",
            perceptual=port_losses.make_vgg_perceptual(
                copy.deepcopy(towers[1].net).double(), to_unit=True))
        opt64 = init64()
        step64(opt64, _t(noisy).double(), _t(clean).double(), None, 1e-4,
               1e-4)
        ref = _port_moments(g64, opt64[0])
        _assert_moments_close(_port_moments(pg, opt[0]), ref, "G f32")
        _assert_moments_close(_np_tree(carry[4].mu), ref, "G JAX", 5e-3)
        with pytest.raises(AssertionError):
            _assert_moments_close(_np_tree(carry[4].mu), ref, "G JAX")
    assert opt[0].step == 1
    if pd is None:
        assert float(out["d_loss"]) == 0.0 and opt[1].step == 0
        assert not opt[1].mu
    else:
        _assert_module_matches_trees(pd, carry[2], carry[3], (2.5e-4, 1e-4),
                                     "D")
        _assert_moments_match(pd, opt[1], carry[5], "D")
        assert opt[1].step == 1


@pytest.mark.parametrize("family", ["esrgan", "srgan"])
def test_generator_sees_the_updated_discriminator(family, jax_nets, towers):
    """The alternating steps' adversarial gradient, which the default
    ``adv_weight`` of 1e-3 leaves below the first-moment bound for esrgan:
    at ``adv_weight`` 1 and a D learning rate of 1e-2, G's first moment
    holds the BCE term's gradient through the *updated* discriminator
    (through the pre-update one it differs).  Same bounds as the one-step
    test."""
    g, d = jax_nets[family][:2]
    kw = {"perceptual": _jax_perceptual(towers[0])} if family == "srgan" \
        else {}
    init_fn, jstep = jax_trainer.make_train_step(
        g, d, family=family, donate=False, adv_weight=1.0, **kw)
    carry = init_fn(prng.key(2))
    _, _, gp, gs, dp, ds = jax_nets[family]
    noisy, clean = _batch(family, seed=4)
    carry, ref = jstep((gp, gs, dp, ds, carry[4], carry[5]),
                       jnp.asarray(noisy), jnp.asarray(clean), prng.key(3),
                       1e-4, 1e-2)
    pg, pd, opt, step_fn = _port_step(family, jax_nets, towers,
                                      adv_weight=1.0)
    out = step_fn(opt, _t(noisy), _t(clean), None, 1e-4, 1e-2)
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    _assert_moments_match(pg, opt[0], carry[4], "G",
                          rel=5e-3 if family == "srgan" else 1e-4)
    _assert_moments_match(pd, opt[1], carry[5], "D")


def test_cgan_three_chained_steps_match_jax(jax_nets, jax_steps, towers):
    """Keras Adam's step count enters its step size: three chained cgan
    steps on three batches, losses rtol 1e-4 at each and every parameter,
    running statistic and first moment after the third within the one-step
    tolerances."""
    carry = _jax_carry("cgan", jax_nets, jax_steps)
    pg, pd, opt, step_fn = _port_step("cgan", jax_nets, towers)
    for i in range(3):
        noisy, clean = _batch("cgan", seed=10 + i)
        carry, ref = jax_steps["cgan"][1](carry, jnp.asarray(noisy),
                                          jnp.asarray(clean), prng.key(i),
                                          1e-4, 1e-4)
        out = step_fn(opt, _t(noisy), _t(clean), None, 1e-4, 1e-4)
        for k in ("g_loss", "d_loss"):
            np.testing.assert_allclose(float(out[k]), float(ref[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert opt[0].step == opt[1].step == int(carry[4].step) == 3
    _assert_module_matches_trees(pg, carry[0], carry[1], (2.5e-4, 1e-4), "G")
    _assert_module_matches_trees(pd, carry[2], carry[3], (2.5e-4, 1e-4), "D")
    _assert_moments_match(pg, opt[0], carry[4], "G")
    _assert_moments_match(pd, opt[1], carry[5], "D")


@pytest.mark.parametrize("family", FAMILIES)
def test_on_the_fly_step_trains_in_the_family_domain(family, jax_nets,
                                                     towers):
    """A uint8 clean batch in, the noise from the generator: the generator
    sees the family's domain and shape (dncnn and esrgan [0, 1], cgan
    [-1, 1], srgan the 8² LR batch in [-1, 1]), the losses are finite, and
    the kinds drawn are reported except for dncnn's blind σ."""
    seen = []
    pg, pd, opt, step_fn = _port_step(
        family, jax_nets, towers, on_the_fly_noise=True,
        noise_variant={"srgan": 2, "cgan": 2, "esrgan": 3}.get(family),
        sr_scale=4 if family == "srgan" else 1)
    pg.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    clean = (synth_clean_batch(torch.Generator().manual_seed(0), 2, HW)
             * 255).round().to(torch.uint8)
    m = step_fn(opt, None, clean, torch.Generator().manual_seed(1), 1e-4,
                1e-4)
    x = seen[0]
    side = LR_HW if family == "srgan" else HW
    assert tuple(x.shape) == (2, 3, side, side)
    if family in ("dncnn", "esrgan"):
        assert x.min() >= 0 and x.max() <= 1
    else:
        assert x.min() >= -1 and x.max() <= 1 and x.min() < 0
    kinds = m.pop("noise_kinds", None)
    assert (kinds is None) == (family == "dncnn")
    vals = {k: float(v) for k, v in m.items()}
    assert all(np.isfinite(v) for v in vals.values()), vals


# ---------------------------------------------------------------------------
# the loop, the CLI and checkpoints across the packages
@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    imgs = synth_clean_batch(torch.Generator().manual_seed(1), 10, HW)
    d = tmp_path_factory.mktemp("clean") / "person"
    d.mkdir()
    for i, im in enumerate((imgs * 255).round().to(torch.uint8).numpy()):
        (d / f"{i:02d}.png").write_bytes(imageio.encode_png(im))
    return d.parent


@pytest.mark.parametrize("family", FAMILIES)
def test_cli_train_each_family_on_the_cpu(family, png_dir, tmp_path):
    """``cli.train --model <family>`` for one epoch at full width (srgan ×4
    on the shipped tower): finite metrics, a ``<family>_epoch_0``
    checkpoint with the discriminator's sections (none for dncnn), and
    ``--resume`` at epoch 1."""
    args = ["--model", family, "--clean-dir", str(png_dir), "--image-size",
            str(HW), str(HW), "--batch-size", "4", "--checkpoint-dir",
            str(tmp_path / "ck"), "--device", "cpu", "--compute-dtype",
            "float32", "--graph-dir", str(tmp_path / "graphs")]
    tr = cli_train.run(args + ["--num-epochs", "1"])
    assert tr.steps == 2 and tr.family == family
    assert np.isfinite(tr.metric_history["g_loss"]).all()
    path = port_ckpt.latest_checkpoint(str(tmp_path / "ck"), f"{family}_")
    assert path.endswith(f"{family}_epoch_0")
    sections, meta = port_ckpt.load_checkpoint(path)
    assert meta["family"] == family
    assert ("discriminator" in sections) == (family != "dncnn")
    assert int(sections["g_optimizer"]["step"]) == 2
    again = cli_train.build_trainer(cli_train.build_parser().parse_args(
        args + ["--num-epochs", "2", "--resume"]))
    assert again.start_epoch == 1 and again.opt[0].step == 2


@pytest.mark.parametrize("family", ("denoise",) + FAMILIES)
def test_build_modules_builds_what_the_jax_cli_builds(family, towers):
    """``cli.train.build_modules`` (the trainer's modules, also phase 9's
    on the card): every parameter and state leaf of the generator and the
    discriminator has the shape of the one the JAX CLI builds (:258-268) at
    32² and ×4; dncnn has no discriminator; esrgan's and cgan's are sized
    for the image; srgan alone has a content loss, on the shipped tower fed
    [0, 1], equal to ``make_vgg_perceptual``'s on the same inputs."""
    g, d, perc = cli_train.build_modules(
        family, (HW, HW), sr_scale=4,
        generator=torch.Generator().manual_seed(0))
    if family == "srgan":
        jg = jax_models.build_generator("srgan", scale_factor=4)
    else:
        jg = jax_models.build_generator(family)
    jd = (None if family == "dncnn" else jax_models.build_discriminator(
        family, **({"input_hw": (HW, HW)} if family in ("esrgan", "cgan")
                   else {})))
    assert (d is None) == (jd is None)
    for port, jm in ((g, jg), (d, jd)):
        if port is None:
            continue
        want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        got = convert.state_dict_to_jax_params(port.state_dict(),
                                               module=port)
        for w, gt in zip(want, got):
            assert {k: tuple(v.shape) for k, v in
                    jax_tree.flatten(w).items()} == \
                {k: tuple(v.shape) for k, v in jax_tree.flatten(gt).items()}
    if family != "srgan":
        assert perc is None
        return
    assert g.scale_factor == 4 and perc.to_unit
    assert not any(p.requires_grad for p in perc.parameters())
    rng = np.random.default_rng(8)
    x, y = (_t(rng.uniform(-1, 1, (1, 3, HW, HW))) for _ in range(2))
    assert torch.equal(perc(x, y), _port_perceptual(towers[1])(x, y))


class _Pairs:
    def __init__(self, family, n_batches=1, seed=30):
        self.batches = [tuple(_t(a) for a in _batch(family, seed + i))
                        for i in range(n_batches)]

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoints_cross_between_the_packages(family, jax_nets, towers,
                                                tmp_path):
    """A port checkpoint of each family resumes in the JAX GANTrainer and a
    JAX one in the port's, exactly: parameters, BatchNorm state (cgan's in
    Keras' convention, srgan's and esrgan's PReLU slopes), both optimiser
    states, an absent discriminator for dncnn; both write the same keys;
    and the two trainers' ``generate`` agree from it."""
    g, d = jax_nets[family][:2]
    cfg = TrainConfig(batch_size=2, image_size=(HW, HW), num_epochs=1,
                      checkpoint_dir=str(tmp_path / "port"),
                      on_the_fly_noise=False)
    pg, pd = _port_nets(family, jax_nets)
    perc = _port_perceptual(towers[1]) if family == "srgan" else None
    tr = gan_trainer.GANTrainer(pg, pd, _Pairs(family), cfg, family=family,
                                perceptual=perc, device="cpu")
    tr.train()
    path = port_ckpt.latest_checkpoint(cfg.checkpoint_dir, f"{family}_")
    jcfg = JaxConfig(num_epochs=2, batch_size=2, image_size=(HW, HW),
                     checkpoint_dir=cfg.checkpoint_dir,
                     on_the_fly_noise=False, compute_dtype="float32")
    jperc = _jax_perceptual(towers[0]) if family == "srgan" else None
    jt = jax_trainer.GANTrainer(g, d, [], jcfg, family=family,
                                perceptual=jperc)
    assert jt.resume(path) == 1
    _assert_module_matches_trees(tr.generator, jt.carry[0], jt.carry[1],
                                 (0, 0), "G")
    if pd is None:
        assert not jt.carry[2] and int(jt.carry[5].step) == 0
    else:
        _assert_module_matches_trees(tr.discriminator, jt.carry[2],
                                     jt.carry[3], (0, 0), "D")
    assert int(jt.carry[4].step) == tr.opt[0].step == 1
    mu = jax_tree.flatten(convert.state_dict_to_jax_params(
        tr.opt[0].mu, module=tr.generator)[0])
    for k, v in _np_tree(jt.carry[4].mu).items():
        np.testing.assert_array_equal(v, mu[k])
    # generate and evaluate_dataset in the family's domain: the eval-mode
    # forward (the kernel route's plain versions here) within 1e-4 of the
    # JAX trainer's from the same checkpoint
    noisy, _ = _batch(family, seed=7)
    out = tr.generate(noisy)
    assert out.shape == (2, HW, HW, 3)
    np.testing.assert_allclose(out, jt.generate(noisy), atol=1e-4, rtol=0)
    val = tr.evaluate_dataset(_Pairs(family, seed=50))
    assert val["batches"] == 1 and np.isfinite(val["psnr"])

    # JAX → port
    jpath = str(tmp_path / "jax" / f"{family}_epoch_3")
    jt.best_psnr = 9.5
    jax_ckpt.save_checkpoint(jpath, {
        "generator": jt.carry[0], "generator_state": jt.carry[1],
        "discriminator": jt.carry[2], "discriminator_state": jt.carry[3],
        "g_optimizer": jt.carry[4]._asdict(),
        "d_optimizer": jt.carry[5]._asdict()}, {
        "epoch": 3, "best_psnr": 9.5, "metric_history": jt.metric_history,
        "family": family})
    pg2, pd2 = _port_models(family)
    tr2 = gan_trainer.GANTrainer(pg2, pd2, _Pairs(family), cfg,
                                 family=family, perceptual=perc, device="cpu")
    assert tr2.resume(jpath) == 4 and tr2.best_psnr == 9.5
    _assert_module_matches_trees(tr2.generator, jt.carry[0], jt.carry[1],
                                 (0, 0), "G")
    if pd2 is not None:
        _assert_module_matches_trees(tr2.discriminator, jt.carry[2],
                                     jt.carry[3], (0, 0), "D")
        assert all(torch.equal(tr2.opt[1].nu[k], tr.opt[1].nu[k])
                   for k in tr.opt[1].nu)
    with np.load(os.path.join(path, "arrays.npz")) as a, \
            np.load(os.path.join(jpath, "arrays.npz")) as b:
        assert set(a.files) == set(b.files)
