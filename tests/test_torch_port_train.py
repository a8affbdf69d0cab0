"""The port's training slice against the JAX package, on the CPU.

Small shapes (4×16×16, a few steps); the same numpy inputs from a seed go
through the JAX function and its counterpart in the port, and every
tolerance is stated where it is used.  The JAX weights are the shared
starting point: they are initialised by the JAX package and carried into the
port's modules by ``ckpt/convert.py``.

The one-step comparison is the centre: losses (rtol 1e-4), the
discriminator's BatchNorm running statistics after its three forwards
(atol 1e-4), every updated parameter (atol 2.5e-4 — at step 1 Adam moves each
weight by about ±lr whatever its gradient's size, so a conv bias that feeds a
BatchNorm, whose true gradient is zero, lands up to 2·lr apart between
backends; ``tests/test_torch_train_golden.py:120-124``) and the in-step
metrics (atol 1e-3).
"""

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
from celebrity_image_denoiser_tpu.data.pipeline import (
    DataPipeline as JaxPipeline,
)
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
from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
from celebrity_image_denoiser_tpu_torch.data.datasets import (
    CleanImageDataset,
    train_test_split_pairs,
)
from celebrity_image_denoiser_tpu_torch.data.pipeline import DataPipeline
from celebrity_image_denoiser_tpu_torch.data.synthetic import synth_clean_batch
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseDiscriminator,
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3, double_conv
from celebrity_image_denoiser_tpu_torch.train import gan_trainer
from celebrity_image_denoiser_tpu_torch.train import losses as port_losses
from celebrity_image_denoiser_tpu_torch.train import optim as port_optim


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in jax_tree.flatten(tree).items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def jax_nets():
    g = jax_models.build_generator("denoise")
    d = jax_models.build_discriminator("denoise")
    g_params, g_state = g.init(prng.key(0))
    d_params, d_state = d.init(prng.key(1))
    return g, d, g_params, g_state, d_params, d_state


def _port_nets(jax_nets):
    _, _, g_params, g_state, d_params, d_state = jax_nets
    pg, pd = DenoiseGenerator(), DenoiseDiscriminator()
    convert.load_jax_trees(pg, g_params, g_state)
    convert.load_jax_trees(pd, d_params, d_state)
    return pg, pd


def _batch(seed=0, n=4, size=16):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.2, clean.shape), -1,
                    1).astype(np.float32)
    return noisy, clean


def _assert_module_matches_trees(module, params, state, atol, what):
    got_p, got_s = convert.state_dict_to_jax_params(module.state_dict())
    got_p, got_s = jax_tree.flatten(got_p), jax_tree.flatten(got_s)
    want_p, want_s = _np_tree(params), _np_tree(state)
    assert set(got_p) == set(want_p) and set(got_s) == set(want_s)
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k], v, atol=atol[0], rtol=0,
                                   err_msg=f"{what} param {k}")
    for k, v in want_s.items():
        np.testing.assert_allclose(got_s[k], v, atol=atol[1], rtol=0,
                                   err_msg=f"{what} state {k}")


# ---------------------------------------------------------------------------
# modules
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator_forward_matches_jax(jax_nets, train):
    """(N,) probabilities within 1e-5, and in train mode the BatchNorm
    running statistics after the forward within 1e-5."""
    _, d, _, _, d_params, d_state = jax_nets
    _, pd = _port_nets(jax_nets)
    pd.train(train)
    _, clean = _batch(1)
    ref, new_state = d.apply(d_params, d_state, jnp.asarray(clean),
                             train=train)
    with torch.no_grad():
        got = pd(_t(clean).permute(0, 3, 1, 2))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    _assert_module_matches_trees(pd, d_params, new_state if train else d_state,
                                 (0, 1e-5), "D")
    names = [n for n, _ in pd.named_parameters()]
    assert names[0] == "model.0.weight" and names[-1] == "model.12.bias"


def test_converter_round_trip_with_batchnorm(jax_nets):
    """JAX trees → modules → JAX trees is the identity (exact), kernels back
    in HWIO; ``num_batches_tracked`` neither breaks the strict load nor
    comes back; a missing or unknown leaf raises."""
    _, _, g_params, g_state, d_params, d_state = jax_nets
    pg, pd = _port_nets(jax_nets)
    _assert_module_matches_trees(pg, g_params, g_state, (0, 0), "G")
    _assert_module_matches_trees(pd, d_params, d_state, (0, 0), "D")
    sd = pd.state_dict()
    assert "model.3.num_batches_tracked" in sd
    assert sd["model.3.weight"].shape == (64,)            # scale → weight
    assert sd["model.2.weight"].shape == (64, 64, 3, 3)   # HWIO → OIHW
    back, state = convert.state_dict_to_jax_params(sd)
    assert back["model"]["2"]["kernel"].shape == (3, 3, 64, 64)
    assert set(state["model"]["3"]) == {"mean", "var"}
    broken = {k: v for k, v in jax_tree.flatten(d_params).items()
              if k != "model.3.scale"}
    with pytest.raises(KeyError, match="model.3.weight"):
        convert.load_jax_trees(DenoiseDiscriminator(),
                               jax_tree.unflatten(broken), d_state)
    with pytest.raises(ValueError):
        convert.jax_params_to_state_dict({"fc": {"alpha": np.zeros(3)}})


def test_losses_match_jax():
    """Each loss within 1e-6, including bce's clip at 1e-7 where torch's
    BCELoss (log clamped at -100) would differ."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    b = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    p = np.concatenate([rng.uniform(0, 1, 14), [0.0, 1.0]]).astype(np.float32)
    z = (rng.standard_normal(16) * 4).astype(np.float32)

    def close(got, ref):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6,
                                   atol=1e-6)

    close(port_losses.mse(_t(a), _t(b)), jax_losses.mse(a, b))
    close(port_losses.mae(_t(a), _t(b)), jax_losses.mae(a, b))
    for target in (0.0, 1.0):
        close(port_losses.bce(_t(p), target),
              jax_losses.bce(jnp.asarray(p), target))
        close(port_losses.bce_with_logits(_t(z), target),
              jax_losses.bce_with_logits(jnp.asarray(z), target))
    torch_bce = torch.nn.functional.binary_cross_entropy(
        _t(p), torch.ones(16)).item()
    assert abs(torch_bce - float(port_losses.bce(_t(p), 1.0))) > 1.0
    # srgan's content loss: a frozen tower's module
    # (tests/test_torch_port_train_families.py holds it against JAX)
    assert isinstance(port_losses.make_vgg_perceptual(torch.nn.Identity()),
                      torch.nn.Module)


def test_adam_and_step_lr_match_jax():
    """Three Adam steps with a changing lr: parameters and both moments
    within 1e-6; the state is (step, mu, nu) keyed like the parameters."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((3, 5)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    jinit, jupdate = jax_optim.adam(0.9, 0.999)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jinit(jp)
    pinit, pupdate = port_optim.adam(0.9, 0.999)
    pp = {k: _t(v).clone() for k, v in p0.items()}
    pstate = pinit(pp)
    assert pstate.step == 0 and set(pstate.mu) == set(pstate.nu) == set(pp)
    for i, lr in enumerate((1e-2, 1e-3, 5e-3)):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** (i - 1)
                     ).astype(np.float32) for k, v in p0.items()}
        jp, jstate = jupdate({k: jnp.asarray(v) for k, v in grads.items()},
                             jstate, jp, lr)
        pupdate({k: _t(v) for k, v in grads.items()}, pstate, pp, lr)
    assert pstate.step == int(jstate.step) == 3
    for k in p0:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(pstate.mu[k].numpy(),
                                   np.asarray(jstate.mu[k]), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(pstate.nu[k].numpy(),
                                   np.asarray(jstate.nu[k]), atol=1e-6,
                                   rtol=1e-6)
    js, ps = jax_optim.step_lr(1e-4, 30, 0.1), port_optim.step_lr(1e-4, 30, 0.1)
    for epoch in (0, 29, 30, 61, 95):
        assert ps(epoch) == js(epoch)
    assert port_optim.constant_lr(3e-4)(17) == 3e-4
    # the cGAN's Keras Adam shares the state layout
    # (tests/test_torch_port_train_families.py holds it against JAX)
    kinit, _ = port_optim.adam_keras()
    assert set(kinit(pp).mu) == set(pstate.mu)


def test_psnr_ssim_match_jax():
    """Per-image PSNR and skimage-convention SSIM within 1e-4, NHWC and
    HWC, at both data ranges the reference uses."""
    noisy, clean = _batch(4, n=3, size=20)
    for dr in (2.0, 1.0):
        np.testing.assert_allclose(
            port_metrics.psnr(_t(noisy), _t(clean), dr).numpy(),
            np.asarray(jax_metrics.psnr(noisy, clean, data_range=dr)),
            atol=1e-4, rtol=0)
        np.testing.assert_allclose(
            port_metrics.ssim(_t(noisy), _t(clean), dr).numpy(),
            np.asarray(jax_metrics.ssim(jnp.asarray(noisy),
                                        jnp.asarray(clean), data_range=dr)),
            atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        float(port_metrics.ssim(_t(noisy[0]), _t(clean[0]))),
        float(jax_metrics.ssim(jnp.asarray(noisy[0]), jnp.asarray(clean[0]))),
        atol=1e-4)
    assert float(port_metrics.psnr(_t(clean[0]), _t(clean[0]))) > 100
    # the cGAN's tf.image convention is another function
    # (tests/test_torch_port_train_families.py holds it against JAX)
    assert float(port_metrics.ssim_tf(_t(noisy[0]), _t(clean[0]))) != \
        pytest.approx(float(port_metrics.ssim(_t(noisy[0]), _t(clean[0]))))


# ---------------------------------------------------------------------------
# the kernels have no backward
def test_kernel_wrappers_raise_under_grad():
    x = torch.zeros(1, 4, 4, 8)
    w1, b1 = torch.zeros(3, 3, 8, 8, requires_grad=True), torch.zeros(8)
    w2, b2 = torch.zeros(3, 3, 8, 4), torch.zeros(4)
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3.conv3x3_bias_relu(x, w1, b1)
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3.conv3x3_bias_relu_v2(x.requires_grad_(True), w1.detach(), b1)
    with pytest.raises(RuntimeError, match="no backward"):
        double_conv.double_conv3x3_relu(x.detach(), w1, b1, w2, b2)
    with torch.no_grad():  # nothing records: the same call runs
        assert conv3x3.conv3x3_bias_relu(x, w1, b1).shape == (1, 4, 4, 8)
    model = DenoiseGenerator()
    with pytest.raises(RuntimeError, match="route='autograd'"):
        model(torch.zeros(1, 3, 8, 8))  # trainable parameters, grad enabled
    with pytest.raises(ValueError, match="unknown route"):
        model(torch.zeros(1, 3, 8, 8), route="fast")


def _module_forward(m, x):
    """The generator through its own ``nn.Sequential`` children: PyTorch's
    conv modules called as they stand, no route of the port."""
    pool = torch.nn.functional.max_pool2d
    e1 = m.down1(x)
    e2 = m.down2(pool(e1, 2))
    d2 = m.upconv2(torch.cat([m.up2(m.bottleneck(pool(e2, 2))), e2], dim=1))
    return torch.tanh(m.upconv1(torch.cat([m.up1(d2), e1], dim=1)))


def test_autograd_route_gradients_equal_the_plain_route():
    """Same forward (1e-5) and the same gradient for the input and every
    parameter (1e-5 × the gradient's largest value) as autograd through the
    plain ``nn.Conv2d`` modules; no gradient is zero everywhere.  The
    ``"plain"`` route itself is for inference and raises like the kernels."""
    model = DenoiseGenerator(generator=torch.Generator().manual_seed(0))
    noisy, clean = _batch(5, n=2)
    target = _t(clean).permute(0, 3, 1, 2)
    grads = {}
    for name, fwd in (("autograd", lambda x: model(x, route="autograd")),
                      ("plain", lambda x: _module_forward(model, x))):
        x = _t(noisy).permute(0, 3, 1, 2).clone().requires_grad_(True)
        y = fwd(x)
        loss = torch.mean((y - target) ** 2)
        got = torch.autograd.grad(loss, [x, *model.parameters()])
        grads[name] = (y.detach(), got)
    np.testing.assert_allclose(grads["autograd"][0].numpy(),
                               grads["plain"][0].numpy(), atol=1e-5, rtol=0)
    names = ["input"] + [n for n, _ in model.named_parameters()]
    for name, a, b in zip(names, grads["autograd"][1], grads["plain"][1]):
        scale = b.abs().max().item()
        assert scale > 0, name
        assert (a - b).abs().max().item() <= 1e-5 * scale + 1e-9, name
    with pytest.raises(RuntimeError, match="no backward"):
        model(_t(noisy).permute(0, 3, 1, 2), route="plain")


# ---------------------------------------------------------------------------
# the train step
@pytest.fixture(scope="module")
def jax_step(jax_nets):
    g, d = jax_nets[0], jax_nets[1]
    return jax_trainer.make_train_step(g, d, family="denoise", donate=False)


def _jax_carry(jax_nets, jax_step):
    init_fn, _ = jax_step
    carry = init_fn(prng.key(2))
    _, _, g_params, g_state, d_params, d_state = jax_nets
    return (g_params, g_state, d_params, d_state, carry[4], carry[5])


def test_one_f32_train_step_matches_jax(jax_nets, jax_step):
    noisy, clean = _batch(0)
    carry, ref = jax_step[1](_jax_carry(jax_nets, jax_step),
                             jnp.asarray(noisy), jnp.asarray(clean),
                             prng.key(3), 1e-4, 1e-4)
    pg, pd = _port_nets(jax_nets)
    before = {k: v.clone() for k, v in pg.state_dict().items()}
    k13 = (conv3x3.LAUNCHES, double_conv.LAUNCHES)
    init_fn, step_fn = gan_trainer.make_train_step(pg, pd, family="denoise")
    opt = init_fn()
    out = step_fn(opt, _t(noisy), _t(clean), None, 1e-4, 1e-4)
    for k in ("g_loss", "d_loss"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-4)
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), atol=1e-3)
    _assert_module_matches_trees(pg, carry[0], carry[1], (2.5e-4, 1e-4), "G")
    _assert_module_matches_trees(pd, carry[2], carry[3], (2.5e-4, 1e-4), "D")
    assert opt[0].step == opt[1].step == 1
    # no generator parameter was left without a gradient: Adam's first step
    # moves every weight whose gradient is not zero
    for k, v in pg.state_dict().items():
        assert not torch.equal(v, before[k]), k
    assert (conv3x3.LAUNCHES, double_conv.LAUNCHES) == k13
    assert "noise_kinds" not in out


def test_three_chained_steps_match_jax(jax_nets, jax_step):
    """Losses within rtol 1e-3 over three steps on three batches (the
    parameters drift apart by Adam's noise-driven first steps)."""
    carry = _jax_carry(jax_nets, jax_step)
    pg, pd = _port_nets(jax_nets)
    init_fn, step_fn = gan_trainer.make_train_step(pg, pd)
    opt = init_fn()
    for i in range(3):
        noisy, clean = _batch(10 + i)
        carry, ref = jax_step[1](carry, jnp.asarray(noisy),
                                 jnp.asarray(clean), prng.key(i), 1e-4, 1e-4)
        out = step_fn(opt, _t(noisy), _t(clean), None, 1e-4, 1e-4)
        for k in ("g_loss", "d_loss"):
            np.testing.assert_allclose(float(out[k]), float(ref[k]),
                                       rtol=1e-3, err_msg=f"step {i} {k}")
    assert opt[0].step == 3


def test_bf16_train_step_tracks_f32(jax_nets):
    """compute_dtype='bfloat16': parameters and optimiser state stay f32,
    and after three steps the losses and PSNR are within 5% of the f32 run
    (``tests/test_train.py:249-252``)."""
    results = {}
    for cdt in ("float32", "bfloat16"):
        pg, pd = _port_nets(jax_nets)
        init_fn, step_fn = gan_trainer.make_train_step(pg, pd,
                                                       compute_dtype=cdt)
        opt = init_fn()
        for i in range(3):
            noisy, clean = _batch(20 + i)
            m = step_fn(opt, _t(noisy), _t(clean), None, 1e-4, 1e-4)
        assert all(p.dtype == torch.float32 for p in pg.parameters())
        assert all(v.dtype == torch.float32 for v in opt[0].mu.values())
        assert all(v.dtype == torch.float32 for v in m.values())
        results[cdt] = {k: float(v) for k, v in m.items()}
    for k in ("g_loss", "d_loss", "psnr"):
        a, b = results["float32"][k], results["bfloat16"][k]
        assert np.isfinite(b)
        assert abs(a - b) < 0.05 * max(1.0, abs(a)), (k, a, b)
    with pytest.raises(ValueError, match="compute_dtype"):
        gan_trainer.make_train_step(pg, pd, compute_dtype="float16")


def test_on_the_fly_step_is_finite(jax_nets):
    """uint8 clean batch in, noise from the generator: finite losses,
    PSNR > 5 dB, and the kinds it drew are reported."""
    pg, pd = _port_nets(jax_nets)
    init_fn, step_fn = gan_trainer.make_train_step(pg, pd,
                                                   on_the_fly_noise=True)
    opt = init_fn()
    gen = torch.Generator().manual_seed(1)
    clean = (synth_clean_batch(torch.Generator().manual_seed(0), 8, 16)
             * 255).round().to(torch.uint8)
    for _ in range(2):
        m = step_fn(opt, None, clean, gen, 1e-4, 1e-4)
    kinds = m.pop("noise_kinds")
    assert len(kinds) == 8 and set(kinds.tolist()) <= set(range(5))
    vals = {k: float(v) for k, v in m.items()}
    assert all(np.isfinite(v) for v in vals.values()), vals
    assert vals["psnr"] > 5.0


def test_on_the_fly_step_trains_on_the_trainer_normalisation(jax_nets,
                                                             monkeypatch):
    """One on-the-fly step: the clean target that the input stage's plain
    version gives is bit-equal to ``clean.to(float32) / 255.0 * 2.0 - 1.0``,
    and the step is the step on the (noisy, clean) pair it made."""
    made = []
    real = noise_lib.random_noise_batch

    def spy(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(noise_lib, "random_noise_batch", spy)
    clean_u8 = (synth_clean_batch(torch.Generator().manual_seed(3), 4, 16)
                * 255).round().to(torch.uint8)
    outs = []
    for fly in (True, False):
        pg, pd = _port_nets(jax_nets)
        init_fn, step_fn = gan_trainer.make_train_step(
            pg, pd, on_the_fly_noise=fly)
        if fly:
            m = step_fn(init_fn(), None, clean_u8,
                        torch.Generator().manual_seed(4), 1e-4, 1e-4)
            noisy, clean, _ = made[0]
            assert torch.equal(
                clean, clean_u8.to(torch.float32) / 255.0 * 2.0 - 1.0)
        else:
            m = step_fn(init_fn(), noisy, clean, None, 1e-4, 1e-4)
        outs.append({k: float(m[k]) for k in ("g_loss", "d_loss", "psnr")})
    assert len(made) == 1 and outs[0] == outs[1]


def test_other_families_and_options_wait():
    """Every family trains (tests/test_torch_port_train_families.py), and
    ``remat`` and ``extras_fn`` work (tests/test_torch_port_extras.py holds
    them against the plain step and the JAX package); ``mesh=`` takes a
    ``DeviceMesh`` (data parallelism: tests/test_torch_port_parallel_train.py)
    and refuses anything else.  The native loader runs
    (tests/test_torch_port_data.py) and refuses, before any batch, a
    dataset with no ``raw_batch_spec``."""
    from celebrity_image_denoiser_tpu_torch.core.config import (
        FAMILY_NOISE_VARIANT,
    )

    pg, pd = DenoiseGenerator(), DenoiseDiscriminator()
    assert set(gan_trainer.FAMILIES) == set(FAMILY_NOISE_VARIANT)
    with pytest.raises(ValueError, match="unknown family"):
        gan_trainer.make_train_step(pg, pd, family="vae")
    tr = gan_trainer.GANTrainer(pg, pd, [], TrainConfig(remat=True),
                                device="cpu")
    assert tr.step_fn is not None
    init, step = gan_trainer.make_train_step(
        pg, pd, remat=True,
        extras_fn=lambda f, c: {"extra": (f - c).abs().mean()})
    x, y = _batch(n=2)
    m = step(init(), _t(x), _t(y), None, 1e-4, 1e-4)
    assert {"g_loss", "d_loss", "psnr", "ssim", "extra"} <= set(m)
    assert m["extra"].dim() == 0 and bool(torch.isfinite(m["extra"]))
    with pytest.raises(TypeError, match="DeviceMesh"):
        gan_trainer.make_train_step(pg, pd, mesh=object())
    with pytest.raises(ValueError, match="raw_batch_spec"):
        DataPipeline([], 2, device="cpu", use_native=True)


# ---------------------------------------------------------------------------
# the loop, checkpoints, data
class _Pairs:
    """A fixed list of (noisy, clean) float32 batches, as a pipeline."""

    def __init__(self, n_batches=2, seed=30):
        self.batches = [tuple(_t(a) for a in _batch(seed + i))
                        for i in range(n_batches)]

    def __iter__(self):
        return iter(self.batches)


def _cfg(tmp_path, **kw):
    kw.setdefault("num_epochs", 2)
    return TrainConfig(batch_size=4, image_size=(16, 16),
                       checkpoint_dir=str(tmp_path / "ckpt"),
                       on_the_fly_noise=False, **kw)


def test_trainer_loop_and_resume(jax_nets, tmp_path):
    """Two epochs, then a fresh trainer resumes at epoch 2 with identical
    parameters, BN statistics, optimiser state and history, and a third
    epoch gives what an uninterrupted run gives."""
    cfg = _cfg(tmp_path)
    tr = gan_trainer.GANTrainer(*_port_nets(jax_nets), _Pairs(), cfg,
                                device="cpu")
    hist = tr.train()
    assert [len(hist[k]) for k in ("g_loss", "psnr", "lpips")] == [2, 2, 2]
    assert tr.steps == 4 and tr.steps_with_gaussian == 0
    assert tr.best_psnr == max(hist["psnr"]) > 5.0
    ckpt = port_ckpt.latest_checkpoint(cfg.checkpoint_dir, prefix="denoise_")
    assert ckpt.endswith("denoise_epoch_1")
    assert os.path.isdir(os.path.join(cfg.checkpoint_dir, "best"))

    cfg3 = _cfg(tmp_path, num_epochs=3)
    tr2 = gan_trainer.GANTrainer(DenoiseGenerator(), DenoiseDiscriminator(),
                                 _Pairs(), cfg3, device="cpu")
    assert tr2.resume() == 2
    for a, b in ((tr.generator, tr2.generator),
                 (tr.discriminator, tr2.discriminator)):
        for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, w), k
    for st, st2 in zip(tr.opt, tr2.opt):
        assert st.step == st2.step == 4
        assert all(torch.equal(st.mu[k], st2.mu[k]) for k in st.mu)
        assert all(torch.equal(st.nu[k], st2.nu[k]) for k in st.nu)
    assert tr2.metric_history == hist and tr2.best_psnr == tr.best_psnr
    tr.cfg = cfg3
    tr.start_epoch = 2
    h_straight = tr.train()
    h_resumed = tr2.train()
    assert h_resumed["g_loss"][2] == pytest.approx(h_straight["g_loss"][2],
                                                   rel=1e-6)
    # evaluation inside training goes through the generator's kernel route
    val = tr2.evaluate_dataset(_Pairs(1))
    assert val["batches"] == 1 and np.isfinite(val["psnr"])
    with pytest.raises(ValueError, match="pair batches"):
        tr2.evaluate_dataset([torch.zeros(1, 16, 16, 3)])
    out = tr2.generate(_batch(0)[0])
    assert out.shape == (4, 16, 16, 3) and np.abs(out).max() <= 1.0


def test_non_finite_epoch_stops_before_checkpointing(jax_nets, tmp_path):
    cfg = _cfg(tmp_path, num_epochs=3)
    tr = gan_trainer.GANTrainer(*_port_nets(jax_nets), _Pairs(1), cfg,
                                device="cpu")
    with torch.no_grad():
        tr.generator.up1.bias.fill_(float("nan"))
    hist = tr.train()
    assert hist["g_loss"] == []
    assert port_ckpt.latest_checkpoint(cfg.checkpoint_dir) is None


def test_checkpoints_cross_between_the_packages(jax_nets, tmp_path):
    """A port checkpoint resumes in the JAX GANTrainer and a JAX checkpoint
    in the port's: same key names and array layout in ``arrays.npz``."""
    g, d = jax_nets[0], jax_nets[1]
    # port → JAX, after one epoch so the optimiser state is not all zeros
    cfg = _cfg(tmp_path, num_epochs=1)
    tr = gan_trainer.GANTrainer(*_port_nets(jax_nets), _Pairs(1), cfg,
                                device="cpu")
    tr.train()
    path = port_ckpt.latest_checkpoint(cfg.checkpoint_dir, prefix="denoise_")
    jcfg = JaxConfig(num_epochs=2, batch_size=4, image_size=(16, 16),
                     checkpoint_dir=cfg.checkpoint_dir,
                     on_the_fly_noise=False, compute_dtype="float32")
    jt = jax_trainer.GANTrainer(g, d, [], jcfg)
    assert jt.resume(path) == 1
    _assert_module_matches_trees(tr.generator, jt.carry[0], jt.carry[1],
                                 (0, 0), "G")
    _assert_module_matches_trees(tr.discriminator, jt.carry[2], jt.carry[3],
                                 (0, 0), "D")
    assert int(jt.carry[4].step) == tr.opt[0].step == 1
    mu = jax_tree.flatten(convert.state_dict_to_jax_params(tr.opt[0].mu)[0])
    for k, v in _np_tree(jt.carry[4].mu).items():
        np.testing.assert_array_equal(v, mu[k])
    assert jt.metric_history["psnr"] == tr.metric_history["psnr"]
    noisy, _ = _batch(7)
    np.testing.assert_allclose(jt.generate(noisy), tr.generate(noisy),
                               atol=1e-4, rtol=0)

    # JAX → port
    jpath = str(tmp_path / "from_jax" / "denoise_epoch_4")
    jt.best_psnr = 12.5
    sections = {
        "generator": jt.carry[0], "generator_state": jt.carry[1],
        "discriminator": jt.carry[2], "discriminator_state": jt.carry[3],
        "g_optimizer": jt.carry[4]._asdict(),
        "d_optimizer": jt.carry[5]._asdict()}
    jax_ckpt.save_checkpoint(jpath, sections, {
        "epoch": 4, "best_psnr": jt.best_psnr,
        "metric_history": jt.metric_history, "family": "denoise"})
    tr2 = gan_trainer.GANTrainer(DenoiseGenerator(), DenoiseDiscriminator(),
                                 _Pairs(1), cfg, device="cpu")
    assert tr2.resume(jpath) == 5 and tr2.best_psnr == 12.5
    _assert_module_matches_trees(tr2.generator, jt.carry[0], jt.carry[1],
                                 (0, 0), "G")
    _assert_module_matches_trees(tr2.discriminator, jt.carry[2], jt.carry[3],
                                 (0, 0), "D")
    assert tr2.opt[1].step == 1
    assert all(torch.equal(tr2.opt[1].nu[k], tr.opt[1].nu[k])
               for k in tr.opt[1].nu)
    # both packages write the same keys
    with np.load(os.path.join(path, "arrays.npz")) as a, \
            np.load(os.path.join(jpath, "arrays.npz")) as b:
        assert set(a.files) == set(b.files)
        assert a["g_optimizer.step"].dtype == b["g_optimizer.step"].dtype


class _Numbered:
    """Sample i is an array filled with i; every seventh sample is bad."""

    def __init__(self, n=23, bad=True):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.bad and i % 7 == 3:
            return None
        return np.full((2, 2, 3), i, np.uint8)


@pytest.mark.parametrize("drop_last", [True, False], ids=["drop", "keep"])
def test_pipeline_batch_order_equals_jax(drop_last):
    """Same seed → the same batches in the same order over two epochs, the
    skipped samples topped up alike."""
    kw = dict(shuffle=True, seed=5, drop_last=drop_last)
    jp = JaxPipeline(_Numbered(), 4, use_native=False, **kw)
    pp = DataPipeline(_Numbered(), 4, device="cpu", **kw)
    assert len(jp) == len(pp)
    for _ in range(2):
        ref = [np.asarray(b) for b in jp]
        got = [b.numpy() for b in pp]
        assert len(got) == len(ref) > 0
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.uint8
    pairs = DataPipeline([(np.zeros(2, np.float32), np.ones(2, np.float32))
                          for _ in range(4)], 2, shuffle=False, device="cpu")
    batch = next(iter(pairs))  # stopping early must not hang the producer
    assert isinstance(batch, tuple) and batch[1].shape == (2, 2)


def test_pipeline_surfaces_dataset_errors():
    class Broken(_Numbered):
        def __getitem__(self, i):
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(DataPipeline(Broken(), 4, device="cpu"))


def test_split_and_synthetic_recipe():
    """The seed-42 split is the JAX package's; the synthetic images keep the
    recipe's ranges: [0, 1], mid-grey mean, edges and flat regions."""
    from celebrity_image_denoiser_tpu.data.datasets import (
        train_test_split_pairs as jax_split,
    )

    items = [f"img{i:03d}.png" for i in range(80)]
    assert train_test_split_pairs(items) == jax_split(items)
    assert len(train_test_split_pairs(items)[0]) == 64
    with pytest.raises(ValueError):
        train_test_split_pairs([])
    imgs = synth_clean_batch(torch.Generator().manual_seed(3), 6, 64)
    assert imgs.shape == (6, 64, 64, 3) and imgs.dtype == torch.float32
    assert imgs.min() >= 0 and imgs.max() <= 1
    assert 0.25 < imgs.mean() < 0.75
    assert imgs.std(dim=(1, 2, 3)).min() > 0.05
    again = synth_clean_batch(torch.Generator().manual_seed(3), 6, 64)
    assert torch.equal(imgs, again)


@pytest.fixture()
def png_dir(tmp_path):
    imgs = synth_clean_batch(torch.Generator().manual_seed(1), 10, 16)
    d = tmp_path / "clean" / "person"
    d.mkdir(parents=True)
    for i, im in enumerate((imgs * 255).round().to(torch.uint8).numpy()):
        (d / f"{i:02d}.png").write_bytes(imageio.encode_png(im))
    return tmp_path / "clean"


def test_clean_dataset_yields_uint8_and_refuses_other_sizes(png_dir):
    """uint8 at ``image_size``; a file of another size is resized to it,
    Pillow's bicubic bit for bit (the uint8 of the JAX dataset before its
    ``to_float01``; tests/test_torch_port_data.py holds the rest)."""
    from celebrity_image_denoiser_tpu.data.datasets import (
        CleanImageDataset as JaxClean,
    )

    ds = CleanImageDataset(str(png_dir), image_size=(16, 16))
    assert len(ds) == 8 and len(ds.test_paths) == 2
    x = ds[0]
    assert x.dtype == np.uint8 and x.shape == (16, 16, 3)
    assert ds.get_test(0).shape == (16, 16, 3)
    big = CleanImageDataset(str(png_dir), image_size=(32, 24))
    jax_big = JaxClean(str(png_dir), image_size=(32, 24))
    assert big.train_paths == jax_big.train_paths
    y = big[0]
    assert y.dtype == np.uint8 and y.shape == (32, 24, 3)
    np.testing.assert_array_equal(imageio.to_float01(y), jax_big[0])
    (png_dir / "person" / "00.png").write_bytes(b"not a png")
    ds = CleanImageDataset(str(png_dir), image_size=(16, 16))
    loaded = [ds[i] for i in range(len(ds))]
    assert sum(x is None for x in loaded) <= 1  # warn-and-skip, not raise
    with pytest.raises(ValueError, match="No images"):
        CleanImageDataset(str(png_dir / "person" / "none"))


def test_cli_train_on_the_cpu(png_dir, tmp_path):
    """cli.train → CleanImageDataset → DataPipeline → input stage → train
    step → checkpoint, on a tiny PNG directory; then --resume."""
    args = ["--clean-dir", str(png_dir), "--image-size", "16", "16",
            "--batch-size", "4", "--checkpoint-dir", str(tmp_path / "ck"),
            "--graph-dir", str(tmp_path / "graphs"), "--device", "cpu"]
    assert cli_train.main(args + ["--num-epochs", "1"]) == 0
    path = port_ckpt.latest_checkpoint(str(tmp_path / "ck"), "denoise_")
    sections, meta = port_ckpt.load_checkpoint(path)
    assert meta["epoch"] == 0 and meta["family"] == "denoise"
    assert np.isfinite(meta["metric_history"]["g_loss"]).all()
    assert int(sections["g_optimizer"]["step"]) == 2  # 8 images / batch 4
    tr = cli_train.build_trainer(cli_train.build_parser().parse_args(
        args + ["--num-epochs", "2", "--resume", "--compute-dtype",
                "float32"]))
    assert tr.start_epoch == 1
    tr.train()
    assert tr.steps == 2 and 0 <= tr.steps_with_gaussian <= 2
    # one count per step (batch 4), read once at the epoch's end
    assert len(tr.gaussian_counts) == 2
    assert all(type(c) is int and 0 <= c <= 4 for c in tr.gaussian_counts)
    assert len(tr.metric_history["psnr"]) == 2
    # the flags of the JAX CLI's extras are accepted and reach the trainer
    # (tests/test_torch_port_extras.py runs them); --no-data-parallel
    # outside torch.distributed.run trains this process alone, as without
    # it (tests/test_torch_port_parallel_train.py runs data parallelism)
    parsed = cli_train.build_parser().parse_args(
        args + ["--remat", "--extra-metrics", "batch", "--profile-dir", "p"])
    assert parsed.remat and parsed.extra_metrics == "batch"
    assert parsed.profile_dir == "p"
    assert cli_train.build_config(parsed).remat
    parsed = cli_train.build_parser().parse_args(args + ["--no-data-parallel"])
    assert parsed.no_data_parallel
    with cli_train.data_parallel(parsed) as (mesh, device):
        assert mesh is None and device == torch.device("cpu")
    # the disk pairs and tensor caches train (tests/test_torch_port_data.py)
    parsed = cli_train.build_parser().parse_args(
        args + ["--no-on-the-fly", "--tensor-cache", "c",
                "--tensor-cache-domain", "unit"])
    assert parsed.no_on_the_fly and parsed.tensor_cache == "c"
    # --model srgan trains (tests/test_torch_port_train_families.py), and
    # --noise-variant 2 now runs on the noise kernel's variant 2
    tr = cli_train.run(args + ["--noise-variant", "2", "--num-epochs", "1",
                               "--checkpoint-dir", str(tmp_path / "v2")])
    assert tr.steps == 2 and np.isfinite(tr.metric_history["g_loss"]).all()
    with pytest.raises(SystemExit):
        cli_train.build_parser().parse_args(args + ["--noise-variant", "4"])


def test_training_entry_points_default_to_the_card(png_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-fallback path needs none")
    with pytest.raises(RuntimeError, match="cuda"):
        cli_train.main(["--clean-dir", str(png_dir), "--image-size", "16",
                        "16", "--batch-size", "4", "--num-epochs", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        gan_trainer.GANTrainer(DenoiseGenerator(), DenoiseDiscriminator(), [])
    with pytest.raises(RuntimeError, match="cuda"):
        DataPipeline([], 2)
