"""One-step whole-GAN train goldens vs torch-CPU.

test_models_parity.py pins each FORWARD to torch; these tests pin a full
TRAIN STEP — loss values, every updated parameter, and the discriminator's
BatchNorm running statistics — against a line-faithful torch replication of
the reference loop (training.py:409-426 for denoise).  What this locks
beyond the forward parity + optimizer goldens:

* the D/G alternation order (D steps first, G optimizes through the
  UPDATED discriminator) and the ``fake.detach()`` placement;
* that the generator output is computed ONCE per step and reused for the
  D step, the G step and the content loss (the reference never re-forwards
  G inside one iteration);
* the D BN running-stat threading: torch's D forwards three times per step
  (real, fake.detach, fake-again after the D update), each updating the
  running stats — a 2- or 1-update threading fails the stat comparison;
* Adam and the loss weights acting on the exact same gradients.

The cGAN (TF) equivalent lives in test_tf_golden.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from torch_port_threads import _one_torch_thread  # noqa: F401

torch = pytest.importorskip("torch")

from test_models_parity import (  # noqa: E402
    t_denoise_discriminator, t_denoise_generator, t_esrgan_discriminator,
    t_esrgan_generator, t_srgan_discriminator, t_srgan_generator,
    t_vgg_tower)

from celebrity_image_denoiser_tpu import models  # noqa: E402
from celebrity_image_denoiser_tpu.ckpt import import_torch_state_dict  # noqa: E402
from celebrity_image_denoiser_tpu.core import prng  # noqa: E402
from celebrity_image_denoiser_tpu.train.gan_trainer import make_train_step  # noqa: E402
from celebrity_image_denoiser_tpu.train.losses import make_vgg_perceptual  # noqa: E402
from celebrity_image_denoiser_tpu.utils import tree as treelib  # noqa: E402


def _assert_trees_close(ours_params, ours_state, our_g, our_d,
                        tg, td, atol_p, atol_s):
    """Compare our updated (params, state) against the torch models' post-
    step state_dicts by re-importing those into fresh trees."""
    ref_p, ref_s = our_g.init(prng.key(10))
    ref_p, ref_s = import_torch_state_dict(our_g, tg.state_dict(), ref_p, ref_s)
    flat_ours = treelib.flatten(ours_params[0])
    for k, v in treelib.flatten(ref_p).items():
        np.testing.assert_allclose(np.asarray(flat_ours[k]), v, atol=atol_p,
                                   err_msg=f"G param {k}")
    flat_state = treelib.flatten(ours_state[0])
    for k, v in treelib.flatten(ref_s).items():
        np.testing.assert_allclose(np.asarray(flat_state[k]), v, atol=atol_s,
                                   err_msg=f"G state {k}")
    dref_p, dref_s = our_d.init(prng.key(11))
    dref_p, dref_s = import_torch_state_dict(our_d, td.state_dict(), dref_p, dref_s)
    flat_ours = treelib.flatten(ours_params[1])
    for k, v in treelib.flatten(dref_p).items():
        np.testing.assert_allclose(np.asarray(flat_ours[k]), v, atol=atol_p,
                                   err_msg=f"D param {k}")
    flat_state = treelib.flatten(ours_state[1])
    for k, v in treelib.flatten(dref_s).items():
        np.testing.assert_allclose(np.asarray(flat_state[k]), v, atol=atol_s,
                                   err_msg=f"D state {k}")


def test_denoise_train_step_matches_torch(rng_np):
    """training.py:404-426, one iteration, lr 1e-4 both nets."""
    tg, td = t_denoise_generator(), t_denoise_discriminator()
    tg.train(), td.train()

    our_g = models.build_generator("denoise")
    our_d = models.build_discriminator("denoise")
    g_params, g_state = our_g.init(prng.key(0))
    d_params, d_state = our_d.init(prng.key(1))
    g_params, g_state = import_torch_state_dict(our_g, tg.state_dict(),
                                                g_params, g_state)
    d_params, d_state = import_torch_state_dict(our_d, td.state_dict(),
                                                d_params, d_state)

    init_fn, step_fn = make_train_step(our_g, our_d, family="denoise",
                                       donate=False)
    carry = init_fn(prng.key(2))
    carry = (g_params, g_state, d_params, d_state, carry[4], carry[5])

    clean = rng_np.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    noisy = np.clip(clean + rng_np.normal(0, 0.2, clean.shape),
                    -1, 1).astype(np.float32)

    # ---- the reference loop body, verbatim semantics ----------------------
    g_opt = torch.optim.Adam(tg.parameters(), lr=1e-4, betas=(0.9, 0.999))
    d_opt = torch.optim.Adam(td.parameters(), lr=1e-4, betas=(0.9, 0.999))
    bce, mse = torch.nn.BCELoss(), torch.nn.MSELoss()
    tn_noisy = torch.from_numpy(np.transpose(noisy, (0, 3, 1, 2)))
    tn_clean = torch.from_numpy(np.transpose(clean, (0, 3, 1, 2)))

    d_opt.zero_grad()
    denoised = tg(tn_noisy)
    real_pred = td(tn_clean)
    fake_pred = td(denoised.detach())
    d_loss = (bce(real_pred, torch.ones_like(real_pred))
              + bce(fake_pred, torch.zeros_like(fake_pred)))
    d_loss.backward()
    d_opt.step()

    g_opt.zero_grad()
    fake_pred = td(denoised)
    g_loss = (mse(denoised, tn_clean)
              + 0.001 * bce(fake_pred, torch.ones_like(fake_pred)))
    g_loss.backward()
    g_opt.step()

    # ---- our jitted step on the same batch --------------------------------
    carry2, out = step_fn(carry, jnp.asarray(noisy), jnp.asarray(clean),
                          prng.key(3), 1e-4, 1e-4)

    np.testing.assert_allclose(float(out["d_loss"]), float(d_loss), rtol=1e-4)
    np.testing.assert_allclose(float(out["g_loss"]), float(g_loss), rtol=1e-4)
    # params: at step 1 Adam moves every weight by ~±lr·sign(grad), so a
    # conv bias that FEEDS a BatchNorm (mathematically ~zero gradient — the
    # mean subtraction cancels it) updates on pure float noise and can land
    # 2·lr apart between backends.  2.5e-4 sits just above that bound; the
    # semantic teeth of this test are the exact losses and BN running stats.
    _assert_trees_close((carry2[0], carry2[2]), (carry2[1], carry2[3]),
                        our_g, our_d, tg, td, atol_p=2.5e-4, atol_s=1e-4)


def test_srgan_train_step_matches_torch(rng_np):
    """sr_ganTrainGNew.py:393-409, one iteration: D BCE real-vs-fake, then
    G = VGG-content MSE + 0.001·adv through the UPDATED discriminator.  The
    content-loss path runs a frozen random-weight VGG16-features[:16] tower
    shared bit-for-bit between both sides via the .pth-shaped importer
    (the reference's pretrained tower is unreachable here, but the STEP
    semantics — which gradients flow, where the tower is frozen, the loss
    weighting — are weight-independent).  Locks G (BN-bearing) AND D
    running stats plus the LR→HR ×4 shape handling."""
    tg, td = t_srgan_generator(), t_srgan_discriminator()
    tg.train(), td.train()
    tvgg = t_vgg_tower().eval()
    for p in tvgg.parameters():
        p.requires_grad = False

    our_g = models.build_generator("srgan")
    our_d = models.build_discriminator("srgan")
    g_params, g_state = our_g.init(prng.key(0))
    d_params, d_state = our_d.init(prng.key(1))
    g_params, g_state = import_torch_state_dict(our_g, tg.state_dict(),
                                                g_params, g_state)
    d_params, d_state = import_torch_state_dict(our_d, td.state_dict(),
                                                d_params, d_state)

    vgg = models.VGGFeatures()
    v_params, v_state = vgg.init(prng.key(4))
    v_params, v_state = import_torch_state_dict(vgg, tvgg.state_dict(),
                                                v_params, v_state)
    perceptual = make_vgg_perceptual(vgg, v_params, v_state)

    init_fn, step_fn = make_train_step(our_g, our_d, family="srgan",
                                       perceptual=perceptual, donate=False)
    carry = init_fn(prng.key(2))
    carry = (g_params, g_state, d_params, d_state, carry[4], carry[5])

    hr = rng_np.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    lr = rng_np.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)

    # ---- the reference loop body, verbatim semantics ----------------------
    g_opt = torch.optim.Adam(tg.parameters(), lr=1e-4, betas=(0.9, 0.999))
    d_opt = torch.optim.Adam(td.parameters(), lr=1e-4, betas=(0.9, 0.999))
    bce, mse = torch.nn.BCELoss(), torch.nn.MSELoss()
    tn_lr = torch.from_numpy(np.transpose(lr, (0, 3, 1, 2)))
    tn_hr = torch.from_numpy(np.transpose(hr, (0, 3, 1, 2)))

    d_opt.zero_grad()
    fake_hr = tg(tn_lr)
    real_pred = td(tn_hr)
    fake_pred = td(fake_hr.detach())
    d_loss = (bce(real_pred, torch.ones_like(real_pred))
              + bce(fake_pred, torch.zeros_like(fake_pred)))
    d_loss.backward()
    d_opt.step()

    g_opt.zero_grad()
    fake_pred = td(fake_hr)
    content_loss = mse(tvgg(fake_hr), tvgg(tn_hr))
    adv_loss = bce(fake_pred, torch.ones_like(fake_pred))
    g_loss = content_loss + 0.001 * adv_loss
    g_loss.backward()
    g_opt.step()

    # ---- our jitted step on the same batch --------------------------------
    carry2, out = step_fn(carry, jnp.asarray(lr), jnp.asarray(hr),
                          prng.key(3), 1e-4, 1e-4)

    np.testing.assert_allclose(float(out["d_loss"]), float(d_loss), rtol=1e-4)
    np.testing.assert_allclose(float(out["g_loss"]), float(g_loss), rtol=1e-4)
    _assert_trees_close((carry2[0], carry2[2]), (carry2[1], carry2[3]),
                        our_g, our_d, tg, td, atol_p=2.5e-4, atol_s=1e-4)


def test_esrgan_train_step_matches_torch(rng_np):
    """esrgan_train.py:95-122, one iteration: BCEWithLogits, the 0.5·d_loss
    factor, pixel MSE + 1e-3·gan, [0,1] domain — and the GENERATOR's BN
    running stats (the esrgan G carries BN in its residual blocks; torch
    forwards G exactly once per iteration and reuses `denoised`)."""
    hw = 16
    tg, td = t_esrgan_generator(), t_esrgan_discriminator(hw=(hw, hw))
    tg.train(), td.train()

    our_g = models.build_generator("esrgan")
    our_d = models.build_discriminator("esrgan", input_hw=(hw, hw))
    g_params, g_state = our_g.init(prng.key(0))
    d_params, d_state = our_d.init(prng.key(1))
    g_params, g_state = import_torch_state_dict(our_g, tg.state_dict(),
                                                g_params, g_state)
    d_params, d_state = import_torch_state_dict(our_d, td.state_dict(),
                                                d_params, d_state)

    init_fn, step_fn = make_train_step(our_g, our_d, family="esrgan",
                                       adv_weight=1e-3, donate=False)
    carry = init_fn(prng.key(2))
    carry = (g_params, g_state, d_params, d_state, carry[4], carry[5])

    clean = rng_np.uniform(0, 1, (4, hw, hw, 3)).astype(np.float32)
    noisy = np.clip(clean + rng_np.normal(0, 0.1, clean.shape),
                    0, 1).astype(np.float32)

    g_opt = torch.optim.Adam(tg.parameters(), lr=1e-4, betas=(0.9, 0.999))
    d_opt = torch.optim.Adam(td.parameters(), lr=1e-4, betas=(0.9, 0.999))
    bce = torch.nn.BCEWithLogitsLoss()
    mse = torch.nn.MSELoss()
    tn_noisy = torch.from_numpy(np.transpose(noisy, (0, 3, 1, 2)))
    tn_clean = torch.from_numpy(np.transpose(clean, (0, 3, 1, 2)))

    denoised = tg(tn_noisy)
    d_opt.zero_grad()
    real_out = td(tn_clean)
    fake_out = td(denoised.detach())
    d_loss = 0.5 * (bce(real_out, torch.ones_like(real_out))
                    + bce(fake_out, torch.zeros_like(fake_out)))
    d_loss.backward()
    d_opt.step()

    g_opt.zero_grad()
    fake_out_g = td(denoised)
    g_loss = (mse(denoised, tn_clean)
              + 1e-3 * bce(fake_out_g, torch.ones_like(fake_out_g)))
    g_loss.backward()
    g_opt.step()

    carry2, out = step_fn(carry, jnp.asarray(noisy), jnp.asarray(clean),
                          prng.key(3), 1e-4, 1e-4)

    np.testing.assert_allclose(float(out["d_loss"]), float(d_loss), rtol=1e-4)
    np.testing.assert_allclose(float(out["g_loss"]), float(g_loss), rtol=1e-4)
    _assert_trees_close((carry2[0], carry2[2]), (carry2[1], carry2[3]),
                        our_g, our_d, tg, td, atol_p=2.5e-4, atol_s=1e-4)
