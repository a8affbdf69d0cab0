"""The port's MS-SSIM, the trainer's extra metrics, ``remat``, the training
CLI's flags, profiling and the host-side figures, against the JAX package
on the CPU.

Small shapes: MS-SSIM needs 176 px a side, every step runs at 16² (the
trainer at 16², its test pair at 176²).  No JAX train step is compiled
here: the port's plain step is held against JAX's in
``tests/test_torch_port_train.py`` and ``test_torch_port_train_families.py``,
so ``remat`` is held against the port's plain step.  Tolerances are stated
where they are used.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celebrity_image_denoiser_tpu import metrics as jax_metrics
from celebrity_image_denoiser_tpu.utils import profiling as jax_profiling
from celebrity_image_denoiser_tpu.viz import side_by_side as jax_side
from celebrity_image_denoiser_tpu.viz import training_plots as jax_plots
from celebrity_image_denoiser_tpu_torch import metrics as port_metrics
from celebrity_image_denoiser_tpu_torch.cli import train as cli_train
from celebrity_image_denoiser_tpu_torch.core.config import TrainConfig
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.train import gan_trainer
from celebrity_image_denoiser_tpu_torch.utils import profiling
from celebrity_image_denoiser_tpu_torch.viz import training_plots
from torch_port_threads import _one_torch_thread  # noqa: F401

HW = 16  # the train steps' side


def _pair(seed, shape, lo=0.0):
    r = np.random.default_rng(seed)
    a = r.uniform(lo, 1, shape).astype(np.float32)
    b = np.clip(a + 0.15 * r.standard_normal(shape), lo, 1).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# 1. ms_ssim
@pytest.mark.parametrize("shape", [(2, 176, 176, 3), (1, 192, 200, 3),
                                   (176, 180, 3)],
                         ids=["2x176", "1x192x200", "hwc"])
def test_ms_ssim_matches_jax(shape):
    """rtol 1e-5, atol 1e-6: float32 sums in another order."""
    a, b = _pair(0, shape)
    want = np.asarray(jax_metrics.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = port_metrics.ms_ssim(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # float64 in, float64 out (the card's check holds float32 against it)
    d = port_metrics.ms_ssim(torch.from_numpy(a).double(),
                             torch.from_numpy(b).double())
    assert d.dtype == torch.float64
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ms_ssim_refuses_below_176_px():
    """JAX fails on the shape; the port names the minimum (by design)."""
    a, b = _pair(1, (1, 175, 200, 3))
    with pytest.raises(ValueError, match="176 px"):
        port_metrics.ms_ssim(torch.from_numpy(a), torch.from_numpy(b))
    ok = torch.from_numpy(_pair(1, (1, 176, 176, 3))[0])
    assert float(port_metrics.ms_ssim(ok, ok)) == pytest.approx(1.0,
                                                                abs=1e-6)


# ---------------------------------------------------------------------------
# 2. the per-batch extras against the JAX trainer's extras_fn
@pytest.fixture(scope="module")
def perceptual_pair():
    from celebrity_image_denoiser_tpu.metrics.perceptual import (
        PerceptualDistance as JaxPD,
    )

    return JaxPD.default(seed=0), port_metrics.PerceptualDistance.default(
        seed=0)


def _jax_extras(pd, family, fake, clean):
    """JAX ``GANTrainer``'s ``extras_fn`` (gan_trainer.py:357-371)."""
    if family in ("esrgan", "dncnn"):
        f01, c01 = jnp.clip(fake, 0.0, 1.0), jnp.clip(clean, 0.0, 1.0)
    else:
        f01 = jnp.clip(fake * 0.5 + 0.5, 0.0, 1.0)
        c01 = jnp.clip(clean * 0.5 + 0.5, 0.0, 1.0)
    out = {"lpips": jnp.mean(pd._distance(f01, c01))}
    if f01.shape[1] >= 176 and f01.shape[2] >= 176:
        out["msssim"] = jnp.mean(jax_metrics.ms_ssim(f01, c01,
                                                     data_range=1.0))
    else:
        out["msssim"] = jnp.mean(jax_metrics.ssim(f01, c01, data_range=1.0))
    return {k: float(v) for k, v in out.items()}


@pytest.mark.parametrize("family", ["denoise", "esrgan"])
@pytest.mark.parametrize("size", [176, 32])
def test_batch_extras_match_jax(perceptual_pair, family, size):
    """Both domains, both size branches (MS-SSIM at 176², SSIM below):
    within 1e-5."""
    jpd, tpd = perceptual_pair
    lo = 0.0 if family == "esrgan" else -1.0
    fake, clean = _pair(2, (2, size, size, 3), lo)
    fake = fake * 1.05  # outside the domain: the clip matters
    want = _jax_extras(jpd, family, jnp.asarray(fake), jnp.asarray(clean))
    got = gan_trainer.batch_extras_fn(family, tpd)(torch.from_numpy(fake),
                                                   torch.from_numpy(clean))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dim() == 0
        assert float(got[k]) == pytest.approx(want[k], abs=1e-5), k


# ---------------------------------------------------------------------------
# 3. the trainer's extra metrics and test images
def _u8_batches(n_batches, seed=0, n=2, size=HW):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.integers(0, 256, (n, size, size, 3),
                                        dtype=np.uint8))
            for _ in range(n_batches)]


def _trainer(tmp_path, family="denoise", **kw):
    from celebrity_image_denoiser_tpu_torch.cli.train import build_modules

    g, d, p = build_modules(family, (HW, HW),
                            generator=torch.Generator().manual_seed(0))
    cfg = TrainConfig(model=family, num_epochs=2, batch_size=2,
                      image_size=(HW, HW), compute_dtype="float32",
                      checkpoint_dir=str(tmp_path / "ck"),
                      test_image_dir=str(tmp_path / "test_images"))
    return gan_trainer.GANTrainer(g, d, _u8_batches(2), cfg, family=family,
                                  perceptual=p, device="cpu", **kw)


def test_batch_extra_metrics_fill_the_history(tmp_path):
    """As tests/test_train.py:208 asserts for JAX: lpips > 0, 0 < msssim
    ≤ 1 in every epoch (SSIM fills the slot at 16²)."""
    tr = _trainer(tmp_path, extra_metrics="batch")
    hist = tr.train()
    assert len(hist["lpips"]) == len(hist["msssim"]) == 2
    assert all(v > 0 for v in hist["lpips"])
    assert all(0 < v <= 1 for v in hist["msssim"])
    m = tr.step_fn(tr.opt, None, _u8_batches(1, seed=3)[0], tr.noise_gen,
                   1e-4, 1e-4)
    assert {"lpips", "msssim"} <= set(m) and m["lpips"].dim() == 0


def test_epoch_extra_metrics_and_the_test_image(tmp_path):
    """``"epoch"`` samples a 176² test pair through ``generate``: both
    columns filled; the test image equals JAX's ``combine_test_images`` of
    the same arrays, pixel for pixel.  Without a test pair, zeros (as in
    JAX)."""
    noisy, clean = _pair(4, (176, 176, 3), -1.0)
    tr = _trainer(tmp_path, extra_metrics="epoch", test_pair=(noisy, clean))
    hist = tr.train()
    assert all(v > 0 for v in hist["lpips"])
    assert all(0 < v <= 1 for v in hist["msssim"])
    lp, ms = tr._epoch_extras()
    assert (lp, ms) == (pytest.approx(hist["lpips"][-1], abs=1e-7),
                        pytest.approx(hist["msssim"][-1], abs=1e-7))
    path = tmp_path / "test_images" / "testimg_epoch1.jpg"
    assert path.exists()
    fake = tr.generate(noisy[None])[0]
    den = np.clip((fake * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    noi = np.clip((noisy * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    want = io.BytesIO()
    jax_side.combine_test_images(noi, den).save(want, format="JPEG")
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(path)),
                          np.asarray(Image.open(want)))
    # no test pair: the JAX trainer's zeros
    tr2 = _trainer(tmp_path / "b", extra_metrics=True)
    assert tr2._epoch_extras() == (0.0, 0.0)
    tr2.cfg.num_epochs = 1
    assert tr2.train()["lpips"] == [0.0]


def test_esrgan_test_image_is_the_triptych(tmp_path):
    noisy, clean = _pair(5, (HW, HW, 3))
    tr = _trainer(tmp_path, family="esrgan", test_pair=(noisy, clean))
    out = tr.test_random_images(7)
    assert out.endswith("testimg_epoch7.png") and os.path.exists(out)


def test_missing_viz_packages_warn_once_and_train_on(tmp_path, monkeypatch,
                                                     caplog):
    """The card machine has neither PIL nor matplotlib: one warning naming
    the package, no figure, metrics and checkpoints as usual (JAX's CLI
    raises at its last line instead: a difference by design)."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    noisy, clean = _pair(6, (HW, HW, 3), -1.0)
    tr = _trainer(tmp_path, test_pair=(noisy, clean))
    with caplog.at_level("WARNING"):
        hist = tr.train()
    warned = [r for r in caplog.records if "not installed" in r.message]
    assert len(warned) == 1 and "PIL" in warned[0].message
    assert not os.listdir(tmp_path / "test_images")
    assert len(hist["g_loss"]) == 2
    assert os.path.isdir(tmp_path / "ck" / "denoise_epoch_1")
    caplog.clear()
    with caplog.at_level("WARNING"):
        cli_train.plot_history(hist, str(tmp_path / "graphs"))
    assert any("matplotlib" in r.message for r in caplog.records)
    assert not (tmp_path / "graphs").exists()


# ---------------------------------------------------------------------------
# 4. remat
def _one_step(family, remat, buffers_kept=True):
    from celebrity_image_denoiser_tpu_torch.cli.train import build_modules

    g, d, p = build_modules(family, (HW, HW),
                            generator=torch.Generator().manual_seed(0))
    lo = 0.0 if family in gan_trainer.UNIT_FAMILIES else -1.0
    noisy, clean = _pair(7, (2, HW, HW, 3), lo)
    kept = gan_trainer._buffers_kept
    if not buffers_kept:  # the recomputation updates BatchNorm again
        gan_trainer._buffers_kept = lambda m: __import__(
            "contextlib").nullcontext()
    try:
        init, step = gan_trainer.make_train_step(
            g, d, family=family, remat=remat, perceptual=p)
        m = step(init(), torch.from_numpy(noisy), torch.from_numpy(clean),
                 None, 1e-3, 1e-3)
    finally:
        gan_trainer._buffers_kept = kept
    return m, {k: v.clone() for k, v in g.state_dict().items()}


@pytest.mark.parametrize("family", ["denoise", "dncnn", "esrgan", "cgan"])
def test_remat_step_equals_the_plain_step(family):
    """g_loss rtol 1e-6; every parameter and BatchNorm statistic within
    1e-6 (the recomputation's second BatchNorm update is undone; cgan takes
    gradients twice from one forward)."""
    m0, s0 = _one_step(family, False)
    m1, s1 = _one_step(family, True)
    assert float(m1["g_loss"]) == pytest.approx(float(m0["g_loss"]),
                                                rel=1e-6)
    assert float(m1["d_loss"]) == pytest.approx(float(m0["d_loss"]),
                                                rel=1e-6, abs=1e-12)
    for k in s0:
        assert torch.allclose(s0[k].double(), s1[k].double(), rtol=0,
                              atol=1e-6), k


@pytest.mark.parametrize("family", ["dncnn", "esrgan"])
def test_remat_without_the_restore_moves_batchnorm_twice(family):
    """The trap the restore closes: a bare recomputation updates the
    generator's running statistics a second time."""
    _, s0 = _one_step(family, False)
    _, s1 = _one_step(family, True, buffers_kept=False)
    moved = [k for k in s0 if k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked"))
             and not torch.equal(s0[k], s1[k])]
    assert moved


# ---------------------------------------------------------------------------
# 5. the training CLI's flags, profiling, plots
@pytest.fixture()
def png_dir(tmp_path):
    r = np.random.default_rng(0)
    d = tmp_path / "clean"
    d.mkdir()
    for i in range(10):
        (d / f"{i:02d}.png").write_bytes(imageio.encode_png(
            r.integers(0, 256, (20, 20, 3), dtype=np.uint8)))
    return d


def test_cli_train_extra_flags(png_dir, tmp_path):
    """``--extra-metrics batch --remat --profile-dir --graph-dir``: the
    history's extra columns are real, the trace parses as JSON, the plots
    are JAX's file names."""
    import json

    tr = cli_train.run([
        "--clean-dir", str(png_dir), "--image-size", "16", "16",
        "--batch-size", "4", "--num-epochs", "1", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ck"), "--extra-metrics",
        "batch", "--remat", "--profile-dir", str(tmp_path / "prof"),
        "--graph-dir", str(tmp_path / "graphs")])
    assert tr.cfg.remat and tr.extra_metrics == "batch"
    assert tr.metric_history["lpips"][0] > 0
    assert 0 < tr.metric_history["msssim"][0] <= 1
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    events = json.loads((tmp_path / "prof" / traces[0]).read_text())
    assert events["traceEvents"]
    assert sorted(os.listdir(tmp_path / "graphs")) == sorted(
        [f"{m}.png" for m in training_plots._METRICS]
        + ["training_results.png"])


def test_plot_metrics_writes_the_jax_files(tmp_path):
    hist = {"g_loss": [1.0, 0.5], "d_loss": [0.7, 0.6], "psnr": [20, 21],
            "ssim": [0.5, 0.6], "lpips": [], "msssim": [0.8, 0.9]}
    jax_plots.plot_metrics(hist, str(tmp_path / "jax"))
    training_plots.plot_metrics(hist, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_profiling_matches_jax_contract(tmp_path):
    import json

    with profiling.trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    (f,) = os.listdir(tmp_path / "t")
    assert json.loads((tmp_path / "t" / f).read_text())["traceEvents"]
    jt, pt = jax_profiling.StepTimer(), profiling.StepTimer()
    assert pt.summary() == jt.summary() == {}
    for timer, fence in ((jt, {"a": jnp.ones(3)}),
                         (pt, {"a": [torch.ones(3)]})):
        timer.start()
        timer.stop(fence, items=4)
    assert set(pt.summary()) == set(jt.summary())
    assert pt.summary()["steps"] == 1 and pt.summary()["items_per_s"] > 0


def test_debug_nans_raises_on_a_nan_backward_and_restores():
    x = torch.tensor([-1.0], requires_grad=True)
    before = torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="nan"):
        with profiling.debug_nans():
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == before
