"""GAN trainer of the denoise family.

Port of ``celebrity_image_denoiser_tpu/train/gan_trainer.py`` for
``family="denoise"`` (:229-285): alternating D/G Adam steps.  D sees
BCE(real→1) + BCE(fake→0) with the fake detached; G then optimises
MSE + ``adv_weight``·BCE(fake→1) **through the already-updated D**.  The
generator forward is computed once per step and reused for the D step, the G
step and the content loss; D forwards three times per step (real, detached
fake, fake again after its update) and each forward updates its BatchNorm
running statistics.

What differs from the JAX step, and why:

* PyTorch runs eagerly and the modules own their parameters, so
  ``step_fn`` updates the generator, the discriminator and both optimiser
  states **in place** instead of returning a new carry.
* No kernel of the JAX package has a backward and its trainer differentiates
  through XLA's convs (:168-171), so the step runs the generator by
  ``route="autograd"`` (PyTorch's differentiable convs) and launches none of
  the conv kernels; ``generate`` and ``evaluate_dataset`` run the generator
  under ``torch.inference_mode()`` by ``route="kernel"``.
* Mixed precision (``compute_dtype="bfloat16"``, :120-142) is written out as
  explicit casts at the model boundary, not ``torch.autocast``: parameters,
  optimiser state, losses and metrics stay float32; the layers cast their
  weights to the activation dtype at use.
* With ``on_the_fly_noise`` the step takes the clean batch as uint8 NHWC
  and ``data/noise.py::random_noise_batch`` makes the noisy input and the
  clean target in one launch of the noise kernel, with no host read
  (:189-208).

PSNR/SSIM are computed on the device inside the step and returned as device
scalars; the loop reads them once per epoch (:582-600).

Waiting for later slices: ``mesh=``, ``remat``, ``extras_fn`` /
``extra_metrics`` and ``test_random_images`` (ROADMAP.md queue 1 items
12-14), and the other families (item 11), which raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as ckpt_lib
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.core.config import (
    FAMILY_NOISE_VARIANT,
    TrainConfig,
)
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
from celebrity_image_denoiser_tpu_torch.metrics import psnr, ssim
from celebrity_image_denoiser_tpu_torch.train import losses as L
from celebrity_image_denoiser_tpu_torch.train import optim
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.train")

FAMILIES = ("denoise", "srgan", "esrgan", "cgan", "dncnn")
_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def _require_denoise(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; choose from {FAMILIES}")
    if family != "denoise":
        raise NotImplementedError(
            f"the {family} family is not ported yet (ROADMAP.md queue 1 "
            "item 11); this trainer runs family='denoise'")


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def family_eval_metrics(family: str, fake: torch.Tensor, clean: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean PSNR/SSIM of NHWC batches in the family's reference convention
    (``data_range=2.0`` on the [-1, 1] tanh families), as device scalars."""
    _require_denoise(family)
    return (psnr(fake, clean, data_range=2.0).mean(),
            ssim(fake, clean, data_range=2.0).mean())


def make_train_step(
    generator: torch.nn.Module,
    discriminator: torch.nn.Module,
    *,
    family: str = "denoise",
    adv_weight: float = 0.001,
    adam_b1: float = 0.9,
    adam_b2: float = 0.999,
    on_the_fly_noise: bool = False,
    noise_variant: int = 1,
    compute_dtype: Optional[str] = None,
):
    """Build ``(init_fn, step_fn)``.

    ``init_fn() -> (g_opt, d_opt)``: fresh Adam states for the two modules.

    ``step_fn(opt, noisy, clean, gen, lr_g, lr_d) -> metrics`` runs one
    training step, updating the modules and ``opt`` in place.  ``noisy`` and
    ``clean`` are float32 NHWC in [-1, 1].  With ``on_the_fly_noise``,
    ``noisy`` is ignored, ``clean`` is **uint8** NHWC and the noise is drawn
    from the ``torch.Generator`` ``gen`` on the batch's device.  ``metrics``
    holds ``g_loss``, ``d_loss``, ``psnr`` and ``ssim`` as device scalars
    (no host sync) and, on the fly, ``noise_kinds``: the kind index each
    sample drew, an int64 tensor on the device."""
    _require_denoise(family)
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype!r}")
    cdt = _DTYPES[compute_dtype]
    adam_init, adam_update = optim.adam(adam_b1, adam_b2)
    g_params = dict(generator.named_parameters())
    d_params = dict(discriminator.named_parameters())

    def g_fwd(x):
        return generator(x.to(cdt), route="autograd").float()

    def d_fwd(x):
        return discriminator(x.to(cdt)).float()

    def init_fn():
        return adam_init(g_params), adam_init(d_params)

    def step_fn(opt, noisy, clean, gen, lr_g, lr_d) -> Dict[str, object]:
        g_opt, d_opt = opt
        out: Dict[str, object] = {}
        if on_the_fly_noise:
            noisy, clean, out["noise_kinds"] = noise_lib.random_noise_batch(
                gen, clean, variant=noise_variant)
        x, y = _nchw(noisy), _nchw(clean)
        generator.train()
        discriminator.train()

        # ---- discriminator loss and step (fake detached) -------------------
        with torch.enable_grad():
            fake = g_fwd(x)
            real_pred = d_fwd(y)
            fake_pred = d_fwd(fake.detach())
            d_loss = L.bce(real_pred, 1.0) + L.bce(fake_pred, 0.0)
            d_grads = torch.autograd.grad(d_loss, list(d_params.values()))
        adam_update(dict(zip(d_params, d_grads)), d_opt, d_params, lr_d)

        # ---- generator loss through the updated D, and step ----------------
        with torch.enable_grad():
            fake_pred = d_fwd(fake)
            g_loss = L.mse(fake, y) + adv_weight * L.bce(fake_pred, 1.0)
            g_grads = torch.autograd.grad(g_loss, list(g_params.values()))
        adam_update(dict(zip(g_params, g_grads)), g_opt, g_params, lr_g)

        with torch.no_grad():
            fake_nhwc = fake.detach().permute(0, 2, 3, 1)
            psnr_v, ssim_v = family_eval_metrics(family, fake_nhwc, clean)
        out.update(g_loss=g_loss.detach(), d_loss=d_loss.detach(),
                   psnr=psnr_v, ssim=ssim_v)
        return out

    return init_fn, step_fn


class GANTrainer:
    """Host-side training loop: epochs over a DataPipeline, per-epoch StepLR,
    checkpoint cadence, best-PSNR tracking, metric history and resume — the
    contract of the JAX ``GANTrainer`` (:315-650).

    ``pipeline`` yields uint8 NHWC clean batches (``cfg.on_the_fly_noise``)
    or ``(noisy, clean)`` float32 NHWC pairs, on ``device``.  The modules
    are moved to ``device`` (the card unless the caller names the CPU) and
    stay float32."""

    def __init__(
        self,
        generator: torch.nn.Module,
        discriminator: torch.nn.Module,
        pipeline,
        cfg: TrainConfig = TrainConfig(),
        *,
        family: Optional[str] = None,
        val_pipeline=None,
        device="cuda",
    ):
        self.cfg = cfg
        self.family = family or cfg.model
        _require_denoise(self.family)
        if cfg.remat:
            raise NotImplementedError(
                "remat is not ported yet (ROADMAP.md queue 1 item 12)")
        self.device = resolve_device(device)
        self.generator = generator.to(self.device, torch.float32)
        self.discriminator = discriminator.to(self.device, torch.float32)
        if self.device.type == "cuda":
            self.generator.to(memory_format=torch.channels_last)
            self.discriminator.to(memory_format=torch.channels_last)
        self.pipeline = pipeline
        self.val_pipeline = val_pipeline

        self.init_fn, self.step_fn = make_train_step(
            self.generator, self.discriminator,
            family=self.family,
            adv_weight=cfg.adv_weight,
            adam_b1=cfg.betas[0],
            adam_b2=cfg.betas[1],
            on_the_fly_noise=cfg.on_the_fly_noise,
            noise_variant=cfg.noise_variant
            or FAMILY_NOISE_VARIANT.get(self.family, 1),
            compute_dtype=cfg.compute_dtype,
        )
        self.opt = self.init_fn()
        self.schedule_g = optim.step_lr(cfg.lr, cfg.step_lr_step_size,
                                        cfg.step_lr_gamma)
        self.schedule_d = optim.step_lr(cfg.lr, cfg.step_lr_step_size,
                                        cfg.step_lr_gamma)
        self.start_epoch = 0
        self.best_psnr = 0.0
        self.metric_history: Dict[str, list] = {
            k: [] for k in ("g_loss", "d_loss", "psnr", "ssim", "lpips",
                            "msssim")}
        # the noise stream: seeded cfg.seed + 1 like the JAX key stream
        self.noise_gen = torch.Generator(device=self.device)
        self.noise_gen.manual_seed(cfg.seed + 1)
        # steps run, and how many samples of each step drew gaussian (kept
        # on the device during an epoch, read with its metrics)
        self.steps = 0
        self.gaussian_counts: List[int] = []

    @property
    def steps_with_gaussian(self) -> int:
        """Steps in which a sample drew gaussian."""
        return sum(1 for c in self.gaussian_counts if c)

    # ---- checkpointing ------------------------------------------------------
    def _sections(self) -> Dict[str, object]:
        g_params, g_state = convert.state_dict_to_jax_params(
            self.generator.state_dict())
        d_params, d_state = convert.state_dict_to_jax_params(
            self.discriminator.state_dict())
        sections: Dict[str, object] = {
            "generator": g_params, "generator_state": g_state,
            "discriminator": d_params, "discriminator_state": d_state}
        for name, st in zip(("g_optimizer", "d_optimizer"), self.opt):
            sections[name] = {
                "step": np.asarray(st.step, np.int32),
                "mu": convert.state_dict_to_jax_params(st.mu)[0],
                "nu": convert.state_dict_to_jax_params(st.nu)[0]}
        return sections

    def save_checkpoint(self, epoch: int, is_best: bool = False) -> None:
        """Cadence of ``gan_trainer.py:430-438``: first, last and even
        epochs, plus ``best/`` on a new best PSNR; written off-thread."""
        cfg = self.cfg
        regular = epoch == 0 or epoch == cfg.num_epochs - 1 or epoch % 2 == 0
        if not (regular or is_best):
            return
        sections = self._sections()
        meta = {"epoch": epoch, "best_psnr": self.best_psnr,
                "metric_history": self.metric_history, "family": self.family}
        name = f"{self.family}_epoch_{epoch}"
        if regular:
            ckpt_lib.save_checkpoint(os.path.join(cfg.checkpoint_dir, name),
                                     sections, meta, async_write=True)
        if is_best:
            ckpt_lib.save_checkpoint(
                os.path.join(cfg.checkpoint_dir, "best", name), sections,
                meta, async_write=True)

    def resume(self, path: Optional[str] = None) -> int:
        """Restore the trainer's state from ``path`` (default: the newest
        checkpoint under ``cfg.checkpoint_dir``); returns the next epoch."""
        if path is None:
            path = ckpt_lib.latest_checkpoint(self.cfg.checkpoint_dir,
                                              prefix=f"{self.family}_")
        if path is None:
            return 0
        sections, meta = ckpt_lib.load_checkpoint(path)
        convert.load_jax_trees(self.generator, sections["generator"],
                               sections.get("generator_state"))
        convert.load_jax_trees(self.discriminator, sections["discriminator"],
                               sections.get("discriminator_state"))
        for name, st in zip(("g_optimizer", "d_optimizer"), self.opt):
            sec = sections.get(name)
            if not sec:
                continue
            st.step = int(sec["step"])
            for moments, key in ((st.mu, "mu"), (st.nu, "nu")):
                loaded = convert.jax_params_to_state_dict(sec[key])
                if set(loaded) != set(moments):
                    raise KeyError(f"{path}: {name}.{key} does not match the "
                                   "model's parameters")
                with torch.no_grad():
                    for k, v in loaded.items():
                        moments[k].copy_(v)
        self.best_psnr = float(meta.get("best_psnr", 0.0))
        hist = meta.get("metric_history")
        if hist:
            self.metric_history = {k: list(v) for k, v in hist.items()}
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        logger.info("resumed from %s at epoch %d", path, self.start_epoch)
        return self.start_epoch

    # ---- evaluation helpers -------------------------------------------------
    def _eval_forward(self, noisy_nhwc: torch.Tensor) -> torch.Tensor:
        """Eval-mode forward through the conv kernels; NHWC in and out."""
        self.generator.eval()
        x = noisy_nhwc.to(self.device, torch.float32)
        return self.generator(_nchw(x), route="kernel").permute(0, 2, 3, 1)

    @torch.inference_mode()
    def generate(self, noisy: np.ndarray) -> np.ndarray:
        """float32 NHWC in [-1, 1] → the generator's output, on the host."""
        return self._eval_forward(torch.as_tensor(noisy)).cpu().numpy()

    @torch.inference_mode()
    def evaluate_dataset(self, pipeline) -> Dict[str, float]:
        """Held-out evaluation: mean PSNR/SSIM over a pipeline of (noisy,
        clean) float32 NHWC batches, on the device."""
        vals = []
        for batch in pipeline:
            if not isinstance(batch, tuple):
                raise ValueError(
                    "evaluate_dataset needs (noisy, clean) pair batches; a "
                    "clean-only pipeline would measure identity "
                    "reconstruction, not denoising")
            noisy, clean = (torch.as_tensor(b) for b in batch)
            fake = self._eval_forward(noisy)
            vals.append(torch.stack(family_eval_metrics(
                self.family, fake, clean.to(self.device, torch.float32))))
        if not vals:
            return {"psnr": 0.0, "ssim": 0.0, "batches": 0}
        arr = torch.stack(vals).double().mean(dim=0).tolist()
        return {"psnr": arr[0], "ssim": arr[1], "batches": len(vals)}

    # ---- the loop -----------------------------------------------------------
    def train(self, epoch_callback: Optional[Callable] = None):
        try:
            return self._train_loop(epoch_callback)
        finally:
            # flush the async checkpoint writers even on an exception
            ckpt_lib.wait_for_saves()

    def _train_loop(self, epoch_callback: Optional[Callable] = None):
        cfg = self.cfg
        gaussian = (noise_lib.NOISE_TYPES.index("gaussian")
                    if cfg.on_the_fly_noise else None)
        for epoch in range(self.start_epoch, cfg.num_epochs):
            lr_g, lr_d = self.schedule_g(epoch), self.schedule_d(epoch)
            # metrics stay on the device during the epoch: no per-step sync
            step_metrics, step_kinds = [], []
            t0 = time.perf_counter()
            for batch in self.pipeline:
                noisy, clean = batch if isinstance(batch, tuple) \
                    else (None, batch)
                m = self.step_fn(self.opt, noisy, clean, self.noise_gen,
                                 lr_g, lr_d)
                kinds = m.pop("noise_kinds", None)
                self.steps += 1
                if kinds is not None:
                    step_kinds.append(kinds)
                step_metrics.append(m)
            if step_kinds:  # one read for the epoch
                self.gaussian_counts.extend(torch.stack(
                    [(k == gaussian).sum() for k in step_kinds]).tolist())
            n_batches = len(step_metrics)
            if n_batches == 0:
                logger.warning("Epoch [%d/%d] No valid batches processed.",
                               epoch + 1, cfg.num_epochs)
                continue
            stacked = {k: torch.stack([m[k] for m in step_metrics])
                       for k in step_metrics[0]}
            avgs = {k: float(v.double().sum().item()) / n_batches
                    for k, v in stacked.items()}
            dt = time.perf_counter() - t0
            if not all(np.isfinite(v) for v in avgs.values()):
                # a NaN/Inf epoch means diverged training: stop before the
                # bad parameters overwrite good checkpoints
                logger.error(
                    "Epoch [%d/%d] produced non-finite metrics %s — stopping "
                    "(resume from the last checkpoint).",
                    epoch + 1, cfg.num_epochs, avgs)
                break
            for k in ("g_loss", "d_loss", "psnr", "ssim"):
                self.metric_history[k].append(avgs[k])
            self.metric_history["lpips"].append(0.0)   # extra metrics wait
            self.metric_history["msssim"].append(0.0)
            logger.info(
                "Epoch [%d/%d] G %.4f D %.4f | PSNR %.3f SSIM %.4f | "
                "%.1f img/s", epoch + 1, cfg.num_epochs, avgs["g_loss"],
                avgs["d_loss"], avgs["psnr"], avgs["ssim"],
                n_batches * cfg.batch_size / max(dt, 1e-9))
            if self.val_pipeline is not None:
                val = self.evaluate_dataset(self.val_pipeline)
                logger.info(
                    "Epoch [%d/%d] val PSNR %.3f SSIM %.4f (%d batches)",
                    epoch + 1, cfg.num_epochs, val["psnr"], val["ssim"],
                    val["batches"])
            is_best = avgs["psnr"] > self.best_psnr
            if is_best:
                self.best_psnr = avgs["psnr"]
            self.save_checkpoint(epoch, is_best)
            if epoch_callback is not None:
                epoch_callback(self, epoch, avgs)
        return self.metric_history
