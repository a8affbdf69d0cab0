"""GAN trainers of the five families — one step function per family.

Port of ``celebrity_image_denoiser_tpu/train/gan_trainer.py``
(``make_train_step:73-312``, ``GANTrainer:315-650``), branch by branch:

* **denoise** (:229-285): alternating D/G Adam steps.  D sees BCE(real→1)
  + BCE(fake→0) with the fake detached; G then optimises MSE +
  ``adv_weight``·BCE(fake→1) **through the already-updated D**.
* **srgan**: the same skeleton with the VGG perceptual loss
  (``train/losses.py::make_vgg_perceptual``) as the content loss; on the
  fly the noisy HR batch is downscaled by ``sr_scale`` (bicubic with
  antialias, ``ops/resize.py``, as ``jax.image.resize``) into the LR input
  (:201-207).
* **esrgan**: BCE-with-logits, D's loss halved (:173, :237-238); trains on
  [0, 1].
* **cgan** (:244-263): the *joint* update — G's gradient against the
  pre-update D, G = BCE(fake→1) + ``cgan_mae_weight``·MAE, both Adam steps
  Keras' (``train/optim.py::adam_keras``).
* **dncnn** (:212-227): MSE only, no discriminator (``d_loss`` 0), on
  [0, 1]; on the fly the blind-σ Gaussian unless a ``noise_variant`` is
  given (the JAX factory's ``dncnn_blind``, :193).

The generator forward is computed once per step and reused by every loss
that reads it.  D forwards three times in an alternating step (real,
detached fake, fake again after its update) and each forward updates its
BatchNorm running statistics.  cgan's D forwards twice, real and fake, and
its fake forward serves both gradients — D's loss and G's (through the
pre-update D): the JAX step's extra D forward for G's gradient has the same
output in train mode (batch statistics) and its BatchNorm state is
discarded (:258-263), so D's Keras BatchNorm takes exactly two updates per
step here without one.

What differs from the JAX step, and why:

* PyTorch runs eagerly and the modules own their parameters, so
  ``step_fn`` updates the generator, the discriminator and both optimiser
  states **in place** instead of returning a new carry.
* No kernel of the JAX package has a backward and its trainer differentiates
  through XLA's convs (:168-171), so the step runs the generator by
  ``route="autograd"`` (PyTorch's differentiable convs) and launches none of
  the conv kernels; ``generate`` and ``evaluate_dataset`` run the generator
  under ``torch.inference_mode()`` by ``route="kernel"``.
* Mixed precision (``compute_dtype="bfloat16"``, :120-166) is written out as
  explicit casts at the model boundary, not ``torch.autocast``: parameters,
  optimiser state, losses and metrics stay float32; the layers cast their
  weights to the activation dtype at use; the VGG tower runs in bfloat16 and
  its MSE is reduced in float32.
* With ``on_the_fly_noise`` the step takes the clean batch as uint8 NHWC
  and ``data/noise.py`` makes the noisy input and the clean target in one
  launch of the noise kernel, with no host read (:189-210), in the family's
  domain: [-1, 1] for denoise and cgan, [0, 1] for esrgan and dncnn, and
  for srgan [0, 1] before the downscale, then ``·2 − 1``.

PSNR/SSIM are computed on the device inside the step and returned as device
scalars; the loop reads them once per epoch (:582-600).  ``extras_fn`` adds
metrics of its own to them the same way (:225-226, 283-284): the trainer's
``extra_metrics="batch"`` puts the perceptual distance and MS-SSIM of every
batch there, and ``"epoch"`` samples the test pair once an epoch instead
(:546-566).

``remat`` recomputes the generator's train-mode forward in the backward
(``torch.utils.checkpoint``, non-reentrant; JAX: ``jax.checkpoint``,
:165-171).  The recomputation runs BatchNorm in train mode a second time,
which would update its running statistics twice, where the functional JAX
step returns the state once; so every buffer of the generator is restored
after each recomputation, and a step takes the same statistics with
``remat`` as without.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``, ``parallel/mesh.py::
process_mesh``) is data parallelism, one process per rank (JAX: one jit
over the global batch with the batch sharded over ``data``, :288-297).
Each rank steps on its share of the global batch (``rank`` = its
coordinates flattened, ``world`` = the mesh's size; a 2-D
``("replica", "data")`` mesh shares the batch over both axes, as JAX's
``P(("replica", "data"))``):

* on the fly, every rank draws the global batch's noise kinds and seed and
  launches the noise kernel at its first sample (``data/noise.py``), so its
  noisy rows are those of the single-process draw, bit for bit;
* every BatchNorm of G and D takes its train-mode statistics over the mesh
  (``ops/norm.py::set_batch_norm_group``), as JAX's over the global batch;
* each rank's losses are scaled by ``1/world`` before the backward and the
  gradients summed over the mesh (one all-reduce of the flattened
  gradients per optimiser step, over each axis in turn): the sum is the
  global batch's gradient, and every rank takes the same Adam step;
* the metrics are averaged over the mesh (``psum_mean``).

``GANTrainer(mesh=)`` broadcasts the parameters, statistics and optimiser
states from rank 0 when it is built and after a resume, and only rank 0
writes checkpoints and test images, which are the single-process
trainer's files: they resume with or without a mesh, in either package.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.device_mesh import DeviceMesh

from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as ckpt_lib
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.core.config import (
    FAMILY_NOISE_VARIANT,
    TrainConfig,
)
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
from celebrity_image_denoiser_tpu_torch.metrics import (
    PerceptualDistance,
    ms_ssim,
    psnr,
    ssim,
    ssim_tf,
)
from celebrity_image_denoiser_tpu_torch.metrics.msssim import min_size
from celebrity_image_denoiser_tpu_torch.ops.norm import set_batch_norm_group
from celebrity_image_denoiser_tpu_torch.ops.resize import resize
from celebrity_image_denoiser_tpu_torch.parallel import collectives
from celebrity_image_denoiser_tpu_torch.parallel.mesh import (
    axis_groups,
    shard_count,
    shard_index,
)
from celebrity_image_denoiser_tpu_torch.train import losses as L
from celebrity_image_denoiser_tpu_torch.train import optim
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.train")

FAMILIES = ("denoise", "srgan", "esrgan", "cgan", "dncnn")
UNIT_FAMILIES = ("esrgan", "dncnn")  # train on [0, 1]; the rest on [-1, 1]
# float64 runs the modules' forward and backward in double precision (the
# losses stay float32): a reference that the f32 step's gradients are held
# against, since a deep BatchNorm net's f32 gradient is only as exact as its
# conditioning allows (chip_smoke.py phase 9)
_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float64": torch.float64}


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; choose from {FAMILIES}")


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def family_eval_metrics(family: str, fake: torch.Tensor, clean: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean PSNR/SSIM of NHWC batches in the family's reference convention
    (:56-70), as device scalars: clamped [0, 1] with ``data_range=1.0`` for
    esrgan and dncnn; ``ssim_tf`` (``tf.image.ssim``) with ``max_val=2.0``
    for cgan; ``data_range=2.0`` for the other tanh families."""
    _check_family(family)
    if family in UNIT_FAMILIES:
        f, c = fake.clamp(0.0, 1.0), clean.clamp(0.0, 1.0)
        return (psnr(f, c, data_range=1.0).mean(),
                ssim(f, c, data_range=1.0).mean())
    if family == "cgan":
        return (psnr(fake, clean, data_range=2.0).mean(),
                ssim_tf(fake, clean, max_val=2.0).mean())
    return (psnr(fake, clean, data_range=2.0).mean(),
            ssim(fake, clean, data_range=2.0).mean())


def to_unit(family: str, t: torch.Tensor) -> torch.Tensor:
    """A family-domain tensor on [0, 1], clipped (the extra metrics'
    domain, :357-363)."""
    if family not in UNIT_FAMILIES:
        t = t * 0.5 + 0.5
    return t.clamp(0.0, 1.0)


def batch_extras_fn(family: str, pd: PerceptualDistance) -> Callable:
    """The JAX trainer's per-batch ``extras_fn`` (:357-371): ``lpips`` (the
    mean perceptual distance) and ``msssim`` of ``(fake, clean)`` in
    ``family``'s domain, clipped to [0, 1], as device scalars; below
    MS-SSIM's 176 px SSIM (``data_range=1.0``) fills the ``msssim`` slot, as
    the JAX step decides by shape."""
    def extras_fn(fake, clean):
        f01, c01 = to_unit(family, fake), to_unit(family, clean)
        out = {"lpips": pd(f01, c01).mean()}
        if min(f01.shape[1], f01.shape[2]) >= min_size():
            out["msssim"] = ms_ssim(f01, c01, data_range=1.0).mean()
        else:
            out["msssim"] = ssim(f01, c01, data_range=1.0).mean()
        return out
    return extras_fn


@contextlib.contextmanager
def _buffers_kept(module: torch.nn.Module):
    """Restore every buffer of ``module`` (BatchNorm's running statistics
    and batch count) on exit."""
    saved = [(b, b.detach().clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def make_train_step(
    generator: torch.nn.Module,
    discriminator: Optional[torch.nn.Module],
    *,
    family: str = "denoise",
    adv_weight: float = 0.001,
    cgan_mae_weight: float = 100.0,
    perceptual: Optional[Callable] = None,
    adam_b1: float = 0.9,
    adam_b2: float = 0.999,
    on_the_fly_noise: bool = False,
    noise_variant: Optional[int] = None,
    sr_scale: int = 1,
    compute_dtype: Optional[str] = None,
    mesh=None,
    remat: bool = False,
    extras_fn: Optional[Callable] = None,
):
    """Build ``(init_fn, step_fn)``.

    ``init_fn() -> (g_opt, d_opt)``: fresh Adam states for the two modules
    (Keras' Adam for cgan; ``d_opt`` empty without a discriminator).

    ``step_fn(opt, noisy, clean, gen, lr_g, lr_d) -> metrics`` runs one
    training step, updating the modules and ``opt`` in place.  ``noisy``
    and ``clean`` are float32 NHWC in the family's domain (srgan: ``noisy``
    the LR batch).  With ``on_the_fly_noise``, ``noisy`` is ignored,
    ``clean`` is **uint8** NHWC and the noise is drawn from the
    ``torch.Generator`` ``gen`` on the batch's device.  ``metrics`` holds
    ``g_loss``, ``d_loss``, ``psnr`` and ``ssim`` as device scalars (no host
    sync) and, on the fly with a noise variant, ``noise_kinds``: the kind
    index each sample drew, an int64 tensor on the device.

    ``noise_variant`` None is the family's own input stage: the blind-σ
    Gaussian for dncnn, ``FAMILY_NOISE_VARIANT`` for the others.

    ``perceptual`` (srgan's content loss, ``make_vgg_perceptual``) takes
    NCHW tensors.  ``remat`` recomputes the generator's forward in the
    backward, its BatchNorm statistics updated once.  ``extras_fn(fake,
    clean) -> dict`` (NHWC, the family's domain, no gradient) adds device
    scalars to ``metrics``.

    ``mesh``: a ``DeviceMesh`` over the ranks of a data-parallel run (the
    module docstring); ``noisy`` and ``clean`` are then this rank's share
    of the global batch, and the metrics the global batch's."""
    _check_family(family)
    if compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32, bfloat16 or "
                         f"float64, got {compute_dtype!r}")
    if family == "srgan" and perceptual is None:
        raise ValueError("the srgan family needs a perceptual loss "
                         "(make_vgg_perceptual)")
    if family != "dncnn" and discriminator is None:
        raise ValueError(f"the {family} family needs a discriminator")
    cdt = _DTYPES[compute_dtype]
    adam_init, adam_update = (optim.adam_keras if family == "cgan"
                              else optim.adam)(adam_b1, adam_b2)
    d_crit = L.bce_with_logits if family == "esrgan" else L.bce
    unit = family in UNIT_FAMILIES
    blind = family == "dncnn" and noise_variant is None
    if noise_variant is None:
        noise_variant = FAMILY_NOISE_VARIANT[family]
    g_params = dict(generator.named_parameters())
    d_params = (dict(discriminator.named_parameters())
                if family != "dncnn" and discriminator is not None else {})
    groups, rank, world = None, 0, 1
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(parallel.mesh.process_mesh), got "
                            f"{type(mesh).__name__}")
        groups = axis_groups(mesh)
        rank, world = shard_index(mesh), shard_count(mesh)
        for m in (generator, discriminator if d_params else None):
            if m is not None:
                set_batch_norm_group(m, groups)

    def g_apply(x):
        return generator(x.to(cdt), route="autograd").float()

    def g_fwd(x):
        if not remat:
            return g_apply(x)
        return torch.utils.checkpoint.checkpoint(
            g_apply, x, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                _buffers_kept(generator)))

    def d_fwd(x):
        return discriminator(x.to(cdt)).float()

    def content_loss(fake, y):
        if family == "srgan":
            return perceptual(fake.to(cdt), y.to(cdt)).float()
        if family == "cgan":
            return L.mae(fake, y)
        return L.mse(fake, y)

    def inputs(clean_u8, gen, out):
        """The noisy input and the clean target of an on-the-fly step, NHWC
        in the family's domain (srgan: the noisy side downscaled)."""
        domain = "unit" if unit or sr_scale > 1 else "tanh"
        if blind:
            noisy, clean = noise_lib.blind_gaussian_batch(
                gen, clean_u8, domain=domain, rank=rank, world=world)
        else:
            noisy, clean, out["noise_kinds"] = noise_lib.random_noise_batch(
                gen, clean_u8, variant=noise_variant, domain=domain,
                rank=rank, world=world)
        if sr_scale > 1:
            n, h, w, c = noisy.shape
            noisy = resize(noisy, (h // sr_scale, w // sr_scale), "bicubic")
        if domain == "unit" and not unit:
            noisy, clean = noisy * 2.0 - 1.0, clean * 2.0 - 1.0
        return noisy, clean

    def init_fn():
        return adam_init(g_params), adam_init(d_params)

    def grads_of(loss, params, retain=False):
        """The gradient of the global batch's ``loss``: under a mesh this
        rank's share scaled by 1/world, summed over the mesh."""
        if groups is None:
            return dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), retain_graph=retain)))
        grads = torch.autograd.grad(loss / world, list(params.values()),
                                    retain_graph=retain)
        flat = collectives.psum(torch.cat([g.reshape(-1) for g in grads]),
                                groups)
        return dict(zip(params, (f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads))))

    def mean_over_mesh(out):
        """The device scalars of ``out`` averaged over the mesh, in one
        all-reduce (the kinds stay this rank's)."""
        keys = [k for k in out if k != "noise_kinds"]
        vals = collectives.psum_mean(torch.stack([out[k].float()
                                                  for k in keys]), groups)
        out.update(zip(keys, vals.unbind()))

    def step_fn(opt, noisy, clean, gen, lr_g, lr_d) -> Dict[str, object]:
        g_opt, d_opt = opt
        out: Dict[str, object] = {}
        if on_the_fly_noise:
            noisy, clean = inputs(clean, gen, out)
        x, y = _nchw(noisy), _nchw(clean)
        generator.train()
        if d_params:
            discriminator.train()

        if family == "dncnn":
            # plain supervised MSE on the residual denoiser (no D)
            with torch.enable_grad():
                fake = g_fwd(x)
                g_loss = L.mse(fake, y)
                g_grads = grads_of(g_loss, g_params)
            adam_update(g_grads, g_opt, g_params, lr_g)
            d_loss = torch.zeros((), device=fake.device)
        elif family == "cgan":
            # joint update: both gradients against the pre-update D, from
            # one forward of D on the fake
            with torch.enable_grad():
                fake = g_fwd(x)
                real_pred = d_fwd(y)
                fake_pred = d_fwd(fake)
                d_loss = d_crit(real_pred, 1.0) + d_crit(fake_pred, 0.0)
                g_loss = d_crit(fake_pred, 1.0) + cgan_mae_weight * \
                    content_loss(fake, y)
                d_grads = grads_of(d_loss, d_params, retain=True)
                g_grads = grads_of(g_loss, g_params)
            adam_update(d_grads, d_opt, d_params, lr_d)
            adam_update(g_grads, g_opt, g_params, lr_g)
        else:
            # ---- discriminator loss and step (fake detached) ---------------
            with torch.enable_grad():
                fake = g_fwd(x)
                real_pred = d_fwd(y)
                fake_pred = d_fwd(fake.detach())
                d_loss = d_crit(real_pred, 1.0) + d_crit(fake_pred, 0.0)
                if family == "esrgan":
                    d_loss = 0.5 * d_loss  # esrgan_train.py:110
                d_grads = grads_of(d_loss, d_params)
            adam_update(d_grads, d_opt, d_params, lr_d)
            # ---- generator loss through the updated D, and step ------------
            with torch.enable_grad():
                fake_pred = d_fwd(fake)
                g_loss = content_loss(fake, y) + adv_weight * d_crit(
                    fake_pred, 1.0)
                g_grads = grads_of(g_loss, g_params)
            adam_update(g_grads, g_opt, g_params, lr_g)

        with torch.no_grad():
            fake_nhwc = fake.detach().permute(0, 2, 3, 1)
            psnr_v, ssim_v = family_eval_metrics(family, fake_nhwc, clean)
            out.update(g_loss=g_loss.detach(), d_loss=d_loss.detach(),
                       psnr=psnr_v, ssim=ssim_v)
            if extras_fn is not None:
                out.update(extras_fn(fake_nhwc, clean))
            if groups is not None:
                mean_over_mesh(out)
        return out

    return init_fn, step_fn


class GANTrainer:
    """Host-side training loop: epochs over a DataPipeline, per-epoch StepLR,
    checkpoint cadence, best-PSNR tracking, metric history and resume — the
    contract of the JAX ``GANTrainer`` (:315-650), for every family.

    ``pipeline`` yields uint8 NHWC clean batches (``cfg.on_the_fly_noise``)
    or ``(noisy, clean)`` float32 NHWC pairs in the family's domain, on
    ``device``.  The modules (and srgan's ``perceptual`` loss) are moved to
    ``device`` (the card unless the caller names the CPU) and stay float32.
    ``discriminator`` is None for dncnn.  srgan's ``sr_scale`` is the
    generator's ``scale_factor``; dncnn trains on the blind-σ Gaussian when
    ``cfg.noise_variant`` is None, on that variant otherwise.

    ``test_pair``: a held-out (noisy, clean) pair, HWC or NHWC float32 in
    the family's domain; with it the loop writes a test image into
    ``cfg.test_image_dir`` every epoch (``test_random_images``).
    ``extra_metrics``: False, True or ``"epoch"`` (the perceptual distance
    and MS-SSIM of the test pair once an epoch; 0 without one), or
    ``"batch"`` (of every batch, inside the step) — the history's ``lpips``
    and ``msssim`` columns.

    ``mesh``: a ``DeviceMesh`` of a data-parallel run (``make_train_step``);
    ``pipeline`` then yields this rank's share of each global batch
    (``DataPipeline(rank=, world=)``), the modules and optimiser states are
    broadcast from rank 0 here and after ``resume``, and only rank 0 writes
    checkpoints and test images.  ``steps_with_gaussian`` counts this
    rank's samples."""

    def __init__(
        self,
        generator: torch.nn.Module,
        discriminator: Optional[torch.nn.Module],
        pipeline,
        cfg: TrainConfig = TrainConfig(),
        *,
        family: Optional[str] = None,
        perceptual: Optional[torch.nn.Module] = None,
        val_pipeline=None,
        test_pair: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        extra_metrics=False,
        device="cuda",
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.rank = 0 if mesh is None else torch.distributed.get_rank()
        self.family = family or cfg.model
        _check_family(self.family)
        if extra_metrics not in (False, True, "epoch", "batch"):
            raise ValueError(f"extra_metrics must be False, True, 'epoch' or "
                             f"'batch', got {extra_metrics!r}")
        self.device = resolve_device(device)
        self.generator = generator.to(self.device, torch.float32)
        self.discriminator = discriminator
        modules = [self.generator]
        if discriminator is not None:
            self.discriminator = discriminator.to(self.device, torch.float32)
            modules.append(self.discriminator)
        if perceptual is not None:
            modules.append(perceptual.to(self.device))
        if self.device.type == "cuda":
            for m in modules:
                m.to(memory_format=torch.channels_last)
        self.pipeline = pipeline
        self.val_pipeline = val_pipeline
        self.test_pair = test_pair
        self.extra_metrics = extra_metrics
        self._pd = None
        if extra_metrics:
            # the shipped tower when present, random features otherwise
            self._pd = PerceptualDistance.default(seed=0)
            self._pd.net.to(self.device)
        self._viz_warned = False

        self.init_fn, self.step_fn = make_train_step(
            self.generator, self.discriminator,
            family=self.family,
            adv_weight=cfg.adv_weight,
            cgan_mae_weight=cfg.cgan_mae_weight,
            perceptual=perceptual,
            adam_b1=cfg.betas[0],
            adam_b2=cfg.betas[1],
            on_the_fly_noise=cfg.on_the_fly_noise,
            noise_variant=cfg.noise_variant,
            sr_scale=(getattr(generator, "scale_factor", 1)
                      if self.family == "srgan" else 1),
            compute_dtype=cfg.compute_dtype,
            remat=cfg.remat,
            extras_fn=(batch_extras_fn(self.family, self._pd)
                       if extra_metrics == "batch" else None),
            mesh=mesh,
        )
        self.opt = self.init_fn()
        self._broadcast_from_rank0()
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

    def _broadcast_from_rank0(self) -> None:
        """Under a mesh: every parameter, buffer and optimiser moment of G
        and D takes rank 0's value (one broadcast a tensor)."""
        if self.mesh is None:
            return
        tensors = []
        for (_, m), st in zip(self._modules(), self.opt):
            if m is not None:
                tensors += list(m.parameters()) + list(m.buffers())
                tensors += list(st.mu.values()) + list(st.nu.values())
        with torch.no_grad():
            for t in tensors:
                torch.distributed.broadcast(t.data, src=0)

    # ---- checkpointing ------------------------------------------------------
    def _modules(self):
        """(generator, discriminator or None) with their section names."""
        return (("generator", self.generator),
                ("discriminator", self.discriminator))

    def _sections(self) -> Dict[str, object]:
        sections: Dict[str, object] = {}
        for (name, m), (opt_name, st) in zip(
                self._modules(), zip(("g_optimizer", "d_optimizer"),
                                     self.opt)):
            params, state = ({}, {}) if m is None else \
                convert.state_dict_to_jax_params(m.state_dict(), module=m)
            sections[name], sections[name + "_state"] = params, state
            sections[opt_name] = {
                "step": np.asarray(st.step, np.int32),
                "mu": convert.state_dict_to_jax_params(st.mu, module=m)[0],
                "nu": convert.state_dict_to_jax_params(st.nu, module=m)[0]}
        return sections

    def save_checkpoint(self, epoch: int, is_best: bool = False) -> None:
        """Cadence of ``gan_trainer.py:430-438``: first, last and even
        epochs, plus ``best/`` on a new best PSNR; written off-thread, by
        rank 0 alone under a mesh."""
        cfg = self.cfg
        if self.rank != 0:
            return
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
        for (name, m), (opt_name, st) in zip(
                self._modules(), zip(("g_optimizer", "d_optimizer"),
                                     self.opt)):
            if m is None:
                if sections.get(name):
                    raise KeyError(f"{path}: a {name} section, and the "
                                   f"{self.family} trainer has none")
                continue
            convert.load_jax_trees(m, sections[name],
                                   sections.get(name + "_state"))
            sec = sections.get(opt_name)
            if not sec:
                continue
            st.step = int(sec["step"])
            for moments, key in ((st.mu, "mu"), (st.nu, "nu")):
                loaded = convert.jax_params_to_state_dict(sec[key], module=m)
                if set(loaded) != set(moments):
                    raise KeyError(f"{path}: {opt_name}.{key} does not match "
                                   "the model's parameters")
                with torch.no_grad():
                    for k, v in loaded.items():
                        moments[k].copy_(v)
        self.best_psnr = float(meta.get("best_psnr", 0.0))
        hist = meta.get("metric_history")
        if hist:
            self.metric_history = {k: list(v) for k, v in hist.items()}
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self._broadcast_from_rank0()
        logger.info("resumed from %s at epoch %d", path, self.start_epoch)
        return self.start_epoch

    # ---- evaluation helpers -------------------------------------------------
    def _eval_forward(self, noisy_nhwc: torch.Tensor) -> torch.Tensor:
        """Eval-mode forward through the conv kernels; NHWC in and out, in
        the family's domain."""
        self.generator.eval()
        x = noisy_nhwc.to(self.device, torch.float32)
        return self.generator(_nchw(x), route="kernel").permute(0, 2, 3, 1)

    @torch.inference_mode()
    def generate(self, noisy: np.ndarray) -> np.ndarray:
        """float32 NHWC in the family's domain ([0, 1] for esrgan and dncnn,
        [-1, 1] else; srgan's LR) → the generator's output, on the host."""
        return self._eval_forward(torch.as_tensor(noisy)).cpu().numpy()

    @torch.inference_mode()
    def evaluate_dataset(self, pipeline) -> Dict[str, float]:
        """Held-out evaluation: mean PSNR/SSIM over a pipeline of (noisy,
        clean) float32 NHWC batches in the family's domain, on the device,
        in the family's convention (``family_eval_metrics``)."""
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

    def _viz_missing(self, e: ImportError) -> None:
        """One warning per trainer for a figure that a missing package
        keeps from being drawn."""
        if not self._viz_warned:
            logger.warning("test images are not written: %s is not "
                           "installed (metrics and checkpoints are "
                           "unaffected)", e.name or e)
            self._viz_warned = True

    def test_random_images(self, epoch: int) -> Optional[str]:
        """The per-epoch visual of the test pair (:507-544): the labelled
        noisy / denoised JPEG for the denoise, srgan and dncnn families, the
        noisy / generated / clean triptych PNG for esrgan and cgan; returns
        its path (None without a test pair, or without PIL or matplotlib,
        which logs one warning; None on a rank other than 0)."""
        if self.rank != 0:
            return None
        if self.test_pair is None:
            logger.info("No test image selected for testing.")
            return None
        from celebrity_image_denoiser_tpu_torch.viz.side_by_side import (
            combine_test_images,
            triptych,
        )

        noisy, clean = self.test_pair
        noisy_b = noisy[None] if noisy.ndim == 3 else noisy
        clean0 = clean if clean.ndim == 3 else clean[0]
        fake = self.generate(noisy_b)[0]
        if self.family in UNIT_FAMILIES:
            denoised01, noisy01, clean01 = fake, noisy_b[0], clean0
        else:
            denoised01 = fake * 0.5 + 0.5
            noisy01 = noisy_b[0] * 0.5 + 0.5
            clean01 = clean0 * 0.5 + 0.5
        os.makedirs(self.cfg.test_image_dir, exist_ok=True)
        try:
            if self.family in ("esrgan", "cgan"):
                out_path = os.path.join(self.cfg.test_image_dir,
                                        f"testimg_epoch{epoch}.png")
                triptych(noisy01, denoised01, clean01, out_path)
            else:
                denoised_u8 = np.clip(denoised01 * 255, 0, 255).astype(
                    np.uint8)
                noisy_u8 = np.clip(noisy01 * 255, 0, 255).astype(np.uint8)
                out_path = os.path.join(self.cfg.test_image_dir,
                                        f"testimg_epoch{epoch}.jpg")
                combine_test_images(noisy_u8, denoised_u8).save(out_path)
        except ImportError as e:
            self._viz_missing(e)
            return None
        logger.info("Saved test image: %s", out_path)
        return out_path

    @torch.inference_mode()
    def _epoch_extras(self) -> Tuple[float, float]:
        """The perceptual distance and MS-SSIM of the test pair through
        ``generate`` (:546-566); (0, 0) without extra metrics or a test
        pair, MS-SSIM 0 below 176 px."""
        if not self.extra_metrics or self.test_pair is None:
            return 0.0, 0.0
        noisy, clean = self.test_pair
        fake = self.generate(noisy[None] if noisy.ndim == 3 else noisy)
        cb = clean[None] if clean.ndim == 3 else clean
        f01 = to_unit(self.family, torch.as_tensor(fake).to(self.device))
        c01 = to_unit(self.family,
                      torch.as_tensor(cb).to(self.device, torch.float32))
        lp = float(self._pd(f01, c01).mean())
        ms = 0.0
        if min(f01.shape[1], f01.shape[2]) >= min_size():
            ms = float(ms_ssim(f01, c01, data_range=1.0).mean())
        return lp, ms

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
            if self.extra_metrics == "batch":  # the epoch's batch means
                lp, ms = avgs["lpips"], avgs["msssim"]
            else:
                lp, ms = self._epoch_extras()
            for k in ("g_loss", "d_loss", "psnr", "ssim"):
                self.metric_history[k].append(avgs[k])
            self.metric_history["lpips"].append(lp)
            self.metric_history["msssim"].append(ms)
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
            if self.test_pair is not None:
                self.test_random_images(epoch)
            is_best = avgs["psnr"] > self.best_psnr
            if is_best:
                self.best_psnr = avgs["psnr"]
            self.save_checkpoint(epoch, is_best)
            if epoch_callback is not None:
                epoch_callback(self, epoch, avgs)
        return self.metric_history
