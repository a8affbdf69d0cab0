"""Train the serving checkpoints (``weights/``) from scratch on the card.

Port of ``scripts/train_serving_weights.py``: every mode but
``--qat-steps``, which is ``train/qat.py``.  The corpus is synthesised on
the device (``data/synthetic.py``) and the family's noise drawn over it by
the noise kernel, so no training image crosses from the host.

* ``train_family`` (``train_family:168-327``): one family on
  ``gan_trainer.py::make_train_step`` on the fly, with the family's
  ``FAMILY_NOISE_VARIANT`` (dncnn: the blind σ, as the script's step
  factory keeps its ``dncnn_blind=True`` default and ignores the variant)
  and ``sr_scale=4`` for srgan.  ``--chunk`` steps run back
  to back with no host read between them; then the host reads the last
  step's PSNR and G loss, which fences the chunk (the script's
  ``lax.scan`` and ``device_get``).  The lr is ×1, ×0.5 and ×0.25 over
  60% / 85% of the chunks (``lr_factor``).  Then the held-out report
  (``train/qat.py::evaluate``, 16 images from seed 77, on the kernel
  route), the checkpoint ``<out>/<family>`` in the shared npz layout with
  the script's ``meta.json`` keys, and the fixture gain of that file
  served int8 (srgan: and its battery gain), recorded into ``meta.json``.
* srgan (``srgan_pretrain:102-165``): stage 1 trains G alone on pixel MSE
  from the bicubic ×4 LR input (``--pretrain-steps``, the lr schedule
  above); ``--pretrain-ckpt`` caches it (loaded when it holds
  ``generator``, written otherwise; either package reads the other's).
  Stage 2 starts from stage 1's G weights and BatchNorm statistics with a
  fresh discriminator and fresh optimisers, at ``--finetune-lr`` or
  ``lr / 4``, with the content loss ``perceptual(f, c) + w·mean((f −
  c)²)`` (``--pixel-anchor``).  ``--ema`` keeps an average of G's
  parameters (not its BatchNorm statistics, which stay the raw run's, as
  the script averages ``c[0]``) in tensors of its own; both endpoints are
  evaluated and the average ships only if its gain is higher.
* ``train_perceptual`` (``train_perceptual:536-588``): the VGG16-features
  [:16] tower as the encoder of a denoising autoencoder (``Decoder``: three
  3×3 convs, ReLU, two nearest ×2 upsamplings), Adam over both, the lr ×1
  then ×0.3 after 70% of the chunks, noise variant ``1 + i % 3`` in chunk
  ``i``; written as the ``vgg`` / ``vgg_state`` sections, the tower
  ``load_perceptual`` and ``PerceptualDistance`` read.

The draws come from ``torch.Generator``s on the device seeded as the
script seeds its keys (chunk ``i``: 1000 + i, stage 1 500 + i, the tower
2000 + i; the evaluation 77; the initial weights ``--seed``), so the
images differ from the script's.  The synthetic batch is quantised to
uint8 before the noise (the noise kernel takes bytes: its Poisson inverts
a table at an integer λ), where the script noises the float batch; the
clean target moves by at most 0.5/255.  Training chunks run their convs
and matmuls in TF32 on the card (the JAX trainer's f32 convs run at the
TPU's default precision, one bfloat16 pass); the evaluations and the
served gains run in float32.  A failed fixture-gain recording raises
(the script warns): a checkpoint whose ``meta.json`` lacks its gate floor
is never left behind quietly.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as ckpt_lib
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.core.config import (
    FAMILY_NOISE_VARIANT,
    default_weights_dir,
)
from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
from celebrity_image_denoiser_tpu_torch.data.synthetic import synth_clean_u8
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    reset_conv_parameters,
)
from celebrity_image_denoiser_tpu_torch.models.vgg import VGGFeatures
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d
from celebrity_image_denoiser_tpu_torch.ops.resize import resize
from celebrity_image_denoiser_tpu_torch.train import optim, qat
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
    make_train_step,
)
from celebrity_image_denoiser_tpu_torch.train.losses import (
    VGGPerceptualLoss,
    make_vgg_perceptual,
)

DATA = "synthetic-v1 (data/synthetic.py), on-device, uint8"


def chunk_guard(index: int):
    """The context each training chunk runs in (its closing host read
    outside it); a no-op.  A caller may replace it, e.g. with a scope of
    ``torch.cuda.set_sync_debug_mode("error")`` to show a chunk has no
    host sync."""
    return contextlib.nullcontext()


def lr_factor(frac: float) -> float:
    """The families' and stage 1's decay at ``frac`` = chunk / chunks."""
    return 1.0 if frac < 0.6 else 0.5 if frac < 0.85 else 0.25


def tower_lr_factor(index: int, n_chunks: int) -> float:
    """The perceptual tower's decay."""
    return 1.0 if index / n_chunks < 0.7 else 0.3


def tower_variant(index: int) -> int:
    """The tower's noise variant in chunk ``index``: 1, 2, 3, 1, …"""
    return 1 + index % 3


def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor],
               decay: float) -> None:
    """``ema ← ema·decay + params·(1 − decay)`` in place, as the script's
    ``a * ema_decay + b * (1.0 - ema_decay)``."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))


@contextlib.contextmanager
def _precision(device: torch.device, tf32: bool):
    """TF32 convs and matmuls on the card, or none, for the length of a
    ``with``; the flags are put back after."""
    if device.type != "cuda":
        yield
        return
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _chunk_gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def build_models(family: str, size: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[nn.Module, Optional[nn.Module]]:
    """(G, D or None) of ``family`` at full width, as the script builds
    them; esrgan's discriminator is sized for ``size``² inputs."""
    if family == "denoise":
        return (registry.build_generator("denoise", generator=generator),
                registry.build_discriminator("denoise", generator=generator))
    if family == "dncnn":
        return registry.build_generator("dncnn", generator=generator), None
    if family == "srgan":
        return (registry.build_generator("srgan", scale_factor=4,
                                         generator=generator),
                registry.build_discriminator("srgan", generator=generator))
    if family == "esrgan":
        return (registry.build_generator("esrgan", num_residuals=8,
                                         generator=generator),
                registry.build_discriminator("esrgan", input_hw=(size, size),
                                             generator=generator))
    if family == "cgan":
        raise ValueError(
            "the served cGAN is the shipped Keras checkpoint "
            "(weights/cgan_epoch_500.keras), copied not trained; the torch "
            "arch is a label->image fallback that cannot train as a denoiser "
            "(models/cgan_torch.py image-cond path reproduces the "
            "reference's channel-mismatch crash)")
    raise ValueError(family)


def load_perceptual(path: Optional[str], log: Callable = print
                    ) -> VGGPerceptualLoss:
    """srgan's content loss over the tower in the checkpoint ``path``
    (sections ``vgg``, ``vgg_state``), else the shipped
    ``weights/perceptual``, else random features (seed 99) with a warning;
    a trained tower takes [-1, 1] inputs back to its [0, 1] domain
    (``to_unit``)."""
    vgg = VGGFeatures(generator=torch.Generator().manual_seed(99))
    if not path:
        cand = os.path.join(default_weights_dir(), "perceptual")
        path = cand if os.path.isdir(cand) else None
    trained = False
    if path:
        sections, _ = ckpt_lib.load_checkpoint(path)
        trained = "vgg" in sections
        if trained:
            convert.load_jax_trees(vgg, sections["vgg"],
                                   sections.get("vgg_state"))
            log(f"perceptual: loaded trained tower from {path}")
    if not trained:
        log("perceptual: WARNING random-init VGG features")
    return make_vgg_perceptual(vgg, to_unit=trained)


def anchored(perceptual: Callable, weight: float) -> Callable:
    """Stage 2's content loss: ``perceptual(f, c) + weight·mean((f −
    c)²)``."""
    def content(f, c):
        return perceptual(f, c) + weight * torch.mean((f - c) ** 2)
    return content


def _save_generator(path: str, gen: nn.Module, meta: dict) -> None:
    params, state = convert.state_dict_to_jax_params(gen.state_dict(),
                                                     module=gen)
    ckpt_lib.save_checkpoint(path, {"generator": params,
                                    "generator_state": state}, meta=meta)


def pretrain_loss(gen: nn.Module, noisy01: torch.Tensor,
                  clean01: torch.Tensor) -> torch.Tensor:
    """Stage 1's pixel MSE: G in train mode on the bicubic ×4 downscale of
    the noisy NHWC batch in [-1, 1], against the clean one in [-1, 1]."""
    h, w = noisy01.shape[1:3]
    lr01 = resize(noisy01, (h // 4, w // 4), "bicubic")
    fake = gen(_nchw(lr01 * 2.0 - 1.0), route="autograd")
    return torch.mean((fake - _nchw(clean01 * 2.0 - 1.0)) ** 2)


def _evaluate(family: str, gen: nn.Module, size: int) -> Dict[str, float]:
    """``qat.evaluate`` in float32."""
    with _precision(next(gen.parameters()).device, False):
        return qat.evaluate(family, gen, size)


def _fence(*scalars: torch.Tensor) -> List[float]:
    """The chunk's one host read."""
    return torch.stack([s.detach().float() for s in scalars]).tolist()


def _record(records: list, tag: str, i: int, n_chunks: int, chunk: int,
            batch: int, dt: float, log: Callable, **values) -> None:
    rate = chunk * batch / dt
    records.append({"stage": tag, "steps": (i + 1) * chunk, "seconds": dt,
                    "images_per_s": rate, **values})
    shown = "  ".join(f"{k} {v:.5f}" for k, v in values.items())
    log(f"[{tag}] chunk {i + 1}/{n_chunks} steps {(i + 1) * chunk}  "
        f"{shown}  {rate:.0f} img/s")


def srgan_pretrain(gen: nn.Module, args, device: torch.device,
                   log: Callable = print) -> List[dict]:
    """Stage 1 of srgan's recipe on ``gen`` in place: load the
    ``--pretrain-ckpt`` cache when it holds ``generator``, else train
    ``max(1, pretrain_steps // chunk)`` chunks of pixel MSE and write the
    cache if one is named.  Returns the chunk records (none from a
    cache)."""
    if args.pretrain_ckpt and os.path.isdir(args.pretrain_ckpt):
        sections, meta = ckpt_lib.load_checkpoint(args.pretrain_ckpt)
        if "generator" in sections:
            convert.load_jax_trees(gen, sections["generator"],
                                   sections.get("generator_state"))
            log(f"[srgan-pretrain] loaded cached stage-1 from "
                f"{args.pretrain_ckpt} ({meta.get('steps', '?')} steps)")
            return []
    params = dict(gen.named_parameters())
    adam_init, adam_update = optim.adam()
    opt = adam_init(params)
    gen.train()
    n_chunks = max(1, args.pretrain_steps // args.chunk)
    records = []
    for i in range(n_chunks):
        lr = args.lr * lr_factor(i / n_chunks)
        t0 = time.perf_counter()
        with chunk_guard(i), _precision(device, True):
            g = _chunk_gen(device, 500 + i)
            for _ in range(args.chunk):
                noisy01, clean01 = qat.noisy_batch("srgan", g, args.batch,
                                                   args.size)
                with torch.enable_grad():
                    mse = pretrain_loss(gen, noisy01, clean01)
                    grads = torch.autograd.grad(mse, list(params.values()))
                adam_update(dict(zip(params, grads)), opt, params, lr)
        (last,) = _fence(mse)
        _record(records, "srgan-pretrain", i, n_chunks, args.chunk,
                args.batch, time.perf_counter() - t0, log, mse=last)
    if args.pretrain_ckpt:
        _save_generator(args.pretrain_ckpt, gen, {
            "family": "srgan-stage1", "steps": n_chunks * args.chunk,
            "batch": args.batch, "size": args.size, "lr": args.lr})
        log(f"[srgan-pretrain] cached stage-1 at {args.pretrain_ckpt}")
    return records


def train_family(args, device, log: Callable = print) -> Dict[str, object]:
    """Train ``args.family`` (the CLI's flags) on ``device`` and ship it to
    ``<out>/<family>``; returns the written meta, the chunk records and the
    reports of the evaluated endpoints."""
    family, size, batch = args.family, args.size, args.batch
    device = torch.device(device)
    gen, disc = build_models(family, size,
                             torch.Generator().manual_seed(args.seed))
    gen.to(device)
    modules = [gen]
    if disc is not None:
        modules.append(disc.to(device))
    perceptual = None
    if family == "srgan":
        perceptual = load_perceptual(args.perceptual, log).to(device)
        modules.append(perceptual)
    if device.type == "cuda":
        for m in modules:
            m.to(memory_format=torch.channels_last)
    records: List[dict] = []
    reports: Dict[str, dict] = {}
    pretrained = family == "srgan" and args.pretrain_steps > 0
    if pretrained:
        records += srgan_pretrain(gen, args, device, log)
        reports["stage1"] = _evaluate(family, gen, size)
        log(f"[srgan-pretrain] held-out after stage 1: {reports['stage1']}")
        if args.pixel_anchor > 0:
            perceptual = anchored(perceptual, args.pixel_anchor)
    init_fn, step_fn = make_train_step(
        gen, disc, family=family, perceptual=perceptual,
        on_the_fly_noise=True,
        # None: dncnn's blind σ (the port's factory takes a variant as
        # opting out of it, where JAX's has a flag of its own)
        noise_variant=(None if family == "dncnn"
                       else FAMILY_NOISE_VARIANT.get(family, 1)),
        sr_scale=4 if family == "srgan" else 1)
    opt = init_fn()  # stage 2 restarts both optimisers
    base_lr = args.lr
    if pretrained:  # adversarial fine-tune: gentler steps
        base_lr = args.finetune_lr or args.lr / 4
    ema_decay = args.ema if pretrained else 0.0
    params = list(gen.parameters())
    ema = [p.detach().clone() for p in params] if ema_decay > 0 else None
    n_chunks = max(1, args.steps // args.chunk)
    t_start = time.perf_counter()
    for i in range(n_chunks):
        lr = base_lr * lr_factor(i / n_chunks)
        t0 = time.perf_counter()
        with chunk_guard(i), _precision(device, True):
            g = _chunk_gen(device, 1000 + i)
            for _ in range(args.chunk):
                m = step_fn(opt, None, synth_clean_u8(g, batch, size), g,
                            lr, lr)
                if ema is not None:
                    ema_update(ema, params, ema_decay)
        psnr, g_loss, d_loss = _fence(m["psnr"], m["g_loss"], m["d_loss"])
        _record(records, family, i, n_chunks, args.chunk, batch,
                time.perf_counter() - t0, log, psnr=psnr, g_loss=g_loss,
                d_loss=d_loss)
    ema_selected = False
    if ema is not None:
        averaged = copy.deepcopy(gen)  # the raw run's BatchNorm statistics
        with torch.no_grad():
            for p, e in zip(averaged.parameters(), ema):
                p.copy_(e)
        reports["raw"] = _evaluate(family, gen, size)
        reports["ema"] = _evaluate(family, averaged, size)
        log(f"[{family}] stage-2 raw: {reports['raw']}")
        log(f"[{family}] stage-2 EMA({ema_decay}): {reports['ema']}")
        if reports["ema"]["gain_db"] > reports["raw"]["gain_db"]:
            with torch.no_grad():
                for p, e in zip(params, ema):
                    p.copy_(e)
            ema_selected = True
        del averaged
    report = _evaluate(family, gen, size)
    reports["final"] = report
    log(f"[{family}] held-out: {report}")
    out = os.path.join(args.out, family)
    meta = {"family": family, "steps": n_chunks * args.chunk,
            "pretrain_steps": args.pretrain_steps, "batch": batch,
            "size": size, "lr": args.lr,
            # the lr the recorded steps ran at (srgan: stage 2's)
            "stage_lr": float(base_lr), "data": DATA,
            **({"ema": ema_decay, "ema_selected": ema_selected}
               if ema_decay > 0 else {}),
            **report}
    _save_generator(out, gen, meta)
    log(f"[{family}] saved {out}  "
        f"({time.perf_counter() - t_start:.0f}s total)")
    meta.update(qat.record_fixture_gain(args.out, family, device))
    log(f"[{family}] serving-fixture gain {meta['fixture_gain_db']:+.2f} dB "
        "recorded" + (f", battery {meta['battery_gain_db']:+.2f} dB"
                      if "battery_gain_db" in meta else ""))
    return {"meta": meta, "chunks": records, "reports": reports}


class Decoder(nn.Module):
    """The autoencoder's decoder (the script's ``_Decoder:514-533``):
    256-channel /4 features → RGB through three 3×3 convs with ReLU between
    them and a nearest ×2 upsampling after each of the first two.  NCHW."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c1 = Conv2d(256, 128, 3, padding=1)
        self.c2 = Conv2d(128, 64, 3, padding=1)
        self.c3 = Conv2d(64, 3, 3, padding=1)
        reset_conv_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(F.relu(self.c1(x)), scale_factor=2, mode="nearest")
        x = F.interpolate(F.relu(self.c2(x)), scale_factor=2, mode="nearest")
        return self.c3(x)


def autoencoder_loss(vgg: nn.Module, dec: nn.Module, noisy01: torch.Tensor,
                     clean01: torch.Tensor) -> torch.Tensor:
    """MSE of the decoded features of the noisy NHWC batch against the
    clean one, both on [0, 1]."""
    return torch.mean((dec(vgg(_nchw(noisy01))) - _nchw(clean01)) ** 2)


def train_perceptual(args, device, log: Callable = print
                     ) -> Dict[str, object]:
    """Train the tower (the CLI's flags) on ``device`` and write it to
    ``<out>/perceptual``; returns the meta and the chunk records."""
    device = torch.device(device)
    size, batch = args.size, args.batch
    vgg = VGGFeatures(generator=torch.Generator().manual_seed(args.seed))
    dec = Decoder(generator=torch.Generator().manual_seed(args.seed + 1))
    vgg.to(device).train()
    dec.to(device).train()
    if device.type == "cuda":
        for m in (vgg, dec):
            m.to(memory_format=torch.channels_last)
    params = {**{f"vgg.{k}": v for k, v in vgg.named_parameters()},
              **{f"dec.{k}": v for k, v in dec.named_parameters()}}
    adam_init, adam_update = optim.adam()
    opt = adam_init(params)
    n_chunks = max(1, args.steps // args.chunk)
    records: List[dict] = []
    for i in range(n_chunks):
        lr = args.lr * tower_lr_factor(i, n_chunks)
        t0 = time.perf_counter()
        with chunk_guard(i), _precision(device, True):
            g = _chunk_gen(device, 2000 + i)
            for _ in range(args.chunk):
                noisy01, clean01, _ = noise_lib.random_noise_batch(
                    g, synth_clean_u8(g, batch, size),
                    variant=tower_variant(i), domain="unit")
                with torch.enable_grad():
                    loss = autoencoder_loss(vgg, dec, noisy01, clean01)
                    grads = torch.autograd.grad(loss, list(params.values()))
                adam_update(dict(zip(params, grads)), opt, params, lr)
        (last,) = _fence(loss)
        _record(records, "perceptual", i, n_chunks, args.chunk, batch,
                time.perf_counter() - t0, log, mse=last)
    out = os.path.join(args.out, "perceptual")
    vp, vs = convert.state_dict_to_jax_params(vgg.state_dict(), module=vgg)
    meta = {"kind": "synthetic-DAE VGG16-features[:16] tower",
            "steps": n_chunks * args.chunk, "final_mse": last,
            "data": "synthetic-v1, distortions v1-v3, uint8"}
    ckpt_lib.save_checkpoint(out, {"vgg": vp, "vgg_state": vs}, meta=meta)
    log(f"[perceptual] saved {out}")
    return {"meta": meta, "chunks": records}
