"""Quantization-aware fine-tune of a trained generator onto the int8 gate.

Port of ``scripts/train_serving_weights.py::qat_finetune:330`` and
``evaluate:472``.  It starts from an existing checkpoint and fine-tunes the
generator with the int8 serving arithmetic simulated in the loss
(``ops/quant.py::fake_quant``: straight-through rounding, per-channel
folded scales):

    L = MSE(float, clean) + MSE(fakequant, clean) + qat_agree · MSE(fakequant, float)

with the generator in eval mode on both branches (BatchNorm frozen), on its
``route="autograd"``.  Each step draws a batch of ``synth_clean_batch``
images on the device, as uint8, and the family's noise over it in one
launch of the noise kernel (dncnn: the blind-σ Gaussian), then takes one
Adam step; the learning rate is ×1, ×0.5 and ×0.25 over 60% / 85% of the
chunks, and the host reads the loss terms once a chunk.

The held-out ``evaluate`` runs at the source checkpoint's recorded size,
and the ship guard refuses to write when the gain falls below 0.85 × the
source's ``gain_db``, or is NaN (a diverged fine-tune; the JAX script's
``<`` lets a NaN through).  ``heldout_report`` equals the script's report
on the same images, but ``evaluate`` draws its own (the script's come from
JAX's generator), and 16 images' gain moves by a dB or more from draw to
draw; so the log and the refusal also give the source's gain on this draw
(``before``), while the guard compares with the recorded gain, as the
script's does.  A shipped checkpoint carries the QAT provenance in
its ``meta.json`` and then the fixture gain (``serve/quality.py``) of a
``ServeState`` on the output directory, quantized as ``cli.serve`` serves
by default (int8: K5 on the card).  The JAX script catches a failure of
that last step with a warning; here it propagates, so a failing int8
kernel cannot hide behind a quiet recording.

Families: denoise, dncnn and esrgan (same-resolution image-to-image
generators); srgan and cgan are refused as the script refuses them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as ckpt_lib
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.core.config import (
    FAMILY_NOISE_VARIANT,
)
from celebrity_image_denoiser_tpu_torch.data import noise as noise_lib
from celebrity_image_denoiser_tpu_torch.data.synthetic import synth_clean_u8
from celebrity_image_denoiser_tpu_torch.metrics import (
    PerceptualDistance,
    psnr,
)
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.ops import quant
from celebrity_image_denoiser_tpu_torch.ops.resize import resize
from celebrity_image_denoiser_tpu_torch.train import optim
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import UNIT_FAMILIES

QAT_FAMILIES = ("denoise", "dncnn", "esrgan")
SHIP_FRACTION = 0.85  # of the source's held-out gain
# the source checkpoint's meta keys carried into the fine-tuned one
_KEPT_META = ("family", "steps", "pretrain_steps", "batch", "size", "lr",
              "stage_lr", "data")


def check_family(family: str) -> None:
    if family not in QAT_FAMILIES:
        raise SystemExit(
            "--qat-steps supports denoise/dncnn/esrgan (same-resolution "
            f"image-to-image generators), not {family!r}")


def load_generator(family: str, src: str, device) -> Tuple[torch.nn.Module,
                                                          dict]:
    """The ``family`` generator with the weights of the checkpoint ``src``
    (``ckpt/checkpoint.py``), on ``device``, and the checkpoint's meta."""
    sections, meta = ckpt_lib.load_checkpoint(src)
    if "generator" not in sections:
        raise SystemExit(f"--qat-steps needs an existing checkpoint at {src}")
    gen = registry.build_generator(family)
    convert.load_jax_trees(gen, sections["generator"],
                           sections.get("generator_state"))
    return gen.to(device), meta


def noisy_batch(family: str, gen: torch.Generator, n: int, size: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noisy, clean) float32 NHWC on ``gen``'s device: ``n`` synthetic
    images of ``size``² as uint8, the family's noise in one launch of the
    noise kernel, on [0, 1] (``domain="unit"``) whatever the family."""
    u8 = synth_clean_u8(gen, n, size)
    if family == "dncnn":
        return noise_lib.blind_gaussian_batch(gen, u8, domain="unit")
    noisy, clean, _ = noise_lib.random_noise_batch(
        gen, u8, variant=FAMILY_NOISE_VARIANT.get(family, 1), domain="unit")
    return noisy, clean


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def qat_loss(generator: torch.nn.Module, x: torch.Tensor,
             target: torch.Tensor, agree_weight: float,
             skip: Optional[Callable] = None):
    """(loss, (mse_f, mse_q, agree)) of NCHW ``x`` against ``target``: the
    float and the fake-quant branch of the eval-mode generator's autograd
    route."""
    yf = generator(x, route="autograd")
    with quant.fake_quant(skip):
        yq = generator(x, route="autograd")
    mse_f = torch.mean((yf - target) ** 2)
    mse_q = torch.mean((yq - target) ** 2)
    agree = torch.mean((yq - yf) ** 2)
    return mse_f + mse_q + agree_weight * agree, (mse_f, mse_q, agree)


def finetune(generator: torch.nn.Module, family: str, *, steps: int,
             chunk: int, lr: float, agree_weight: float, batch: int,
             size: int, seed: int = 0, log: Callable = print
             ) -> List[Dict[str, float]]:
    """Fine-tune ``generator`` in place for ``max(1, steps // chunk)``
    chunks of ``chunk`` steps; one record per chunk (its last step's loss
    terms, the agreement in dB, the chunk's seconds)."""
    check_family(family)
    dev = next(generator.parameters()).device
    tanh = family not in UNIT_FAMILIES
    generator.eval()
    params = dict(generator.named_parameters())
    adam_init, adam_update = optim.adam()
    opt = adam_init(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_chunks = max(1, steps // chunk)
    records = []
    for i in range(n_chunks):
        frac = i / n_chunks
        lr_i = lr * (1.0 if frac < 0.6 else 0.5 if frac < 0.85 else 0.25)
        t0 = time.perf_counter()
        for _ in range(chunk):
            noisy, clean = noisy_batch(family, gen, batch, size)
            if tanh:
                noisy, clean = noisy * 2.0 - 1.0, clean * 2.0 - 1.0
            with torch.enable_grad():
                loss, aux = qat_loss(generator, _nchw(noisy), _nchw(clean),
                                     agree_weight)
                grads = torch.autograd.grad(loss, list(params.values()))
            adam_update(dict(zip(params, grads)), opt, params, lr_i)
        mf, mq, ag = torch.stack([a.detach() for a in aux]).tolist()
        dt = time.perf_counter() - t0
        agree_db = 10.0 * np.log10((2.0 if tanh else 1.0) ** 2
                                   / max(ag, 1e-12))
        records.append({"steps": (i + 1) * chunk, "mse_f": mf, "mse_q": mq,
                        "agree_db": float(agree_db), "seconds": dt})
        log(f"[{family}-qat] chunk {i + 1}/{n_chunks} "
            f"steps {(i + 1) * chunk}  mse_f {mf:.5f}  mse_q {mq:.5f}  "
            f"agree {agree_db:.1f} dB  {chunk * batch / dt:.0f} img/s")
    return records


def evaluate(family: str, generator: torch.nn.Module, size: int,
             n: int = 16, seed: int = 77) -> Dict[str, float]:
    """PSNR of the generator's output and of its input against the clean
    images, on fresh synthetic data at ``size``² (``evaluate:472``): ``n``
    images drawn from ``seed`` as ``noisy_batch`` draws them, then
    ``heldout_report``."""
    dev = next(generator.parameters()).device
    noisy01, clean01 = noisy_batch(family, torch.Generator(
        device=dev).manual_seed(seed), n, size)
    return heldout_report(family, generator, noisy01, clean01)


@torch.inference_mode()
def heldout_report(family: str, generator: torch.nn.Module,
                   noisy01: torch.Tensor, clean01: torch.Tensor
                   ) -> Dict[str, float]:
    """``evaluate``'s report on a given noisy and clean NHWC batch on [0,
    1]: srgan against the bicubic upscale of its ×4 LR input, with the
    perceptual distances of both."""
    dev = next(generator.parameters()).device
    generator.eval()

    def fwd(x):
        return generator(_nchw(x), route="kernel").permute(0, 2, 3, 1)

    if family in UNIT_FAMILIES:
        out01 = fwd(noisy01).clamp(0, 1)
        base01 = noisy01
    elif family == "srgan":
        h, w = noisy01.shape[1:3]
        lr01 = resize(noisy01, (h // 4, w // 4), "bicubic")
        out01 = (fwd(lr01 * 2 - 1) * 0.5 + 0.5).clamp(0, 1)
        base01 = resize(lr01, (h, w), "bicubic").clamp(0, 1)
    else:
        out01 = (fwd(noisy01 * 2 - 1) * 0.5 + 0.5).clamp(0, 1)
        base01 = noisy01
    p_out = float(psnr(out01, clean01, data_range=1.0).mean())
    p_in = float(psnr(base01, clean01, data_range=1.0).mean())
    report = {"psnr_out": round(p_out, 3), "psnr_in": round(p_in, 3),
              "gain_db": round(p_out - p_in, 3)}
    if family == "srgan":
        pd = PerceptualDistance.default(seed=0)
        pd.net.to(dev)
        report["lpips_out"] = round(float(pd(out01, clean01).mean()), 5)
        report["lpips_bicubic"] = round(float(pd(base01, clean01).mean()), 5)
    return report


def qat_finetune(*, family: str, init_from: str, out: str, qat_steps: int,
                 qat_lr: float = 2e-5, qat_agree: float = 2.0,
                 chunk: int = 50, batch: int = 32, size: int = 128,
                 seed: int = 0, device="cuda", log: Callable = print
                 ) -> Dict[str, object]:
    """Fine-tune the checkpoint ``init_from``, evaluate, and ship it to
    ``out/<family>`` unless the guard refuses (``SystemExit``, ``out``
    untouched); then record the served fixture gain in its meta.  Returns
    the shipped meta, the chunk records and the source's held-out report on
    the same draw (``before``: the guard compares with the recorded gain,
    which another draw measured)."""
    check_family(family)
    generator, src_meta = load_generator(family, init_from, device)
    eval_size = int(src_meta.get("size", size) or size)
    before = evaluate(family, generator, eval_size)
    log(f"[{family}-qat] fine-tuning from {init_from} "
        f"({src_meta.get('steps', '?')} steps, recorded gain "
        f"{src_meta.get('gain_db', '?')} dB; {before['gain_db']} dB on this "
        "held-out draw)")
    t_start = time.perf_counter()
    records = finetune(generator, family, steps=qat_steps, chunk=chunk,
                       lr=qat_lr, agree_weight=qat_agree, batch=batch,
                       size=size, seed=seed, log=log)
    report = evaluate(family, generator, eval_size)
    log(f"[{family}-qat] held-out (at {eval_size}²): {report}")
    prev_gain = float(src_meta.get("gain_db", 0.0) or 0.0)
    # "not >=": a NaN gain (a diverged fine-tune) refuses too
    if not report["gain_db"] >= SHIP_FRACTION * prev_gain:
        raise SystemExit(
            f"[{family}-qat] REFUSING to ship: held-out gain "
            f"{report['gain_db']:.2f} dB lost >15% of the source "
            f"checkpoint's {prev_gain:.2f} dB — raise --qat-agree less or "
            "shorten the fine-tune (the source reads "
            f"{before['gain_db']:.2f} dB on this held-out draw; the recorded "
            "gain was read on the JAX script's draw, and 16 images' gain "
            "moves by a dB or more from draw to draw)")
    dst = os.path.join(out, family)
    meta = {k: src_meta[k] for k in _KEPT_META if k in src_meta}
    meta.update({"family": family, "qat_steps": len(records) * chunk,
                 "qat_lr": qat_lr, "qat_agree": qat_agree, **report})
    params, state = convert.state_dict_to_jax_params(generator.state_dict(),
                                                     module=generator)
    ckpt_lib.save_checkpoint(dst, {"generator": params,
                                   "generator_state": state}, meta=meta)
    log(f"[{family}-qat] saved {dst}  "
        f"({time.perf_counter() - t_start:.0f}s total)")
    meta.update(record_fixture_gain(out, family, device))
    log(f"[{family}-qat] serving-fixture gain "
        f"{meta['fixture_gain_db']:+.2f} dB recorded")
    return {"meta": meta, "chunks": records, "before": before}


def record_fixture_gain(weights_dir: str, family: str, device
                        ) -> Dict[str, float]:
    """The fixture gain of ``family`` served int8 from ``weights_dir`` (for
    srgan also its battery gain), written into its ``meta.json``; returned
    as the keys written."""
    from celebrity_image_denoiser_tpu_torch.serve import quality
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    st = ServeState(weights_dir=weights_dir, quantize="int8", device=device)
    gains = {"fixture_gain_db": round(quality.fixture_gain_db(st, family), 3)}
    if family == "srgan":
        gains["battery_gain_db"] = round(quality.srgan_battery_gain_db(st), 3)
    meta_path = os.path.join(weights_dir, family, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta.update(gains)
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
    return gains
