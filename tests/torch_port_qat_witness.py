"""The port's quantization-aware fine-tune and held-out evaluation beside
the JAX script's, on the CPU (not a test: a measurement that takes minutes).

    JAX_PLATFORMS=cpu python tests/torch_port_qat_witness.py heldout
    JAX_PLATFORMS=cpu python tests/torch_port_qat_witness.py flips
    JAX_PLATFORMS=cpu python tests/torch_port_qat_witness.py qat \\
        --steps 60 --every 20 --batch 8 --size 64 --lr 2e-5

``heldout`` reads the held-out gain of each shipped checkpoint (denoise,
dncnn, esrgan) over several seeds: JAX's
``scripts/train_serving_weights.py::evaluate`` on its own draw, the port's
``train/qat.py::heldout_report`` on that same draw, and the port's
``evaluate`` on its own draw.  The first two differ only by the forward;
the spread over seeds is the draw's.

``flips`` reads how far the port's fake-quant esrgan stands from JAX's at
32² (``tests/test_torch_port_qat_export.py``'s models and batch) with 1,
2, 4 and 8 residual blocks on seeded weights, and with 8 on the test's
dyadic grid, where it also reads the QAT-loss gradient's largest gap to
JAX's as a share of each leaf's largest value, without and with each conv
output channel's scale-setting weight (the test leaves those out).

``qat`` fine-tunes the shipped esrgan in both packages on the same batches
(JAX's draws, as the script's ``loss_fn`` makes them): the script's loss and
Adam in JAX, ``qat_loss`` and ``optim.adam`` in the port, at one learning
rate, and every ``--every`` steps reads both held-out gains on one draw (the
script's, at the checkpoint's recorded size) and the largest parameter gap
between the two.  It prints one JSON object per reading.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from celebrity_image_denoiser_tpu.ckpt import checkpoint as jax_ckpt  # noqa: E402
from celebrity_image_denoiser_tpu.core import prng  # noqa: E402
from celebrity_image_denoiser_tpu.core.config import (  # noqa: E402
    FAMILY_NOISE_VARIANT,
)
from celebrity_image_denoiser_tpu.data import noise as jax_noise  # noqa: E402
from celebrity_image_denoiser_tpu.data.synthetic import (  # noqa: E402
    synth_clean_batch,
)
from celebrity_image_denoiser_tpu.ops import quant as jax_quant  # noqa: E402
from celebrity_image_denoiser_tpu.train import optim as jax_optim  # noqa: E402
from celebrity_image_denoiser_tpu.utils import tree as jax_tree  # noqa: E402
from celebrity_image_denoiser_tpu_torch.ckpt import convert  # noqa: E402
from celebrity_image_denoiser_tpu_torch.ops import quant as port_quant  # noqa: E402
from celebrity_image_denoiser_tpu_torch.train import optim  # noqa: E402
from celebrity_image_denoiser_tpu_torch.train import qat  # noqa: E402

WEIGHTS = os.path.join(_REPO, "weights")


def _script():
    spec = importlib.util.spec_from_file_location(
        "train_serving_weights",
        os.path.join(_REPO, "scripts", "train_serving_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(script, family):
    """(JAX model, params, state, port generator on the CPU, meta)."""
    sections, meta = jax_ckpt.load_checkpoint(os.path.join(WEIGHTS, family))
    gen, _ = script.build_models(family, int(meta["size"]))
    gs = sections.get("generator_state")
    if gs is None:
        _, gs = gen.init(prng.key(0))
    tm, _ = qat.load_generator(family, os.path.join(WEIGHTS, family), "cpu")
    return gen, sections["generator"], gs, tm, meta


def _draw(family, kd, kn, n, size):
    """The script's draw (images from ``kd``, noise from ``kn``): noisy and
    clean on [0, 1], numpy NHWC."""
    clean01 = synth_clean_batch(kd, n, size)
    if family == "dncnn":
        noisy01 = jax_noise.blind_gaussian_batch(kn, clean01)
    else:
        noisy01 = jax_noise.random_noise_batch(
            kn, clean01, variant=FAMILY_NOISE_VARIANT.get(family, 1))
    return np.asarray(noisy01), np.asarray(clean01)


def _port_report(family, tm, noisy01, clean01):
    return qat.heldout_report(family, tm, torch.from_numpy(noisy01),
                              torch.from_numpy(clean01))


def heldout(args):
    script = _script()
    for family in ("denoise", "dncnn", "esrgan"):
        gen, gp, gs, tm, meta = _load(script, family)
        size = int(meta["size"])
        for seed in args.seeds:
            jax_rep = script.evaluate(family, gen, gp, gs, size, seed=seed)
            # evaluate's draw: its key split once, images then noise
            same = _port_report(family, tm, *_draw(
                family, *jax.random.split(prng.key(seed)), 16, size))
            own = qat.evaluate(family, tm, size, seed=seed)
            print(json.dumps({"family": family, "seed": seed,
                              "recorded": meta["gain_db"],
                              "jax": jax_rep["gain_db"],
                              "port_on_jax_draw": same["gain_db"],
                              "port_own_draw": own["gain_db"]}), flush=True)


def flips(args):
    import test_torch_port_qat_export as T
    from celebrity_image_denoiser_tpu import models as jax_models
    from celebrity_image_denoiser_tpu_torch.models import registry

    x = T.calibration_batch(False, 32)[:4].numpy()
    t = np.clip(x + 0.05 * np.random.default_rng(5).standard_normal(
        x.shape), -1, 1).astype(np.float32)
    for blocks, dyadic in ((1, False), (2, False), (4, False), (8, False),
                           (8, True)):
        gen = torch.Generator().manual_seed(0)
        tm = registry.build_generator("esrgan", num_residuals=blocks,
                                      generator=gen)
        with torch.no_grad():
            for m in tm.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        xin = x
        if dyadic:
            T._on_a_dyadic_grid(tm, gen)
            xin = (np.round(x * 256) / 256).astype(np.float32)
        tm.eval()
        p, s = convert.state_dict_to_jax_params(tm.state_dict(), module=tm)
        jm = jax_models.ESRGANGenerator(num_residuals=blocks)
        want_y, want = T._jax_qat_reference(jm, p, s, xin, t)
        with port_quant.fake_quant(), torch.no_grad():
            got_y = T._nhwc(tm(T._nchw(xin), route="autograd"))
        d = np.abs(got_y - want_y)
        row = {"blocks": blocks, "dyadic": dyadic, "max": float(d.max()),
               "share_past_1e-5": float(np.mean(d > 1e-5))}
        if dyadic:
            params = dict(tm.named_parameters())
            loss, _ = qat.qat_loss(tm, T._nchw(xin), T._nchw(t), 2.0)
            got = jax_tree.flatten(convert.state_dict_to_jax_params(dict(zip(
                params, torch.autograd.grad(loss, list(params.values())))),
                module=tm)[0])
            top = T._scale_elements(tm, xin)
            for key, scale_too in (("grad_worst_share", False),
                                   ("with_scale_elements", True)):
                row[key] = max(float(
                    np.abs(got[k] - np.asarray(w))[
                        np.ones(np.shape(w), bool) if scale_too or k not in top
                        else ~top[k]].max() / np.abs(np.asarray(w)).max())
                    for k, w in want.items())
        print(json.dumps(row), flush=True)


def qat_run(args):
    script = _script()
    family = "esrgan"
    gen, gp, gs, tm, meta = _load(script, family)
    size_eval = int(meta["size"])
    adam_init, adam_update = jax_optim.adam()
    opt = adam_init(gp)

    @jax.jit
    def jax_step(gp, opt, xin, target, lr):
        def loss_fn(gp):
            yf, _ = gen.apply(gp, gs, xin, train=False)
            with jax_quant.fake_quant():
                yq, _ = gen.apply(gp, gs, xin, train=False)
            return (jnp.mean((yf - target) ** 2) + jnp.mean((yq - target) ** 2)
                    + args.agree * jnp.mean((yq - yf) ** 2))
        loss, grads = jax.value_and_grad(loss_fn)(gp)
        gp2, opt2 = adam_update(grads, opt, gp, lr)
        return gp2, opt2, loss

    params = dict(tm.named_parameters())
    t_init, t_update = optim.adam()
    t_opt = t_init(params)
    heldout_draw = _draw(family, *jax.random.split(prng.key(77)), 16,
                         size_eval)

    def reading(step, gp):
        jax_rep = script.evaluate(family, gen, gp, gs, size_eval)
        port_rep = _port_report(family, tm, *heldout_draw)
        got = jax_tree.flatten(convert.state_dict_to_jax_params(
            tm.state_dict(), module=tm)[0])
        gap = max(float(np.abs(got[k] - np.asarray(v)).max())
                  for k, v in jax_tree.flatten(gp).items())
        print(json.dumps({"step": step, "lr": args.lr, "batch": args.batch,
                          "size": args.size, "jax_gain": jax_rep["gain_db"],
                          "port_gain": port_rep["gain_db"],
                          "param_gap": gap}), flush=True)

    reading(0, gp)
    keys = jax.random.split(prng.key(3000), args.steps)
    for i in range(args.steps):
        # the script's loss_fn: each step's key split, images then noise
        noisy01, clean01 = _draw(family, *jax.random.split(keys[i]),
                                 args.batch, args.size)
        gp, opt, loss = jax_step(gp, opt, jnp.asarray(noisy01),
                                 jnp.asarray(clean01), jnp.float32(args.lr))
        x = torch.from_numpy(noisy01).permute(0, 3, 1, 2)
        t = torch.from_numpy(clean01).permute(0, 3, 1, 2)
        with torch.enable_grad():
            t_loss, _ = qat.qat_loss(tm, x, t, args.agree)
            grads = torch.autograd.grad(t_loss, list(params.values()))
        t_update(dict(zip(params, grads)), t_opt, params, args.lr)
        if (i + 1) % args.every == 0:
            print(json.dumps({"step": i + 1, "jax_loss": float(loss),
                              "port_loss": float(t_loss)}), flush=True)
            reading(i + 1, gp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    h = sub.add_parser("heldout")
    h.add_argument("--seeds", type=int, nargs="+",
                   default=[77, 78, 79, 80, 81, 82, 83, 84])
    sub.add_parser("flips")
    q = sub.add_parser("qat")
    q.add_argument("--steps", type=int, default=60)
    q.add_argument("--every", type=int, default=20)
    q.add_argument("--batch", type=int, default=8)
    q.add_argument("--size", type=int, default=64)
    q.add_argument("--lr", type=float, default=2e-5)
    q.add_argument("--agree", type=float, default=2.0)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    {"heldout": heldout, "flips": flips, "qat": qat_run}[args.mode](args)


if __name__ == "__main__":
    main()
