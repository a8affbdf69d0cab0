"""The port's serving-weights trainer (``train/serving.py``,
``cli.train_serving_weights``, ``cli.srgan_frontier``) and its two examples,
against ``scripts/train_serving_weights.py`` on the CPU.

Small shapes (16²–32², batch 2); the same numpy inputs and parameters go
through the script's functions and the port's.  Tolerances are stated
where they are used.
"""

import base64
import hashlib
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu.ckpt import checkpoint as jax_ckpt
from celebrity_image_denoiser_tpu.core import prng
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.cli import srgan_frontier
from celebrity_image_denoiser_tpu_torch.cli import train_serving_weights
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    synth_clean_batch,
)
from celebrity_image_denoiser_tpu_torch.examples import multichip, quickstart
from celebrity_image_denoiser_tpu_torch.models.vgg import VGGFeatures
from celebrity_image_denoiser_tpu_torch.parallel.mesh import make_mesh
from celebrity_image_denoiser_tpu_torch.train import qat, serving
from torch_port_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights")
# the keys the script writes into a family's meta.json (:276-290, :310-317)
FAMILY_META = {"family", "steps", "pretrain_steps", "batch", "size", "lr",
               "stage_lr", "data", "psnr_out", "psnr_in", "gain_db",
               "fixture_gain_db"}
SRGAN_META = {"ema", "ema_selected", "lpips_out", "lpips_bicubic",
              "battery_gain_db"}
TOWER_META = {"kind", "steps", "final_mse", "data"}  # :583-585


@pytest.fixture(scope="module")
def script():
    """scripts/train_serving_weights.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "train_serving_weights_script",
        os.path.join(REPO, "scripts", "train_serving_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def _leaves(tree, prefix=""):
    """{dotted path: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(n=2, size=16, seed=0):
    """(noisy01, clean01) float32 NHWC numpy on [0, 1]."""
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    noisy = np.clip(clean + rng.normal(0, 0.1, clean.shape), 0, 1)
    return noisy.astype(np.float32), clean


def test_autoencoder_matches_the_script(script):
    """The tower's loss and every gradient leaf (VGG and decoder) against
    the script's ``VGGFeatures`` + ``_Decoder`` on the same parameters and
    batch: loss 1e-5 relative, each leaf within 1e-4 of its largest
    magnitude."""
    vgg, dec = jax_models.VGGFeatures(), script._Decoder()
    vp, vs = vgg.init(prng.key(3))
    dp, ds = dec.init(prng.key(4))
    noisy, clean = _batch()

    def loss_fn(params):
        feats, _ = vgg.apply(params["vgg"], vs, jnp.asarray(noisy))
        recon, _ = dec.apply(params["dec"], ds, feats)
        return jnp.mean((recon - jnp.asarray(clean)) ** 2)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(
        {"vgg": vp, "dec": dp})
    tv, td = VGGFeatures(), serving.Decoder()
    convert.load_jax_trees(tv, vp, vs)
    convert.load_jax_trees(td, dp, ds)
    params = {**{f"vgg.{k}": v for k, v in tv.named_parameters()},
              **{f"dec.{k}": v for k, v in td.named_parameters()}}
    loss = serving.autoencoder_loss(tv, td, torch.from_numpy(noisy),
                                    torch.from_numpy(clean))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    got = {}
    for name, mod in (("vgg", tv), ("dec", td)):
        sd = {k[len(name) + 1:]: v for k, v in grads.items()
              if k.startswith(name + ".")}
        got[name] = convert.state_dict_to_jax_params(sd, module=mod)[0]
    want, have = _leaves(jax.device_get(ref_grads)), _leaves(got)
    assert set(want) == set(have) and len(want) == 20
    for k, w in want.items():
        assert np.abs(have[k] - w).max() <= 1e-4 * np.abs(w).max(), k


def test_srgan_stage1_matches_the_script(script):
    """Stage 1's pixel MSE and its gradient against the script's
    composition (``jax.image.resize`` bicubic ×4 down, ``gen.apply`` in
    train mode, MSE) on the same noisy and clean arrays and weights: loss
    1e-5 relative, each gradient leaf within 5e-3 of its largest magnitude
    plus 1e-6 of the largest leaf's (JAX's f32 srgan
    gradient stands that far from float64,
    ``test_torch_port_train_families.py``; a bias before a train-mode
    BatchNorm has a gradient of 0 but for rounding), the BatchNorm
    statistics 1e-5."""
    gen = jax_models.SRGANGenerator(scale_factor=4)
    gp, gs = gen.init(prng.key(5))
    noisy, clean = _batch(size=32)

    def loss_fn(gp):
        n, h, w, c = noisy.shape
        lr01 = jax.image.resize(jnp.asarray(noisy), (n, h // 4, w // 4, c),
                                "bicubic")
        fake, gs2 = gen.apply(gp, gs, lr01 * 2.0 - 1.0, train=True)
        return jnp.mean((fake - (jnp.asarray(clean) * 2.0 - 1.0)) ** 2), gs2

    (ref_loss, ref_state), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(gp)
    tg, _ = serving.build_models("srgan", 32)
    convert.load_jax_trees(tg, gp, gs)
    tg.train()
    params = dict(tg.named_parameters())
    loss = serving.pretrain_loss(tg, torch.from_numpy(noisy),
                                 torch.from_numpy(clean))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    got = _leaves(convert.state_dict_to_jax_params(grads, module=tg)[0])
    want = _leaves(jax.device_get(ref_grads))
    assert set(got) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 5e-3 * np.abs(w).max() \
            + 1e-6 * top, k
    state = _leaves(convert.state_dict_to_jax_params(tg.state_dict(),
                                                     module=tg)[1])
    for k, w in _leaves(jax.device_get(ref_state)).items():
        assert np.abs(state[k] - w).max() <= 1e-5, k


def test_stage2_content_loss_matches_the_script(script, capsys):
    """srgan's stage-2 content loss, ``perceptual(f, c) + w·mean((f −
    c)²)`` on the shipped tower with ``to_unit``, against the script's
    ``load_perceptual`` composed the same way: 1e-5 relative; the random
    tower's warning and domain as the script's."""
    rng = np.random.default_rng(1)
    f = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    c = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    base = script.load_perceptual(os.path.join(WEIGHTS, "perceptual"))
    want = float(base(jnp.asarray(f), jnp.asarray(c))
                 + 2.0 * jnp.mean((jnp.asarray(f) - jnp.asarray(c)) ** 2))
    loss = serving.load_perceptual(os.path.join(WEIGHTS, "perceptual"))
    assert loss.to_unit
    got = float(serving.anchored(loss, 2.0)(_nchw(f), _nchw(c)))
    assert abs(got - want) <= 1e-5 * abs(want)
    # a checkpoint without a tower: random features and the script's
    # warning, from both
    capsys.readouterr()
    script.load_perceptual(os.path.join(WEIGHTS, "dncnn"))
    theirs = capsys.readouterr().out
    assert not serving.load_perceptual(os.path.join(WEIGHTS,
                                                    "dncnn")).to_unit
    ours = capsys.readouterr().out
    assert "WARNING random-init VGG features" in theirs
    assert ours.splitlines() == theirs.splitlines()


def _script_lr(base, i, n):
    """The script's decay (:150, :249), as written there."""
    frac = i / n
    return base * (1.0 if frac < 0.6 else 0.5 if frac < 0.85 else 0.25)


def _case_lr_schedule(script):
    for n in (1, 2, 5, 7, 20, 400):
        for i in range(n):
            assert 2e-4 * serving.lr_factor(i / n) == _script_lr(2e-4, i, n)


def _case_tower_schedule(script):
    for n in (1, 3, 10, 30):
        for i in range(n):  # :569 and :572
            assert 2e-4 * serving.tower_lr_factor(i, n) == \
                2e-4 * (1.0 if i / n < 0.7 else 0.3)
            assert serving.tower_variant(i) == 1 + i % 3


def _case_ema_update(script):
    """One EMA update against the script's tree map (:223-224): 1 ulp."""
    rng = np.random.default_rng(2)
    e = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    p = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    decay = 0.995
    want = jax.tree.map(lambda a, b: a * decay + b * (1.0 - decay),
                        [jnp.asarray(a) for a in e],
                        [jnp.asarray(b) for b in p])
    got = [torch.from_numpy(a.copy()) for a in e]
    serving.ema_update(got, [torch.from_numpy(b) for b in p], decay)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1.2e-7,
                                   atol=1e-9)


def _tiny_srgan(tmp_path, monkeypatch, gains, extra=()):
    """A CPU srgan run (16², 2 stage-1 and 2 stage-2 steps) whose
    evaluations return ``gains`` in turn; returns (result, the G state
    stage 2 began from and whether its optimisers were fresh, G's state at
    each evaluation)."""
    calls, seen = iter(gains), []

    def evaluate(family, gen, size):
        seen.append({k: v.clone() for k, v in gen.state_dict().items()})
        return {"gain_db": next(calls)}
    monkeypatch.setattr(serving, "_evaluate", evaluate)
    monkeypatch.setattr(qat, "record_fixture_gain",
                        lambda *a: {"fixture_gain_db": 0.0,
                                    "battery_gain_db": 0.0})
    began = {}
    real = serving.make_train_step

    def spy(gen, disc, **kw):
        init_fn, step_fn = real(gen, disc, **kw)

        def init():
            began["g"] = {k: v.clone() for k, v in gen.state_dict().items()}
            opt = init_fn()
            began["fresh"] = all(st.step == 0 and not any(
                m.any() for m in st.mu.values()) for st in opt)
            return opt
        return init, step_fn
    monkeypatch.setattr(serving, "make_train_step", spy)
    res = train_serving_weights.run(
        ["--family", "srgan", "--size", "16", "--batch", "2", "--chunk",
         "1", "--steps", "2", "--pretrain-steps", "2", "--pretrain-ckpt",
         str(tmp_path / "s1"), "--out", str(tmp_path / "w"), "--device",
         "cpu", *extra])
    return res, began, seen


def _case_ema_selection(script, tmp_path, monkeypatch):
    """Both endpoints are evaluated and the EMA ships only when its gain is
    higher (:263-270); it averages the parameters in tensors of its own,
    and the BatchNorm statistics stay the raw run's."""
    for raw_gain, ema_gain, selected in ((1.0, 2.0, True),
                                         (2.0, 2.0, False)):
        res, _, seen = _tiny_srgan(tmp_path / str(selected), monkeypatch,
                                   [0.0, raw_gain, ema_gain, 9.0],
                                   ("--ema", "0.5"))
        assert res["meta"]["ema"] == 0.5
        assert res["meta"]["ema_selected"] is selected
        _, raw, ema, final = seen
        stats = [k for k in raw if "running" in k or "num_batches" in k]
        weights = [k for k in raw if k not in stats]
        assert stats and all(torch.equal(ema[k], raw[k]) for k in stats)
        assert all(not torch.equal(ema[k], raw[k]) for k in weights)
        shipped = ema if selected else raw
        assert all(torch.equal(final[k], shipped[k]) for k in raw)


def _case_stage2_handover(script, tmp_path, monkeypatch):
    """Stage 2 starts from stage 1's G weights and BatchNorm statistics
    (the cache's), with fresh optimisers, at lr / 4 or --finetune-lr
    (:229-236)."""
    for extra, lr in (((), 2e-4 / 4), (("--finetune-lr", "3e-5"), 3e-5)):
        out = tmp_path / str(lr)
        res, began, _ = _tiny_srgan(out, monkeypatch, [0.0, 0.0], extra)
        assert res["meta"]["stage_lr"] == lr and res["meta"]["lr"] == 2e-4
        cache, meta = jax_ckpt.load_checkpoint(str(out / "s1"))
        assert meta["family"] == "srgan-stage1" and meta["steps"] == 2
        g, _ = serving.build_models("srgan", 16)
        convert.load_jax_trees(g, cache["generator"],
                               cache["generator_state"])
        for k, v in g.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, began["g"][k]), k
        assert began["fresh"]


@pytest.mark.parametrize("case", ["lr_schedule", "tower_schedule",
                                  "ema_update", "ema_selection",
                                  "stage2_handover"])
def test_schedules_and_ema_follow_the_script(case, script, tmp_path,
                                             monkeypatch):
    fn = globals()[f"_case_{case}"]
    if case in ("ema_selection", "stage2_handover"):
        fn(script, tmp_path, monkeypatch)
    else:
        fn(script)


def test_dncnn_trains_on_the_blind_sigma(tmp_path, monkeypatch):
    """The script's ``make_train_step`` call leaves JAX's
    ``dncnn_blind=True``, so dncnn trains on the blind σ whatever
    ``FAMILY_NOISE_VARIANT`` says; the port's steps draw it too (one blind
    launch a step, no variant launch)."""
    import inspect

    from celebrity_image_denoiser_tpu.train import gan_trainer as jax_gt
    from celebrity_image_denoiser_tpu_torch.train import gan_trainer

    assert inspect.signature(jax_gt.make_train_step).parameters[
        "dncnn_blind"].default is True
    calls = []
    for name in ("blind_gaussian_batch", "random_noise_batch"):
        real = getattr(gan_trainer.noise_lib, name)
        monkeypatch.setattr(gan_trainer.noise_lib, name,
                            lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    monkeypatch.setattr(serving, "_evaluate",
                        lambda *a: {"gain_db": 0.0})
    monkeypatch.setattr(qat, "record_fixture_gain",
                        lambda *a: {"fixture_gain_db": 0.0})
    train_serving_weights.run(["--family", "dncnn", "--steps", "2",
                               "--chunk", "1", "--batch", "2", "--size",
                               "16", "--out", str(tmp_path), "--device",
                               "cpu"])
    assert calls == ["blind_gaussian_batch"] * 2


def test_uint8_corpus_against_the_float_batch():
    """A difference kept by design: the port quantises the synthetic batch
    to uint8 before the noise kernel (the script noises the float batch).
    On the same float batch the quantised clean target is within 0.5/255,
    and a pixel MSE against it moves by at most 2·(0.5/255)·mean|f − c| +
    (0.5/255)²; the gap is printed."""
    clean01 = synth_clean_batch(torch.Generator().manual_seed(0), 4, 32)
    u8 = (clean01 * 255.0).round().to(torch.uint8)
    target = u8.float() / 255.0
    assert float((target - clean01).abs().max()) <= 0.5 / 255 + 1e-7
    fake = (clean01 + 0.05 * torch.randn(
        clean01.shape, generator=torch.Generator().manual_seed(1))).clamp(
            0, 1)
    gap = abs(float(torch.mean((fake - target) ** 2))
              - float(torch.mean((fake - clean01) ** 2)))
    bound = 2 * (0.5 / 255) * float((fake - clean01).abs().mean()) \
        + (0.5 / 255) ** 2
    print(f"uint8 corpus: MSE gap {gap:.3e} (bound {bound:.3e})")
    assert gap <= bound


def _tree_hash(root):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            with open(os.path.join(dirpath, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, script):
    """``cli.train_serving_weights`` on the CPU for dncnn, perceptual and
    srgan (2 stage-1 steps, EMA 0.5, a stage-1 cache), with ``weights/``
    hashed before and after.  The gains' recording runs with its int8
    server and the two gains stubbed (the server calibrates for 5–14 s on
    the CPU): ``test_torch_port_qat_export.py`` records a real int8
    server's gain through the same ``qat.record_fixture_gain``, and phase
    16 of ``chip_smoke.py`` these families' on the card."""
    from celebrity_image_denoiser_tpu_torch.serve import handlers, quality

    before = _tree_hash(WEIGHTS)
    out = tmp_path_factory.mktemp("sw")
    common = ["--chunk", "1", "--batch", "2", "--out", str(out / "w"),
              "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(handlers, "ServeState", lambda **kw: "served")
        mp.setattr(quality, "fixture_gain_db",
                   lambda st, model: {"dncnn": 2.5, "srgan": 1.25}[model])
        mp.setattr(quality, "srgan_battery_gain_db", lambda st: 0.5)
        runs = {
            "dncnn": train_serving_weights.run(
                ["--family", "dncnn", "--steps", "2", "--size", "16"]
                + common),
            "perceptual": train_serving_weights.run(
                ["--family", "perceptual", "--steps", "3", "--size", "16"]
                + common),
            "srgan": train_serving_weights.run(
                ["--family", "srgan", "--steps", "2", "--pretrain-steps",
                 "2", "--ema", "0.5", "--pretrain-ckpt", str(out / "s1"),
                 "--size", "32"] + common)}
    return out, runs, before


def test_cli_writes_the_script_layout(cli_runs):
    """Each run's ``meta.json`` has the script's keys, matches what the run
    returned, records the steps and the stage lr; the tower has its
    sections and loads as a trained one; ``weights/`` is untouched byte
    for byte."""
    out, runs, before = cli_runs
    for family, keys in (("dncnn", FAMILY_META),
                         ("srgan", FAMILY_META | SRGAN_META),
                         ("perceptual", TOWER_META)):
        with open(out / "w" / family / "meta.json") as f:
            meta = json.load(f)
        assert keys <= set(meta) and meta == runs[family]["meta"], family
    assert runs["srgan"]["meta"]["stage_lr"] == 2e-4 / 4
    assert (runs["srgan"]["meta"]["fixture_gain_db"],
            runs["srgan"]["meta"]["battery_gain_db"]) == (1.25, 0.5)
    assert runs["dncnn"]["meta"]["fixture_gain_db"] == 2.5
    assert "battery_gain_db" not in runs["dncnn"]["meta"]
    assert runs["srgan"]["meta"]["pretrain_steps"] == 2
    assert [c["stage"] for c in runs["srgan"]["chunks"]] == \
        ["srgan-pretrain"] * 2 + ["srgan"] * 2
    assert [c["stage"] for c in runs["perceptual"]["chunks"]] == \
        ["perceptual"] * 3
    sections, _ = jax_ckpt.load_checkpoint(str(out / "w" / "perceptual"))
    assert set(sections) == {"vgg"} and len(_leaves(sections["vgg"])) == 14
    assert serving.load_perceptual(str(out / "w" / "perceptual")).to_unit
    assert _tree_hash(WEIGHTS) == before


def test_written_checkpoints_serve_in_the_jax_package(cli_runs):
    """The port's dncnn and srgan files load in the JAX package's
    checkpoint reader with the JAX models' trees, and its ``ServeState``
    loads both and serves dncnn's (f32, a 32² request)."""
    from celebrity_image_denoiser_tpu.serve.handlers import (
        ServeState as JaxServeState,
    )
    from celebrity_image_denoiser_tpu_torch.data import imageio

    out, runs, _ = cli_runs
    for family, model in (("dncnn", jax_models.DnCNN()),
                          ("srgan", jax_models.SRGANGenerator(
                              scale_factor=4))):
        sections, meta = jax_ckpt.load_checkpoint(str(out / "w" / family))
        p, s = model.init(prng.key(0))
        assert jax.tree.structure(sections["generator"]) == \
            jax.tree.structure(p)
        assert jax.tree.structure(sections.get("generator_state") or {}) \
            == jax.tree.structure(s)
        assert meta == runs[family]["meta"]
    st = JaxServeState(weights_dir=str(out / "w"))
    assert {"dncnn", "srgan"} <= st._weights_loaded
    img = np.random.default_rng(0).integers(0, 256, (32, 32, 3), np.uint8)
    r = st.enhance("dncnn", imageio.encode_png(img), include_graph=False)
    y = imageio.decode_png(base64.b64decode(r["denoised_image_base64"]))
    assert y.shape[:2] == (32, 32)


def test_a_jax_written_stage1_cache_loads_in_the_port(tmp_path, capsys):
    """A stage-1 cache written by the JAX package's checkpoint writer (the
    script's sections and meta) loads into the port's srgan generator, and
    no stage-1 step runs."""
    gen = jax_models.SRGANGenerator(scale_factor=4)
    gp, gs = gen.init(prng.key(7))
    jax_ckpt.save_checkpoint(str(tmp_path / "s1"),
                             {"generator": gp, "generator_state": gs},
                             meta={"family": "srgan-stage1", "steps": 12})
    jax_ckpt.wait_for_saves()
    args = train_serving_weights.build_parser().parse_args(
        ["--family", "srgan", "--out", str(tmp_path), "--pretrain-ckpt",
         str(tmp_path / "s1"), "--size", "16", "--batch", "2"])
    g, _ = serving.build_models("srgan", 16)
    assert serving.srgan_pretrain(g, args, torch.device("cpu")) == []
    assert "loaded cached stage-1" in capsys.readouterr().out
    want = convert.jax_params_to_state_dict(jax.device_get(gp), module=g)
    for k, v in want.items():
        assert torch.equal(g.state_dict()[k], v), k


def test_cli_flags_and_refusals(script, tmp_path, monkeypatch):
    """The script's flags and defaults, plus ``--device``; ``--out``
    required; ``--family cgan`` refused as the script refuses it (its
    choices, and ``build_models``' message); ``--qat-steps`` reaches
    ``qat_finetune``; the card by default, which raises here."""
    import argparse

    seen = {}

    def capture(self, argv=None):
        seen["script"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        script.main([])
    monkeypatch.undo()
    theirs = {a.dest: (a.default, a.choices) for a in
              seen["script"]._actions if a.dest != "help"}
    ours = {a.dest: (a.default, a.choices) for a in
            train_serving_weights.build_parser()._actions
            if a.dest != "help"}
    assert set(ours) == set(theirs) | {"device"}
    for k, v in theirs.items():
        if k != "out":
            assert ours[k] == v, k
    assert ours["out"] == (None, None)
    with pytest.raises(SystemExit):
        train_serving_weights.build_parser().parse_args(["--family",
                                                         "dncnn"])
    with pytest.raises(SystemExit):
        train_serving_weights.run(["--family", "cgan", "--out",
                                   str(tmp_path)])
    with pytest.raises(ValueError) as ours_e:
        serving.build_models("cgan", 16)
    with pytest.raises(ValueError) as theirs_e:
        script.build_models("cgan", 16)
    assert str(ours_e.value) == str(theirs_e.value)
    calls = []
    monkeypatch.setattr(qat, "qat_finetune",
                        lambda **kw: calls.append(kw) or {"meta": {}})
    train_serving_weights.run(["--family", "esrgan", "--qat-steps", "5",
                               "--out", str(tmp_path), "--device", "cpu"])
    assert calls[0]["qat_steps"] == 5 and calls[0]["init_from"] == \
        os.path.join(str(tmp_path), "esrgan")
    with pytest.raises(RuntimeError, match="cuda"):
        train_serving_weights.run(["--family", "dncnn", "--out",
                                   str(tmp_path)])


def test_frontier_points_are_the_shell_scripts():
    """The three points' flags equal ``scripts/srgan_frontier.sh``'s, and
    each runs srgan at batch 16, 128², through the cached stage 1."""
    with open(os.path.join(REPO, "scripts", "srgan_frontier.sh")) as f:
        text = f.read()
    lines = re.findall(r"^run (\S+)\s+(.*)$", text, re.M)
    assert [(t, a.split()) for t, a in lines] == [
        (t, list(a)) for t, a in srgan_frontier.POINTS]
    assert re.search(r"--family srgan\s+\\\n\s+--batch 16 --size 128 "
                     r"--pretrain-steps \"\$PRE\" --pretrain-ckpt", text)
    assert "PRE=${1:-120000}" in text
    args = srgan_frontier.build_parser().parse_args(["--out", "sweep"])
    argvs = [srgan_frontier.point_argv(args, t, a)
             for t, a in srgan_frontier.POINTS]
    for argv, (tag, extra) in zip(argvs, srgan_frontier.POINTS):
        assert argv == ["--family", "srgan", "--batch", "16", "--size",
                        "128", "--pretrain-steps", "120000",
                        "--pretrain-ckpt", os.path.join("sweep", "stage1"),
                        "--out", os.path.join("sweep", tag), *extra,
                        "--device", "cuda"]
        train_serving_weights.build_parser().parse_args(argv)


def test_quickstart_on_the_cpu(tmp_path, monkeypatch):
    """The quickstart's five steps: the history handed to the plots (drawn
    in ``test_torch_port_extras.py``; matplotlib's text layout costs about
    9 s here), a finite held-out PSNR, the image, and a ``.pth`` that the
    port's server loads."""
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    plotted = []
    monkeypatch.setattr(quickstart, "plot_history",
                        lambda history, graph_dir: plotted.append(
                            (history, graph_dir)))
    res = quickstart.run(str(tmp_path), epochs=1, device="cpu")
    assert plotted == [(res["history"], str(tmp_path / "graphs"))]
    assert np.isfinite(res["psnr"]) and os.path.isfile(res["image"])
    assert res["steps"] == len(res["history"]["psnr"]) * 3
    st = ServeState(weights_dir=res["weights_dir"], device="cpu")
    assert "denoise" in st._weights_loaded


def test_multichip_in_process(tmp_path):
    """The walkthrough's in-process parts on the CPU: one rank's training
    (a gloo group of one, in this process) equal to the mesh-free steps,
    the sharded forward and ``tiled_apply``'s interior bit-equal to one
    device."""
    out = tmp_path / "rank0.json"
    multichip._rank(0, 1, f"file://{tmp_path}/pg", "gloo", "cpu", str(out))
    g, single = multichip.train_steps(torch.device("cpu"),
                                      multichip.global_batch(1))
    with open(out) as f:  # the group's BatchNorm sums in float64: 1e-4
        np.testing.assert_allclose(json.load(f), single, rtol=1e-4)
    assert np.isfinite(single).all()
    g.eval()
    mesh = make_mesh(devices=["cpu"] * 4)
    x = torch.rand((1, 256, 32, 3), generator=torch.Generator().manual_seed(1))
    assert multichip.sharded(g, mesh, x)["max_abs_diff"] == 0.0
    tiled = multichip.tiled(g, mesh, x)
    assert tiled["interior"] == 0.0 and tiled["finite"]
