"""The port's quantization-aware mode and fine-tune, its export to the
reference's ``.pth`` and ``.keras`` (with the port's own HDF5 writer), and
the eval, export, qat and bench CLIs, against the JAX package on the CPU.

Small shapes (32²); the same numpy inputs and weights go through the JAX
function and the port.  No JAX train step is compiled, and neither
TensorFlow nor Keras is imported: h5py reads the files here.  Tolerances are
stated where they are used.
"""

import contextlib
import json
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu.ops import quant as jax_quant
from celebrity_image_denoiser_tpu.utils import tree as jax_tree
from celebrity_image_denoiser_tpu_torch.ckpt import checkpoint as port_ckpt
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.ckpt import export as port_export
from celebrity_image_denoiser_tpu_torch.ckpt.keras import (
    H5File,
    load_keras_model,
    write_h5,
)
from celebrity_image_denoiser_tpu_torch.cli import export as cli_export
from celebrity_image_denoiser_tpu_torch.cli import qat as cli_qat
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    calibration_batch,
)
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.ops import quant
from celebrity_image_denoiser_tpu_torch.train import qat
from torch_port_threads import _one_torch_thread  # noqa: F401

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")
FAMILIES = ["denoise", "srgan", "esrgan", "dncnn", "cgan", "cgan_torch"]


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


def _on_a_dyadic_grid(tm, gen):
    """Weights with few bits (convs on 2⁻¹⁰, biases on 2⁻⁸), BatchNorm
    with mean 0, var + eps of ¼, 1 or 4 and scales of ½, 1 or 2, PReLU
    slopes of ¼: every float op before a quantizer is then exact in both
    packages, whatever their order of summation."""
    def grid(t, bits):
        return torch.round(t * 2.0 ** bits) / 2.0 ** bits

    def pick(values, n):
        return torch.tensor(values)[torch.randint(0, len(values), (n,),
                                                  generator=gen)]

    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(grid(m.weight, 10))
                m.bias.copy_(grid(m.bias, 8))
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.zero_()
                m.running_var.copy_(pick([0.25, 1.0, 4.0], c) - m.eps)
                m.weight.copy_(pick([0.5, 1.0, 2.0], c))
                m.bias.copy_(grid(torch.empty(c).uniform_(
                    -0.1, 0.1, generator=gen), 8))
            elif isinstance(m, torch.nn.PReLU):
                m.weight.fill_(0.25)


def _pair_of_models(name):
    """(JAX model, params, state, port module with the same weights): the
    port's seeded initialisation carried into JAX trees; esrgan's on
    ``_on_a_dyadic_grid``."""
    jm = (jax_models.DnCNN(depth=5) if name == "dncnn5"
          else jax_models.build_generator(name))
    gen = torch.Generator().manual_seed(0)
    tm = (registry.build_generator("dncnn", depth=5, generator=gen)
          if name == "dncnn5" else registry.build_generator(name,
                                                            generator=gen))
    with torch.no_grad():  # BatchNorm statistics that are not 0 and 1
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    if name == "esrgan":
        _on_a_dyadic_grid(tm, gen)
    p, s = convert.state_dict_to_jax_params(tm.state_dict(), module=tm)
    return jm, p, s, tm.eval()


# ---------------------------------------------------------------------------
# 7. fake_quant
def _jax_qat_reference(jm, p, s, x, t, agree=2.0):
    """JAX op by op: the fake-quant forward of ``x`` and the gradient of
    scripts/train_serving_weights.py's QAT loss (:366-378)

        mean((yf - t)²) + mean((yq - t)²) + agree · mean((yq - yf)²)

    from one pass (the two branches' VJPs)."""
    def branch(fq):
        def f(gp):
            with jax_quant.fake_quant() if fq else contextlib.nullcontext():
                return jm.apply(gp, s, jnp.asarray(x), train=False)[0]
        return jax.vjp(f, p)

    (yf, vjp_f), (yq, vjp_q) = branch(False), branch(True)
    n = yf.size
    t = jnp.asarray(t)
    gf = 2 * (yf - t) / n - 2 * agree * (yq - yf) / n
    gq = 2 * (yq - t) / n + 2 * agree * (yq - yf) / n
    grads = jax.tree.map(lambda a, b: a + b, vjp_f(gf)[0], vjp_q(gq)[0])
    return np.asarray(yq), jax_tree.flatten(grads)


@pytest.fixture(scope="module", params=["dncnn5", "denoise", "esrgan"])
def fq_case(request):
    """The full-depth esrgan trunk (16 quantized convs) spreads one flipped
    rounding over its whole output (seeded weights at 32²: max |Δ| 5.7e-3
    from JAX's, 99% of outputs past 1e-5; 1 block 3.3e-5: ``flips`` of
    tests/torch_port_qat_witness.py), so it runs on ``_on_a_dyadic_grid``
    with its input on 1/256, where no rounding can flip."""
    name = request.param
    jm, p, s, tm = _pair_of_models(name)
    x = calibration_batch(name == "denoise", 32)[:4].numpy()
    if name == "esrgan":
        x = np.round(x * 256) / 256
    r = np.random.default_rng(5)
    t = np.clip(x + 0.05 * r.standard_normal(x.shape), -1, 1).astype(
        np.float32)
    return name, tm, x, t, _jax_qat_reference(jm, p, s, x, t)


def test_fake_quant_forward_matches_jax(fq_case):
    """The same weights and batch: max |Δ| ≤ 1e-4 and ≥ 99% of outputs
    within 1e-5.  A rounding tie may flip: the float convs before a
    quantizer sum in another order on the two backends, so an activation a
    hair from a half step rounds the other way (about 0.3% of DnCNN's
    outputs move by ~3e-5)."""
    name, tm, x, _, (want, _) = fq_case
    with quant.fake_quant(), torch.no_grad():
        got = _nhwc(tm(_nchw(x), route="autograd"))
    d = np.abs(got - want)
    assert d.max() <= 1e-4 and np.mean(d <= 1e-5) >= 0.99, (d.max(),
                                                             np.mean(d > 1e-5))


def _scale_elements(tm, x):
    """Per conv weight of ``tm`` (HWIO, the JAX layout), each output
    channel's largest folded element under the fake-quant forward of ``x``:
    the one that sets the channel's weight scale, so its quotient sits on
    the ±127 clip bound to the last bit, where the clip takes half the
    gradient (as ``jnp.clip``'s does) and a hair past it none."""
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: inputs.__setitem__(n, a[0].detach()))
        for n, m in tm.named_modules() if isinstance(m, torch.nn.Conv2d)]
    with quant.fake_quant(), torch.no_grad():
        tm(_nchw(x), route="autograd")
    for h in hooks:
        h.remove()
    out = {}
    for n, xin in inputs.items():
        w = tm.get_submodule(n).weight.detach()
        s_c = quant.act_scale(xin.abs().amax(dim=(0, 2, 3)))
        wf = (w * s_c.view(1, -1, 1, 1)).abs().flatten(1)
        top = torch.zeros_like(wf, dtype=torch.bool)
        top[torch.arange(wf.shape[0]), wf.argmax(1)] = True
        out[f"{n}.kernel"] = top.view_as(w).permute(2, 3, 1, 0).numpy()
    return out


# each leaf's tolerance × its max: the U-Net's fake-quant forward agrees
# with JAX's to 3e-8 (no rounding flips), esrgan's on its dyadic grid to
# 2.3e-6 (the float tail conv's sums); DnCNN's BatchNorm stack flips
# about 0.3% of the quantizer's roundings between the backends (the forward
# test), which moves the upstream gradients by up to ~3e-4 of their max
GRAD_TOL = {"denoise": 1e-4, "dncnn5": 1e-3, "esrgan": 1e-4}
# and a floor × the largest gradient of the model, as the family train
# steps' first moments take it: esrgan's PReLU slopes (one scalar) and the
# biases before its BatchNorm sum 2¹⁶–2¹⁸ terms of both signs, so the order
# of float32 summation alone moves them by about 1e-4 of themselves
# (tests/torch_port_qat_witness.py flips: 1.1e-4 for another target)
GRAD_FLOOR = {"denoise": 0.0, "dncnn5": 0.0, "esrgan": 1e-5}


def test_qat_loss_gradient_matches_jax(fq_case):
    """``train/qat.py::qat_loss`` against the JAX gradient of the script's
    loss on the same batch (``_jax_qat_reference``): every leaf within
    ``GRAD_TOL`` of its max (or ``GRAD_FLOOR`` of the model's largest),
    apart from each conv output channel's scale-setting weight
    (``_scale_elements``), whose gradient is half or none by the last bit
    of its scale on either side."""
    name, tm, x, t, (_, want) = fq_case
    params = dict(tm.named_parameters())
    loss, _ = qat.qat_loss(tm, _nchw(x), _nchw(t), 2.0)
    got = convert.state_dict_to_jax_params(dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))), module=tm)[0]
    got = jax_tree.flatten(got)
    top = _scale_elements(tm, x)
    assert set(got) == set(want)
    floor = GRAD_FLOOR[name] * max(np.abs(np.asarray(w)).max()
                                   for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        keep = ~top[k] if k in top else np.ones(w.shape, bool)
        err = np.abs(got[k] - w)[keep].max()
        assert err <= max(GRAD_TOL[name] * np.abs(w).max(), floor), k


def test_fake_quant_tracks_ptq_and_flows_gradients():
    """tests/test_quant.py:695 on the port (``DnCNN(depth=5)``, the
    calibration batch at 32², ``x = calib[:4]``, no bias correction): > 40
    dB against the int8 program, quantized for real, a skip-all policy
    bit-equal to float, STE gradients finite and non-zero."""
    _, _, _, tm = _pair_of_models("dncnn5")
    calib = calibration_batch(False, 32)
    xt = calib[:4]
    with torch.no_grad():
        yf = _nhwc(tm(xt.permute(0, 3, 1, 2), route="autograd"))
        with quant.fake_quant():
            yfq = _nhwc(tm(xt.permute(0, 3, 1, 2), route="autograd"))
        with quant.fake_quant(skip=lambda w: True):
            y_id = _nhwc(tm(xt.permute(0, 3, 1, 2), route="autograd"))
    yq = quant.quantize_apply(tm, calib)(xt).numpy()
    db = 10 * np.log10(1.0 / max(float(np.mean((yfq - yq) ** 2)), 1e-12))
    assert db > 40.0, db
    assert not np.array_equal(yfq, yf)
    assert np.array_equal(y_id, yf)
    tm.zero_grad()
    with quant.fake_quant():
        y = tm(xt.permute(0, 3, 1, 2), route="autograd")
    ((y - xt.permute(0, 3, 1, 2)) ** 2).mean().backward()
    grads = [m.weight.grad for m in tm.modules()
             if isinstance(m, torch.nn.Conv2d)]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
    tm.zero_grad()


# ---------------------------------------------------------------------------
# 8. the QAT driver
@pytest.fixture()
def qat_source(tmp_path):
    """A meta-doctored copy of the shipped denoise checkpoint (held-out
    eval at 32², a recorded gain of 1 dB), as tests/test_cli.py:481."""
    src = tmp_path / "init" / "denoise"
    shutil.copytree(os.path.join(WEIGHTS, "denoise"), src)
    meta = json.loads((src / "meta.json").read_text())
    meta.update(size=32, gain_db=1.0)
    (src / "meta.json").write_text(json.dumps(meta))
    return src


def _qat_argv(src, out, lr):
    return ["--family", "denoise", "--qat-steps", "2", "--chunk", "2",
            "--batch", "2", "--size", "32", "--qat-lr", lr, "--init-from",
            str(src), "--out", str(out), "--device", "cpu"]


def test_cli_qat_ships_and_refuses(qat_source, tmp_path):
    """A gentle fine-tune ships with the QAT provenance and the served
    fixture gain; a destructive one is refused and leaves the shipped
    file byte-identical; the shipped checkpoint loads into the JAX
    package with the port's weights."""
    out = tmp_path / "out"
    res = cli_qat.run(_qat_argv(qat_source, out, "1e-7"))
    shipped = json.loads((out / "denoise" / "meta.json").read_text())
    assert shipped["qat_steps"] == 2 and shipped["qat_lr"] == 1e-7
    assert shipped["qat_agree"] == 2.0 and shipped["gain_db"] > 0.85
    assert shipped["fixture_gain_db"] == res["meta"]["fixture_gain_db"] > 0
    assert len(res["chunks"]) == 1 and res["chunks"][0]["steps"] == 2
    before = (out / "denoise" / "arrays.npz").read_bytes()
    with pytest.raises(SystemExit, match="REFUSING to ship"):
        cli_qat.main(_qat_argv(qat_source, out, "10.0"))
    assert (out / "denoise" / "arrays.npz").read_bytes() == before
    # the JAX package reads it: its forward equals the port's
    from celebrity_image_denoiser_tpu.ckpt import load_checkpoint

    sections, meta = load_checkpoint(str(out / "denoise"))
    assert meta["qat_steps"] == 2
    jm = jax_models.build_generator("denoise")
    tm = registry.build_generator("denoise").eval()
    convert.load_jax_trees(tm, *convert.state_dict_to_jax_params(
        convert.load_npz_state_dict(str(out / "denoise"), module=tm),
        module=tm))
    x = calibration_batch(True, 32)[:2].numpy()
    want, _ = jm.apply(sections["generator"],
                       sections.get("generator_state") or {},
                       jnp.asarray(x), train=False)
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), route="autograd"))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_cli_qat_lets_the_fixture_recording_fail(qat_source, tmp_path,
                                                 monkeypatch):
    """The JAX script catches a failed fixture recording with a warning;
    the port lets it raise, so an int8 kernel failure there stays loud (a
    difference by design)."""
    from celebrity_image_denoiser_tpu_torch.serve import quality

    def broken(*a, **k):
        raise RuntimeError("an int8 kernel failed")

    monkeypatch.setattr(quality, "fixture_gain_db", broken)
    with pytest.raises(RuntimeError, match="int8 kernel failed"):
        cli_qat.main(_qat_argv(qat_source, tmp_path / "out", "1e-7"))


def test_cli_qat_refuses_a_nan_gain(qat_source, tmp_path, monkeypatch):
    """A diverged fine-tune's NaN held-out gain is refused and nothing is
    written (the JAX script's ``<`` lets a NaN ship: a repair, by
    design)."""
    real = qat.evaluate
    calls = []

    def nan_after_the_fine_tune(*a, **k):
        calls.append(1)
        report = real(*a, **k)
        if len(calls) > 1:  # the first call reports the source
            report.update(psnr_out=float("nan"), gain_db=float("nan"))
        return report

    monkeypatch.setattr(qat, "evaluate", nan_after_the_fine_tune)
    with pytest.raises(SystemExit, match="REFUSING to ship"):
        cli_qat.main(_qat_argv(qat_source, tmp_path / "out", "1e-7"))
    assert len(calls) == 2 and not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def qat_script():
    """scripts/train_serving_weights.py as a module, as tests/test_cli.py
    loads it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_serving_weights_port", os.path.join(
            os.path.dirname(WEIGHTS), "scripts", "train_serving_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", qat.QAT_FAMILIES)
def test_heldout_report_matches_the_scripts_evaluate(family, qat_script):
    """The ship guard's measurement: ``train/qat.py::heldout_report`` on
    the script's own held-out draw (seed 77, 4 images at 32², the shipped
    weights) reads the script's ``evaluate`` report within 1e-3 dB, so the
    port's ``evaluate`` differs from the script's by its draw alone."""
    from celebrity_image_denoiser_tpu.ckpt import load_checkpoint
    from celebrity_image_denoiser_tpu.core import prng
    from celebrity_image_denoiser_tpu.core.config import FAMILY_NOISE_VARIANT
    from celebrity_image_denoiser_tpu.data import noise as jax_noise
    from celebrity_image_denoiser_tpu.data.synthetic import synth_clean_batch

    src = os.path.join(WEIGHTS, family)
    sections, _ = load_checkpoint(src)
    jm, _ = qat_script.build_models(family, 32)
    gs = sections.get("generator_state") or jm.init(prng.key(0))[1]
    want = qat_script.evaluate(family, jm, sections["generator"], gs, 32, n=4)
    k1, k2 = jax.random.split(prng.key(77))  # evaluate's draw
    clean01 = synth_clean_batch(k1, 4, 32)
    noisy01 = (jax_noise.blind_gaussian_batch(k2, clean01) if family == "dncnn"
               else jax_noise.random_noise_batch(
                   k2, clean01, variant=FAMILY_NOISE_VARIANT[family]))
    tm, _ = qat.load_generator(family, src, "cpu")
    got = qat.heldout_report(family, tm, torch.tensor(np.asarray(noisy01)),
                             torch.tensor(np.asarray(clean01)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3, (k, got[k], v)


def test_cli_qat_refuses_srgan_cgan_and_a_missing_out(tmp_path):
    for family in ("srgan", "cgan"):
        with pytest.raises(SystemExit, match="qat-steps supports"):
            cli_qat.main(["--family", family, "--out", str(tmp_path),
                          "--device", "cpu"])
    with pytest.raises(SystemExit):  # --out has no default
        cli_qat.build_parser().parse_args(["--family", "denoise"])


# ---------------------------------------------------------------------------
# 9. export
@pytest.mark.parametrize("family", FAMILIES)
def test_export_torch_state_dict_is_bit_equal_to_jax(family, tmp_path):
    """Keys, dtypes, shapes and values of JAX's ``export_torch_state_dict``
    (``num_batches_tracked`` 0 included); the port's ``.pth`` loads through
    JAX's ``load_pth_safely`` to JAX's own trees."""
    from celebrity_image_denoiser_tpu.ckpt import load_pth_safely
    from celebrity_image_denoiser_tpu.ckpt.export import (
        export_torch_state_dict as jax_export,
    )

    jm, p, s, tm = _pair_of_models(family)
    want, got = jax_export(jm, p, s), port_export.export_torch_state_dict(tm)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k
    path = str(tmp_path / "g.pth")
    port_export.save_pth(tm, path)
    p0, s0 = jax.tree.map(np.zeros_like, (p, s))  # templates to overlay
    p1, s1 = load_pth_safely(jm, path, p0, s0)
    for a, b in ((p, p1), (s, s1)):
        fa, fb = jax_tree.flatten(a), jax_tree.flatten(b)
        assert set(fa) == set(fb)
        assert all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k]))
                   for k in fa)


def test_keras_export_matches_jax_and_loads_both_ways(tmp_path):
    """The port's ``.keras`` against JAX's export of the same weights: the
    JSON entries byte-equal, the HDF5 tree and every dataset bit-equal in
    h5py; the port's ``H5File`` reads it; JAX's ``keras_import`` and the
    port's reader load it back to the weights it came from."""
    import h5py

    from celebrity_image_denoiser_tpu.ckpt.export import (
        export_keras_cgan as jax_export_keras,
    )
    from celebrity_image_denoiser_tpu.ckpt.keras_import import (
        load_keras_model as jax_load_keras,
    )

    jm, p, s, tm = _pair_of_models("cgan")
    jpath, tpath = str(tmp_path / "j.keras"), str(tmp_path / "t.keras")
    jax_export_keras(p, s, jpath)
    port_export.export_keras_cgan(tm, tpath)
    zj, zt = zipfile.ZipFile(jpath), zipfile.ZipFile(tpath)
    assert zj.namelist() == zt.namelist()
    for n in ("metadata.json", "config.json"):
        assert zj.read(n) == zt.read(n)
    import io

    hj = h5py.File(io.BytesIO(zj.read("model.weights.h5")), "r")
    ht = h5py.File(io.BytesIO(zt.read("model.weights.h5")), "r")
    names_j, names_t = [], []
    hj.visit(names_j.append)
    ht.visit(names_t.append)
    assert names_j == names_t
    own = H5File(zt.read("model.weights.h5"))
    for n in names_j:
        if isinstance(hj[n], h5py.Dataset):
            assert ht[n].dtype == hj[n].dtype == np.float32
            assert np.array_equal(ht[n][()], hj[n][()]), n
            assert np.array_equal(own[n], hj[n][()]), n
    p0, s0 = jax.tree.map(np.zeros_like, (p, s))
    p1, s1 = jax_load_keras(jm, tpath, p0, s0)
    for a, b in ((p, p1), (s, s1)):
        fa, fb = jax_tree.flatten(a), jax_tree.flatten(b)
        assert all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k]))
                   for k in fa)
    back = registry.build_generator("cgan")
    load_keras_model(back, tpath)
    for (k, v), w in zip(tm.state_dict().items(),
                         back.state_dict().values()):
        assert k.endswith("num_batches_tracked") or torch.equal(v, w), k


@pytest.mark.parametrize("members", [1, 3, 7, 8])
def test_h5_writer_groups_of_any_size_round_trip(members):
    """A group of up to 8 members (one symbol-table node), given in no
    order: h5py finds every member by name (the entries must be sorted)
    and reads it bit-equal, as does the port's reader."""
    import io

    import h5py

    r = np.random.default_rng(members)
    tree = {"layers": {f"m{i:03d}": {"vars": {"0": r.standard_normal(
        (i % 3 + 1, 2)).astype(np.float32)}} for i in r.permutation(members)},
        "empty": {}}
    buf = write_h5(tree)
    own = H5File(buf)
    with h5py.File(io.BytesIO(buf), "r") as h:
        assert sorted(h["layers"]) == sorted(tree["layers"])
        assert list(h["empty"]) == []
        for name, g in tree["layers"].items():
            assert np.array_equal(h[f"layers/{name}/vars/0"][()],
                                  g["vars"]["0"])
            assert np.array_equal(own[f"layers/{name}/vars/0"],
                                  g["vars"]["0"])
    assert own.list("layers") == sorted(tree["layers"])


def test_h5_writer_refuses_what_it_cannot_write():
    too_many = {"g": {f"m{i}": np.zeros(1, np.float32) for i in range(9)}}
    with pytest.raises(ValueError, match="at most 8"):
        write_h5(too_many)
    with pytest.raises(ValueError, match="float32"):
        write_h5({"d": np.zeros(2, np.float64)})
    with pytest.raises(ValueError, match="link name"):
        write_h5({"a/b": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------------
# 10. the export CLI
def test_cli_export_pth_and_the_format_rules(tmp_path):
    out = tmp_path / "denoise_epoch_499.pth"
    assert cli_export.main(["--model", "denoise", "--checkpoint",
                            os.path.join(WEIGHTS, "denoise"), "--out",
                            str(out)]) == 0
    tm = registry.build_generator("denoise")
    want = convert.load_npz_state_dict(os.path.join(WEIGHTS, "denoise"),
                                       module=tm)
    got = convert.load_pth_state_dict(str(out))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(SystemExit, match="cGAN generator's format"):
        cli_export.main(["--model", "denoise", "--checkpoint",
                         os.path.join(WEIGHTS, "denoise"), "--out",
                         str(tmp_path / "x.keras")])
    with pytest.raises(SystemExit, match="cgan_torch"):
        cli_export.main(["--model", "cgan", "--checkpoint",
                         os.path.join(WEIGHTS, "denoise"), "--out",
                         str(tmp_path / "x.pth")])


def test_cli_export_refuses_a_wrong_tree_and_missing_statistics(tmp_path):
    """The two faults of the JAX CLI (ADVICE.md:3-4), closed by design:
    each a ``SystemExit`` and no file."""
    out = tmp_path / "x.pth"
    with pytest.raises(SystemExit, match="does not hold the denoise"):
        cli_export.main(["--model", "denoise", "--checkpoint",
                         os.path.join(WEIGHTS, "srgan"), "--out", str(out)])
    assert not out.exists()
    sections, meta = port_ckpt.load_checkpoint(os.path.join(WEIGHTS,
                                                            "dncnn"))
    ck = str(tmp_path / "dncnn_no_state")
    port_ckpt.save_checkpoint(ck, {"generator": sections["generator"]}, meta)
    with pytest.raises(SystemExit, match="no 'generator_state'"):
        cli_export.main(["--model", "dncnn", "--checkpoint", ck, "--out",
                         str(out)])
    assert not out.exists()


def test_cli_export_keras_round_trips_the_shipped_cgan(tmp_path):
    """The shipped ``.keras`` read by the port, saved as an npz checkpoint
    and exported again: every dataset bit-equal to the shipped file's."""
    shipped = os.path.join(WEIGHTS, "cgan_epoch_500.keras")
    m = registry.build_generator("cgan")
    load_keras_model(m, shipped)
    params, state = convert.state_dict_to_jax_params(m.state_dict(), module=m)
    ck = str(tmp_path / "cgan_ck")
    port_ckpt.save_checkpoint(ck, {"generator": params,
                                   "generator_state": state})
    out = str(tmp_path / "cgan_epoch_500.keras")
    assert cli_export.main(["--model", "cgan", "--checkpoint", ck, "--out",
                            out]) == 0
    a = H5File(zipfile.ZipFile(shipped).read("model.weights.h5"))
    b = H5File(zipfile.ZipFile(out).read("model.weights.h5"))
    top = "layers"
    for layer in b.list(top):
        for v in b.list(f"{top}/{layer}/vars"):
            path = f"{top}/{layer}/vars/{v}"
            assert np.array_equal(a[path], b[path]), path


# ---------------------------------------------------------------------------
# 11. the eval CLI
@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    r = np.random.default_rng(0)
    for sub in ("in", "clean"):
        (d / sub).mkdir()
    for i in range(2):
        c = r.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        n = np.clip(c.astype(int) + r.integers(-20, 21, c.shape), 0,
                    255).astype(np.uint8)
        (d / "in" / f"{i}.png").write_bytes(imageio.encode_png(n))
        (d / "clean" / f"{i}.png").write_bytes(imageio.encode_png(c))
    return d


@pytest.mark.parametrize("model", ["denoise", "dncnn"])
def test_cli_eval_matches_jax(model, eval_dirs, tmp_path, monkeypatch):
    """The shipped weights, 2 PNGs at 32², ``--iterations 2``: the same
    file names, every output within 1 count (float sums in another order
    before the truncation to uint8), the mean PSNR within 1e-3 dB."""
    from celebrity_image_denoiser_tpu.cli import eval as jax_eval
    from celebrity_image_denoiser_tpu_torch.cli import eval as cli_eval

    jax_psnrs = []
    real = jax_eval.metrics.psnr
    monkeypatch.setattr(jax_eval.metrics, "psnr", lambda *a, **k: (
        jax_psnrs.append(float(real(*a, **k))) or jax_psnrs[-1]))
    base = ["--model", model, "--input-dir", str(eval_dirs / "in"),
            "--clean-dir", str(eval_dirs / "clean"), "--image-size", "32",
            "32", "--iterations", "2"]
    assert jax_eval.main(base + ["--output-dir", str(tmp_path / "j")]) == 0
    res = cli_eval.run(base + ["--output-dir", str(tmp_path / "t"),
                               "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == [
        "0_iter1.png", "0_iter2.png", "1_iter1.png", "1_iter2.png"]
    assert res["forwards"] == 4 and len(res["outputs"]) == 4
    for n in names:
        a = imageio.imread_rgb(str(tmp_path / "j" / n)).astype(int)
        b = imageio.imread_rgb(str(tmp_path / "t" / n)).astype(int)
        assert np.abs(a - b).max() <= 1, n
    assert res["psnr"] == pytest.approx(float(np.mean(jax_psnrs)), abs=1e-3)


# ---------------------------------------------------------------------------
# 12. the bench CLI, and every new entry point's card default
@pytest.fixture()
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-fallback path needs none")


def test_cli_bench_help_answers_and_the_run_needs_the_card(no_cuda, capsys):
    from celebrity_image_denoiser_tpu_torch.cli import bench as cli_bench

    with pytest.raises(SystemExit) as e:
        cli_bench.main(["--help"])
    assert e.value.code == 0 and "JSON" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="cuda"):
        cli_bench.main([])


def test_new_entry_points_default_to_the_card(no_cuda, qat_source, eval_dirs,
                                              tmp_path):
    from celebrity_image_denoiser_tpu_torch.cli import eval as cli_eval

    with pytest.raises(RuntimeError, match="cuda"):
        cli_qat.main(["--family", "denoise", "--init-from", str(qat_source),
                      "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="cuda"):
        cli_eval.main(["--input-dir", str(eval_dirs / "in"), "--output-dir",
                       str(tmp_path / "e")])
    assert not (tmp_path / "o").exists()
