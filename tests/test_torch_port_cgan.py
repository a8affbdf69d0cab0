"""The cGAN family of the port against the JAX package, on the CPU.

The same inputs, drawn from a seed with numpy, go through the JAX function
and the port's; each test states its tolerance.

* ``ckpt/keras.py``'s HDF5 reader equals h5py byte for byte on every
  dataset of the shipped ``weights/cgan_epoch_500.keras`` and of a file the
  JAX exporter writes, and refuses what it does not read (chunked,
  compressed, another datatype, a newer superblock) with a clear error.
* The Keras generator on the shipped weights: within 1e-5 of the JAX
  generator loaded by the JAX loader, within 1e-4 of ``keras.predict``;
  its kernel, plain and autograd routes within 1e-5 of each other (the
  first two run the transpose convs as phased 3×3 convs), each under
  cuDNN's deterministic flag, put back afterwards.  The
  torch generator and the Keras discriminator against JAX given the JAX
  parameters (1e-5), the image-condition path raising in both; the
  converter's Linear and Embedding both ways; Keras' BatchNorm train step
  and the transpose conv's padding against JAX.
* int8: the 4×4 stride-2 rewrites (``s2d_conv4x4_s8``, ``d2s_convt4x4_s8``)
  equal to the direct integer conv at the cGAN's three shapes and at odd
  sizes, refusing channel counts K5 does not take, their weights laid out
  once in each ``quantize_apply`` entry; given JAX's
  calibration batch, the int8 weights and scales bit-identical and the
  replay ≥ 60 dB of JAX's run op by op.
* Serving: ``POST /enhance?model=cgan`` against the JAX server (status,
  keys, ``backend``, shape, pixels within 1 count on ≥ 99.5%), the label
  400, ``cond_file`` 500 on the torch path and ignored on the Keras path,
  a label outside 0..9 a 400 on the port (200 on JAX) after which the port
  still serves;
  the int8 rung; a tiled request equal to the untiled one; the quality
  floor (1.0 dB) in f32 and int8, and a degraded checkpoint below it.
"""

import base64
import io
import json
import os
import threading
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu import ops as jops
from celebrity_image_denoiser_tpu.ckpt import load_keras_model as jax_load_keras
from celebrity_image_denoiser_tpu.ckpt.export import export_keras_cgan
from celebrity_image_denoiser_tpu.core import prng
from celebrity_image_denoiser_tpu.data import synthetic as jsynthetic
from celebrity_image_denoiser_tpu.ops import quant as jquant
from celebrity_image_denoiser_tpu.serve import quality as jquality
from celebrity_image_denoiser_tpu.serve.app import make_server as jax_make_server
from celebrity_image_denoiser_tpu.serve.handlers import ServeState as JaxState
from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.ckpt import keras as pkeras
from celebrity_image_denoiser_tpu_torch.core.config import default_weights_dir
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.models.cgan import (
    CGANKerasDiscriminator,
    CGANKerasGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.cgan_torch import (
    CGANTorchGenerator,
)
from celebrity_image_denoiser_tpu_torch.ops import quant
from celebrity_image_denoiser_tpu_torch.ops.conv import conv2d_transpose
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8 as k5
from celebrity_image_denoiser_tpu_torch.ops.norm import KerasBatchNorm2d
from celebrity_image_denoiser_tpu_torch.serve import quality
from celebrity_image_denoiser_tpu_torch.serve.app import make_server
from celebrity_image_denoiser_tpu_torch.serve.handlers import KERAS, ServeState
from celebrity_image_denoiser_tpu_torch.utils import tree as treelib
from torch_port_threads import _one_torch_thread  # noqa: F401

WEIGHTS = default_weights_dir()
SHIPPED = os.path.join(WEIGHTS, "cgan_epoch_500.keras")
FLOOR = 1.0  # cgan records no margin: tests/test_serve.py:495-519


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _s8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


# ---------------------------------------------------------------------------
# the HDF5 reader
def _h5_bytes(path):
    with zipfile.ZipFile(path) as z:
        return z.read("model.weights.h5")


def _datasets_equal_h5py(buf):
    h5py = pytest.importorskip("h5py")
    ours = pkeras.H5File(buf)
    names = []
    with h5py.File(io.BytesIO(buf), "r") as h:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                ref, got = obj[()], ours[name]
                assert got.dtype == ref.dtype and got.shape == ref.shape, name
                assert got.tobytes() == ref.tobytes(), name
                names.append(name)
            else:
                assert ours.list(name) == list(obj), name
        h.visititems(visit)
        assert ours.list("/") == list(h)
    return names


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A .keras file written by the JAX exporter from a seeded init."""
    jm = jax_models.CGANKerasGenerator()
    p, s = jm.init(prng.key(5))
    path = str(tmp_path_factory.mktemp("export") / "exported.keras")
    export_keras_cgan(p, s, path)
    return path, jm, p, s


@pytest.mark.parametrize("which", ["shipped", "exported"])
def test_h5_reader_equals_h5py(exported, which):
    path = SHIPPED if which == "shipped" else exported[0]
    names = _datasets_equal_h5py(_h5_bytes(path))
    assert len(names) == 22  # 3 convs, 2 transpose convs, 3 BatchNorms
    layers, weights = pkeras.read_keras_file(path)
    assert [l["class_name"] for l in layers][-1] == "Conv2D"
    assert [w.shape for w in weights["conv2d_transpose"]] == [
        (4, 4, 128, 128), (128,)]


def _write_h5(tmp_path, **kw):
    h5py = pytest.importorskip("h5py")
    libver = kw.pop("libver", None)
    data = kw.pop("data", np.arange(24, dtype=np.float32).reshape(4, 6))
    buf = io.BytesIO()
    with h5py.File(buf, "w", **({"libver": libver} if libver else {})) as h:
        h.create_group("layers").create_dataset("w", data=data, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kw, match", [
    ({"chunks": (2, 3)}, "chunked"),
    ({"compression": "gzip"}, "filtered"),
    ({"data": np.arange(6, dtype=np.float64)}, "float32"),
    ({"data": np.arange(6, dtype=">f4")}, "float32"),
    ({"libver": "latest"}, "superblock version"),
], ids=["chunked", "gzip", "float64", "big_endian", "new_superblock"])
def test_h5_reader_refuses_what_it_does_not_read(tmp_path, kw, match):
    buf = _write_h5(tmp_path, **kw)
    with pytest.raises(pkeras.H5FormatError, match=match):
        pkeras.H5File(buf)["layers/w"]


def test_h5_reader_reads_a_plain_dataset_and_names_a_missing_one(tmp_path):
    f = pkeras.H5File(_write_h5(tmp_path))
    np.testing.assert_array_equal(
        f["layers/w"], np.arange(24, dtype=np.float32).reshape(4, 6))
    with pytest.raises(KeyError, match="nope"):
        f["layers/nope"]
    with pytest.raises(pkeras.H5FormatError, match="not an HDF5 file"):
        pkeras.H5File(b"PK\x03\x04" + bytes(100))


def test_keras_loader_refuses_a_model_that_does_not_fit(exported):
    from celebrity_image_denoiser_tpu_torch.models.dncnn import DnCNN

    with pytest.raises(ValueError, match="shape mismatch"):
        pkeras.load_keras_model(DnCNN(depth=5), exported[0])
    with pytest.raises(ValueError, match="layer-count"):
        pkeras.load_keras_model(CGANKerasDiscriminator(), exported[0])


# ---------------------------------------------------------------------------
# the Keras generator
@pytest.fixture(scope="module")
def shipped():
    """(JAX model, params, state, port model), both from the shipped file."""
    jm = jax_models.CGANKerasGenerator()
    p, s = jm.init(prng.key(0))
    p, s = jax_load_keras(jm, SHIPPED, p, s)
    pm = CGANKerasGenerator().eval()
    pkeras.load_keras_model(pm, SHIPPED)
    return jm, p, s, pm


def _routes(pm, x):
    with torch.no_grad():
        return {r: _nhwc(pm(_nchw(x), route=r))
                for r in ("kernel", "plain", "autograd")}


@pytest.mark.parametrize("hw", [(32, 40), (64, 64)])
def test_shipped_generator_matches_jax(shipped, hw):
    """Every route within 1e-5 of the JAX generator on the same weights;
    the routes within 1e-5 of each other (the tail's sums run in another
    order on the kernel and plain routes)."""
    jm, p, s, pm = shipped
    x = np.random.default_rng(hw[0]).uniform(-1, 1, (2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(p, s, jnp.asarray(x), train=False)[0])
    got = _routes(pm, x)
    for route, y in got.items():
        np.testing.assert_allclose(y, want, atol=1e-5, err_msg=route)
    np.testing.assert_allclose(got["kernel"], got["autograd"], atol=1e-5)
    np.testing.assert_array_equal(got["kernel"], got["plain"])


def test_shipped_generator_matches_real_keras_predict(shipped, rng_np):
    """As ``tests/test_tf_golden.py:97-114``: the port's reader and model
    against ``keras.saving.load_model(...).predict``, 1e-4."""
    pytest.importorskip("tensorflow")
    keras = pytest.importorskip("keras")
    km = keras.saving.load_model(SHIPPED, compile=False)
    x = rng_np.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = km.predict(x, verbose=0)
    np.testing.assert_allclose(_routes(shipped[3], x)["kernel"], ref,
                               atol=1e-4)


def test_exported_file_loads_into_the_port(exported):
    path, jm, p, s = exported
    pm = CGANKerasGenerator().eval()
    pkeras.load_keras_model(pm, path)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 24, 28, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(p, s, jnp.asarray(x), train=False)[0])
    np.testing.assert_allclose(_routes(pm, x)["kernel"], want, atol=1e-5)


def test_routes_refuse_train_mode_and_gradients():
    m = CGANKerasGenerator()
    x = torch.rand(1, 3, 8, 8)
    with pytest.raises(ValueError, match="eval"):
        m(x)
    m.eval()
    with pytest.raises(RuntimeError, match="no backward"):
        m(x, route="plain")
    m(x, route="autograd").sum().backward()


@pytest.mark.parametrize("route", ["kernel", "plain", "autograd"])
def test_generator_runs_cudnn_deterministic_and_puts_the_flag_back(
        monkeypatch, route):
    """Every cuDNN conv of the Keras generator's forward before its tail
    runs with ``torch.backends.cudnn.deterministic`` set, and the flag is
    back as it was after the forward; the kernel and plain routes run no
    transpose conv (their phased 3×3 convs stand in); scopes that overlap
    in two threads keep the flag set until the last one leaves."""
    from celebrity_image_denoiser_tpu_torch.core.device import (
        deterministic_cudnn,
    )

    m = CGANKerasGenerator(generator=torch.Generator().manual_seed(0)).eval()
    seen = []
    for name in ("conv2d", "conv_transpose2d"):
        real = getattr(torch.nn.functional, name)
        monkeypatch.setattr(torch.nn.functional, name, lambda *a, real=real,
                            name=name, **k: (seen.append(
                                (name, torch.backends.cudnn.deterministic)),
                                real(*a, **k))[1])
    assert torch.backends.cudnn.deterministic is False
    with torch.no_grad():
        m(torch.rand(1, 3, 8, 8), route=route)
    body = (["conv2d"] * 2 + ["conv_transpose2d"] * 2 if route == "autograd"
            else ["conv2d"] * 4)
    assert seen[:4] == [(name, True) for name in body]
    assert torch.backends.cudnn.deterministic is False

    entered, leave = threading.Event(), threading.Event()

    def other():
        with deterministic_cudnn():
            entered.set()
            leave.wait(10)

    t = threading.Thread(target=other)
    t.start()
    assert entered.wait(10)
    with deterministic_cudnn():
        pass
    assert torch.backends.cudnn.deterministic is True  # the thread's scope
    leave.set()
    t.join(10)
    assert torch.backends.cudnn.deterministic is False


# ---------------------------------------------------------------------------
# the torch generator, the discriminator, the building blocks
def _jax_init(jm, seed):
    """JAX's init, with BatchNorm statistics drawn away from (0, 1) so that
    eval mode shows them."""
    p, s = jm.init(prng.key(seed))
    rng = np.random.default_rng(seed)
    flat = treelib.flatten(s)
    for k, v in flat.items():
        shape = np.shape(v)
        flat[k] = (rng.uniform(0.5, 1.5, shape) if k.endswith("var")
                   else rng.normal(0, 0.1, shape)).astype(np.float32)
    return p, treelib.unflatten(flat)


def test_torch_generator_matches_jax_given_its_parameters():
    """Label path within 1e-5 of JAX (eval mode, the same z and labels);
    the image-condition path raises in both."""
    jm = jax_models.CGANTorchGenerator()
    p, s = _jax_init(jm, 11)
    pm = CGANTorchGenerator().eval()
    convert.load_jax_trees(pm, p, s)
    rng = np.random.default_rng(12)
    z = rng.normal(size=(3, 100)).astype(np.float32)
    labels = np.array([0, 5, 9])
    want = np.asarray(jm.apply(p, s, jnp.asarray(z), jnp.asarray(labels),
                               train=False)[0])
    with torch.no_grad():
        got = _nhwc(pm(_t(z), _t(labels)))
    assert got.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    img = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    with pytest.raises(Exception):
        jm.apply(p, s, jnp.asarray(img), jnp.asarray(img), train=False)
    with pytest.raises(RuntimeError):
        pm(_nchw(img), _nchw(img))
    with pytest.raises(ValueError, match="condition"):
        pm(_t(z))


def test_discriminator_matches_jax_given_its_parameters():
    """Flatten in NHWC order into the Linear: within 1e-5 of JAX."""
    jm = jax_models.CGANKerasDiscriminator(input_hw=(32, 24))
    p, s = _jax_init(jm, 13)
    pm = CGANKerasDiscriminator(input_hw=(32, 24)).eval()
    convert.load_jax_trees(pm, p, s)
    x = np.random.default_rng(14).uniform(-1, 1, (2, 32, 24, 3)).astype(
        np.float32)
    want = np.asarray(jm.apply(p, s, jnp.asarray(x), train=False)[0])
    with torch.no_grad():
        got = pm(_nchw(x)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_linear_and_embedding_cross_both_ways():
    jm = jax_models.CGANTorchGenerator()
    p, s = _jax_init(jm, 15)
    pm = CGANTorchGenerator()
    convert.load_jax_trees(pm, p, s)
    assert torch.equal(pm.l1.weight, _t(p["l1"]["kernel"]).T)
    assert torch.equal(pm.label_emb.weight, _t(p["label_emb"]["table"]))
    back_p, back_s = convert.state_dict_to_jax_params(pm.state_dict(),
                                                      module=pm)
    flat, want = (treelib.flatten(t) for t in (back_p, p))
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], np.asarray(want[k]), k)
    with pytest.raises(ValueError, match="lands in"):
        convert.jax_params_to_state_dict(
            {"l1": {"table": np.zeros((200, 8192), np.float32)}}, module=pm)


def test_keras_batch_norm_matches_jax_in_train_and_eval():
    """One train step (output and both running statistics, the biased
    variance in the update) and eval mode: within 1e-5 of
    ``ops.batch_norm(keras_momentum=True)``."""
    rng = np.random.default_rng(16)
    x = rng.normal(1.0, 2.0, (4, 6, 5, 7)).astype(np.float32)
    gamma, beta = rng.normal(1, 0.1, 7), rng.normal(0, 0.1, 7)
    mean0, var0 = rng.normal(0, 0.1, 7), rng.uniform(0.5, 1.5, 7)
    params = {"scale": jnp.asarray(gamma, jnp.float32),
              "bias": jnp.asarray(beta, jnp.float32)}
    state = {"mean": jnp.asarray(mean0, jnp.float32),
             "var": jnp.asarray(var0, jnp.float32)}
    bn = KerasBatchNorm2d(7)
    with torch.no_grad():
        for t, v in ((bn.weight, gamma), (bn.bias, beta),
                     (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(_t(v.astype(np.float32)))
    for train in (True, False):
        bn.train(train)
        want, new = jops.batch_norm(jnp.asarray(x), params, state,
                                    train=train, eps=1e-3, momentum=0.99,
                                    keras_momentum=True)
        with torch.no_grad():
            got = _nhwc(bn(_nchw(x)))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(new["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(new["var"]), atol=1e-6)
        state = new


@pytest.mark.parametrize("k, stride, padding", [(4, 2, 1), (2, 2, 0),
                                                (3, 1, 1), (3, 2, 0)])
def test_transpose_conv_padding_matches_jax(k, stride, padding):
    """Output (in - 1)·s - 2p + k, within 1e-5 of the JAX op; 2×2 without
    padding (the U-Net's) is the same call as before."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)  # (kH, kW, O, I)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = np.asarray(jops.conv2d_transpose(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
        padding=padding))
    got = _nhwc(conv2d_transpose(_nchw(x), _t(w).permute(3, 2, 0, 1), _t(b),
                                 stride=stride, padding=padding))
    assert got.shape == want.shape == (
        2, 4 * stride - 2 * padding + k, 6 * stride - 2 * padding + k, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# int8: the rewrites and the generic transform
# (N, C_in, H, W, C_out): the cGAN's layers at a 64² input, then odd sizes
S2D_CASES = [(2, 64, 32, 32, 128), (1, 64, 9, 7, 128), (1, 8, 6, 10, 16)]
D2S_CASES = [(2, 128, 16, 16, 128), (1, 128, 32, 32, 64), (1, 32, 5, 3, 12)]


@pytest.mark.parametrize("case", S2D_CASES, ids=["cgan_64_128", "odd_hw",
                                                 "cin_8"])
def test_space_to_depth_rewrite_is_the_direct_conv(case):
    """K5's 3×3 conv of the space-to-depth input (its plain version here:
    exact integers) equals the direct 4×4 stride-2 padding-1 integer conv
    bit for bit; the rewrite issues 2.25× the useful multiply-adds."""
    n, c, h, w, co = case
    rng = np.random.default_rng(sum(case))
    x, wt = _s8(rng, n, c, h, w), _s8(rng, co, c, 4, 4)
    ws = _t(rng.uniform(1e-5, 1e-3, co).astype(np.float32))
    w3 = quant.s2d_conv4x4_weight(wt)
    assert w3.shape == (co, 3, 3, 4 * c) and w3.dtype == torch.int8
    assert int((w3 != 0).sum()) == int((wt != 0).sum())
    got = quant.s2d_conv4x4_s8(x, w3, ws)
    want = quant.int8_conv2d(x, wt, ws, 2, 1)  # the direct conv on the CPU
    direct = torch.nn.functional.conv2d(x.double(), wt.double(), stride=2,
                                        padding=1).to(torch.int32)
    assert torch.equal(want, direct.float() * ws.view(1, -1, 1, 1))
    assert got.shape == want.shape == (n, co, h // 2, w // 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", D2S_CASES, ids=["cgan_128_128",
                                                 "cgan_128_64", "odd_hw"])
def test_depth_to_space_rewrite_is_the_direct_transpose_conv(case):
    """K5's 3×3 conv with four output-phase groups, then depth-to-space,
    equals the direct 4×4 stride-2 padding-1 integer transpose conv bit for
    bit."""
    n, c, h, w, co = case
    rng = np.random.default_rng(sum(case))
    x, wt = _s8(rng, n, c, h, w), _s8(rng, c, co, 4, 4)
    ws = _t(rng.uniform(1e-5, 1e-3, co).astype(np.float32))
    w3 = quant.d2s_convt4x4_weight(wt)
    assert w3.shape == (4 * co, 3, 3, c)
    assert int((w3 != 0).sum()) == int((wt != 0).sum())
    got = quant.d2s_convt4x4_s8(x, w3, ws.repeat(4))
    want = quant.int8_conv_transpose2d(x, wt, ws, 2, 1)
    direct = torch.nn.functional.conv_transpose2d(
        x.double(), wt.double(), stride=2, padding=1).to(torch.int32)
    assert torch.equal(want, direct.float() * ws.view(1, -1, 1, 1))
    assert got.shape == want.shape == (n, co, 2 * h, 2 * w)
    assert torch.equal(got, want)


def _on_a_card(x):
    return type("OnCard", (), {"device": torch.device("cuda")})()


@pytest.mark.parametrize("transposed, c_in", [(False, 12), (False, 72),
                                              (True, 48), (True, 288)])
def test_rewrites_refuse_channels_k5_does_not_take(monkeypatch, transposed,
                                                   c_in):
    """K5 takes multiples of 32 up to 256 input channels: the rewrite's
    K5 call refuses the rest, and on a card the replay raises
    ``NoInt8Kernel`` for such a conv (the ladder then moves down a rung)."""
    rng = np.random.default_rng(c_in)
    x = _s8(rng, 1, c_in, 4, 4)
    ws = torch.full((32,), 1e-3)
    if transposed:
        wt = _s8(rng, c_in, 32, 4, 4)
        with pytest.raises(ValueError, match="multiple of 32|at most 256"):
            quant.d2s_convt4x4_s8(x, quant.d2s_convt4x4_weight(wt),
                                  ws.repeat(4))
        run = lambda: quant.int8_conv_transpose2d(x, wt, ws, 2, 1)  # noqa
    else:
        wt = _s8(rng, 32, c_in, 4, 4)
        with pytest.raises(ValueError, match="multiple of 32|at most 256"):
            quant.s2d_conv4x4_s8(x, quant.s2d_conv4x4_weight(wt), ws)
        run = lambda: quant.int8_conv2d(x, wt, ws, 2, 1)  # noqa: E731
    assert quant._k5_takes(c_in if transposed else 4 * c_in) is False
    run()  # the CPU computes every geometry directly
    real = quant._no_kernel
    monkeypatch.setattr(quant, "_no_kernel",
                        lambda xx, *a: real(_on_a_card(xx), *a))
    with pytest.raises(quant.NoInt8Kernel, match="padding"):
        run()


def test_rewrite_weights_are_laid_out_once_per_entry(monkeypatch):
    """``rewrite_weights`` gives each 4×4 layer's K5 weights and scales
    (the transpose conv's repeated per phase) and None for another kernel
    size; ``quantize_apply`` stores them as the entry's last field (None on
    the CPU, where the replay computes the direct conv), and the replay
    hands that field to the layer's int8 function at every call."""
    rng = np.random.default_rng(5)
    ws = _t(rng.uniform(1e-5, 1e-3, 16).astype(np.float32))
    wt = _s8(rng, 16, 8, 4, 4)
    w3, s3 = quant.rewrite_weights(wt, ws, False)
    assert torch.equal(w3, quant.s2d_conv4x4_weight(wt)) and s3 is ws
    w3, s3 = quant.rewrite_weights(wt.transpose(0, 1), ws, True)
    assert torch.equal(w3, quant.d2s_convt4x4_weight(wt.transpose(0, 1)))
    assert torch.equal(s3, ws.repeat(4))
    assert quant.rewrite_weights(_s8(rng, 16, 8, 3, 3), ws, False) is None

    m = CGANKerasGenerator(generator=torch.Generator().manual_seed(1)).eval()
    calib = _t(rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32))
    q = quant.quantize_apply(m, calib)
    assert [e[3:] for e in q.entries if e is not None] == [(None, None)] * 3
    marks = [("s2d",), ("d2s1",), ("d2s2",)]
    entries = [e if e is None else (*e[:4], mark) for e, mark in zip(
        q.entries, [None] + marks + [None])]
    seen = []
    for name in ("int8_conv2d", "int8_conv_transpose2d"):
        real = getattr(quant, name)
        monkeypatch.setattr(quant, name, lambda *a, real=real, **k: (
            seen.append(a[5]), real(*a[:5]))[1])
    for _ in range(2):
        quant.QuantizedApply(m, entries)(calib[:1])
    assert seen == marks * 2


def _jax_amaxes(jm, p, s, calib):
    tap = jquant._Calibrate()

    def cal(x):
        tap.taps.clear()
        with jquant._mode(tap):
            jm.apply(p, s, x, train=False)
        return [t[0] for t in tap.taps]

    return [np.asarray(a) for a in jax.jit(cal)(jnp.asarray(calib))]


def test_int8_quantization_matches_jax_given_its_calibration_batch(shipped):
    """On the shipped weights, given JAX's calibration batch (the shared
    tanh recipe, σ 0.12, at 32²): per conv the amaxes within 1e-6 of the
    layer's largest, the int8 weights and scales bit-identical given the
    same amaxes, the same three convs quantized (the 3-channel head and
    tail float), and the replay ≥ 60 dB of JAX's run op by op."""
    jm, p, s, pm = shipped
    calib = np.asarray(jsynthetic.calibration_batch(True, size=32))
    want = _jax_amaxes(jm, p, s, calib)
    taps = quant.calibrate(pm, _t(calib))
    assert len(taps) == len(want) == 5
    jentries, pentries = [], []
    for (amax, weight, transposed, _), wamax in zip(taps, want):
        assert np.abs(amax.numpy() - wamax).max() <= 1e-6 * wamax.max()
        if quant.default_skip_policy(weight):
            jentries.append(None)
            pentries.append(None)
            continue
        # the JAX layouts: HWIO, or (kH, kW, C_out, C_in) for a transpose
        kernel = jnp.asarray(weight.permute(2, 3, 1, 0).numpy())
        s_c = jquant.act_scale(jnp.asarray(wamax))
        fold = (1, 1, 1, -1) if transposed else (1, 1, -1, 1)
        jw, jscale = jquant.quantize_weight(kernel * s_c.reshape(fold),
                                            2 if transposed else -1)
        pw, pscale, ps_c = quant.fold_and_quantize(
            weight, quant.act_scale(_t(wamax)), transposed)
        np.testing.assert_array_equal(pw.permute(2, 3, 1, 0).numpy(),
                                      np.asarray(jw))
        np.testing.assert_array_equal(_bits(pscale), _bits(jscale))
        np.testing.assert_array_equal(_bits(ps_c), _bits(s_c))
        jentries.append((jw, jscale, s_c))
        pentries.append((pw, pscale, ps_c))
    assert [e is None for e in pentries] == [True, False, False, False, True]
    x = calib[:2]
    with jquant._mode(jquant._Int8Apply(list(jentries))):
        yj = np.asarray(jm.apply(p, s, jnp.asarray(x), train=False)[0])
    yt = quant.QuantizedApply(pm, pentries)(_t(x)).numpy()
    mse = max(float(np.mean((yt - yj) ** 2)), 1e-20)
    assert 10 * np.log10(4.0 / mse) >= 60.0


# ---------------------------------------------------------------------------
# serving
BOUNDARY = "cganportboundary"


def _form(fields):
    body = b""
    for name, filename, data in fields:
        disp = f"form-data; name=\"{name}\"" + (
            f"; filename=\"{filename}\"\r\nContent-Type: image/png"
            if filename else "")
        body += (f"--{BOUNDARY}\r\nContent-Disposition: {disp}\r\n\r\n"
                 ).encode() + data + b"\r\n"
    return body + f"--{BOUNDARY}--\r\n".encode()


def _post(base, query, body):
    req = urllib.request.Request(
        f"{base}/enhance?{query}", data=body, method="POST",
        headers={"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([120 + 80 * np.sin(xx / 5.0), 100 + 60 * np.cos(yy / 7.0),
                     90 + 50 * np.sin((xx + yy) / 9.0)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(
        np.uint8)


def _decoded(payload):
    return imageio.decode_png(base64.b64decode(
        payload["denoised_image_base64"]))


@pytest.fixture(scope="module")
def servers():
    out, threads = {}, []
    for name, srv in (
            ("jax", jax_make_server("127.0.0.1", 0,
                                    state=JaxState(quantize=None))),
            ("port", make_server("127.0.0.1", 0,
                                 state=ServeState(device="cpu")))):
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        threads.append((srv, t))
        out[name] = f"http://127.0.0.1:{srv.server_address[1]}"
        out[name + "_state"] = srv.state
    yield out
    for srv, t in threads:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("hw", [(64, 64), (37, 29)], ids=["64", "37x29"])
def test_keras_backend_matches_the_jax_server(servers, hw):
    """The default (``auto``) and ``keras`` backends: 200, the contract's
    keys, ``"backend": "keras"``, the upload's size (padded to 4, cropped
    back), pixels within 1 count of the JAX server's on ≥ 99.5%; the label
    and a condition image are ignored by the single-input model."""
    img = _image(*hw, seed=hw[1])
    png = imageio.encode_png(img)
    outs = {}
    for name in ("jax", "port"):
        for query, fields in (
                ("model=cgan&graphs=false", [("file", "x.png", png)]),
                ("model=cgan&cgan_backend=keras&graphs=false",
                 [("file", "x.png", png), ("label", None, b"5"),
                  ("cond_file", "c.png", png)])):
            status, payload = _post(servers[name], query, _form(fields))
            assert status == 200, (name, payload)
            assert set(payload) == {"denoised_image_base64",
                                    "noise_graph_base64", "backend"}
            assert payload["backend"] == "keras"
            out = _decoded(payload)
            assert out.shape == img.shape
            if name in outs:
                assert np.array_equal(out, outs[name])
            outs[name] = out
    d = np.abs(outs["port"].astype(int) - outs["jax"].astype(int))
    assert d.max() <= 1 and np.mean(d == 0) >= 0.995, (d.max(),
                                                       np.mean(d == 0))
    assert servers["port_state"].last_compute_backend() in ("float", "n/a")


@pytest.mark.parametrize("fields, status", [
    ([("label", None, b"3")], 200),
    ([], 400),
    ([("label", None, b"three")], 400),
    ([("cond_file", "c.png", None)], 500),
    ([("label", None, b"3"), ("cond_file", "c.png", None)], 500),
], ids=["label", "no_label", "bad_label", "cond_file", "label_and_cond"])
def test_torch_backend_matches_the_jax_server(servers, fields, status):
    """``cgan_backend=torch``: a label answers a 64×64 image from a fresh
    latent, cropped at the upload's padding offsets to its size, ``"backend":
    "torch"``; no label and no condition is a 400 (and so is a label that
    is not an integer), a condition image a 500 — on both servers."""
    img = _image(37, 29, seed=1)
    png = imageio.encode_png(img)
    body = _form([("file", "x.png", png)]
                 + [(n, f, png if d is None else d) for n, f, d in fields])
    for name in ("jax", "port"):
        got, payload = _post(servers[name],
                             "model=cgan&cgan_backend=torch&graphs=false",
                             body)
        assert got == status, (name, payload)
        if status == 200:
            assert payload["backend"] == "torch"
            assert _decoded(payload).shape == img.shape
        else:
            assert set(payload) == {"detail"}


@pytest.mark.parametrize("label", [10, -1])
def test_torch_backend_refuses_a_label_outside_the_table(servers, label):
    """A label outside 0..9 is a 400 on the port, checked on the host
    before any tensor is made (on the card the embedding's index would trip
    a device-side assert that fails every later request).  The JAX server
    answers 200 there (``jnp.take`` fills: a NaN row for 10, row 9 for
    -1), a difference kept by design.  The port serves on afterwards: a
    torch-backend label, the Keras backend and denoise all answer 200."""
    png = imageio.encode_png(_image(37, 29, seed=4))
    query = "model=cgan&cgan_backend=torch&graphs=false"
    body = _form([("file", "x.png", png),
                  ("label", None, str(label).encode())])
    assert _post(servers["jax"], query, body)[0] == 200
    got, payload = _post(servers["port"], query, body)
    assert got == 400 and payload == {"detail": "label must be in 0..9"}
    for q, fields in ((query, [("label", None, b"9")]),
                      ("model=cgan&graphs=false", []),
                      ("model=denoise&graphs=false", [])):
        status, payload = _post(servers["port"], q,
                                _form([("file", "x.png", png)] + fields))
        assert status == 200, (q, payload)


def test_info_and_healthz_list_the_five_families(servers):
    st = servers["port_state"]
    jst = servers["jax_state"]
    assert st.info() == jst.info()
    assert list(st.info()["models"]) == ["denoise", "cgan", "srgan",
                                         "esrgan", "dncnn"]
    assert "cgan" in st.healthz()["weights_loaded"]


def test_keras_cgan_missing_falls_back_to_torch(tmp_path):
    """Without the .keras file the torch generator answers ``auto`` (a
    label is then required), and ``cgan_backend=keras`` is a 500, as on the
    JAX server."""
    st = ServeState(weights_dir=str(tmp_path), device="cpu")
    jst = JaxState(weights_dir=str(tmp_path), quantize=None)
    png = imageio.encode_png(_image(16, 20, seed=2))
    assert st.keras_cgan is None and st.info() == jst.info()
    for backend, label, status in (("auto", None, 400), ("auto", 2, 200),
                                   ("keras", 2, 500)):
        for state in (st, jst):
            try:
                r = state.enhance("cgan", png, cgan_backend=backend,
                                  label=label, include_graph=False)
                got = 200
                assert r["backend"] == "torch"
            except Exception as e:
                got = e.status
            assert got == status, (type(state).__module__, backend, label)
    assert st.healthz()["weights_loaded"] == []


def test_int8_serves_the_generic_rung_on_the_rewritten_layers():
    """``quantize="int8"``: the Keras cGAN on ``int8-generic`` (the rung key
    ``cgan:keras``), its gate within 1 dB of the JAX server's 45.5 dB, the
    request labelled int8; the replay quantizes the three 4×4 stride-2
    layers."""
    st = ServeState(device="cpu", quantize="int8")
    png = imageio.encode_png(_image(40, 36, seed=3))
    r = st.enhance("cgan", png, include_graph=False)
    assert r["backend"] == "keras" and st.last_compute_backend() == "int8"
    assert st.int8_rung == {KERAS: "int8-generic"}
    assert abs(st.int8_gate_db[KERAS] - 45.5) < 1.0
    entries = st._qapply[KERAS].entries
    assert [tuple(e[0].shape) if e else None for e in entries] == [
        None, (128, 64, 4, 4), (128, 128, 4, 4), (128, 64, 4, 4), None]
    assert st.healthz()["int8_rungs"] == {KERAS: "int8-generic"}


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_tiled_request_equals_the_untiled_one(quantize):
    """A 150×52 upload over a 64-row threshold tiles both axes (halo 32,
    tiles at multiples of 4): float within 1 count of the untiled forward,
    int8 bit-equal."""
    img = _image(150, 70, seed=4)
    tiled = ServeState(device="cpu", quantize=quantize,
                       tile_threshold_rows=64)
    full = ServeState(device="cpu", quantize=quantize)
    a = tiled.denoise_image(img, "cgan")
    assert tiled.last_compute_backend().endswith("+tiled")
    b = full.denoise_image(img, "cgan")
    assert a.shape == b.shape == img.shape
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= (1 if quantize is None else 0)


@pytest.fixture(scope="module")
def gains(servers):
    st_q = ServeState(device="cpu", quantize="int8")
    return {"float": quality.fixture_gain_db(servers["port_state"], "cgan"),
            "int8": quality.fixture_gain_db(st_q, "cgan"),
            "jax": jquality.fixture_gain_db(servers["jax_state"], "cgan")}


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_shipped_cgan_clears_its_floor(gains, mode):
    """The fixture through the Keras backend (label 5), above the 1.0 dB
    floor; float within 0.01 dB of the JAX server's 2.370 dB, int8 within
    0.05 dB of float."""
    floor = quality.recorded_gate_floor(WEIGHTS, "cgan", default=FLOOR)
    assert floor == FLOOR and quality.recorded_margin(WEIGHTS, "cgan") is None
    assert gains[mode] > floor
    assert abs(gains["float"] - gains["jax"]) < 0.01
    assert abs(gains[mode] - gains["float"]) < 0.05


def test_degraded_cgan_fails_its_floor(tmp_path, shipped):
    """Every array of the shipped generator perturbed by N(0, 0.3·std),
    written through the JAX exporter: the fixture gain falls below 1.0 dB."""
    jm, p, s, _ = shipped
    rng = np.random.default_rng(0)

    def degrade(x):
        x = np.asarray(x)
        return x + rng.normal(0, 0.3 * float(np.std(x) + 1e-6),
                              x.shape).astype(x.dtype)

    export_keras_cgan(jax.tree.map(degrade, p), s,
                      str(tmp_path / "cgan_epoch_500.keras"))
    st = ServeState(weights_dir=str(tmp_path), device="cpu")
    assert st.healthz()["weights_loaded"] == ["cgan"]
    assert quality.fixture_gain_db(st, "cgan") < FLOOR
