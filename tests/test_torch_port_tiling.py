"""The port's exact single-device tiling (``parallel/tiling.py``) and the
server's big-input routing, against the JAX package, on the CPU.

* ``tiled_apply_single_device`` against the JAX one on the same weights
  (carried across by ``ckpt/convert.py``): height (1×200×48), width
  (1×48×200) and both nested (1×200×200), tile 64, halo 32, within 1e-5
  (f32 on the CPU: XLA's convs against oneDNN's); and against the port's
  own untiled forward within 1e-6, as ``tests/test_parallel.py`` holds the
  JAX tiler.
* The tiles the tiler runs and their shapes; its validation errors.
* The server with ``tile_threshold_rows=64`` on the shipped weights: tall,
  wide and both-axes inputs are served tiled (labelled ``float+tiled``),
  within 1 count of the port untiled and of the tiled JAX server (≥ 99.5%
  equal, as ``test_torch_port_serve.py`` holds the untiled servers); int8
  tiled against int8 untiled; a kernel error inside a tile reaches the
  caller (a 500 through ``enhance``), with no fallback.
"""

import base64

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu.parallel import tiling as jtiling
from celebrity_image_denoiser_tpu.serve.handlers import ServeState as JaxState
from celebrity_image_denoiser_tpu_torch.ckpt.convert import (
    state_dict_to_jax_params,
)
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8 as k5
from celebrity_image_denoiser_tpu_torch.ops.cuda import double_conv
from celebrity_image_denoiser_tpu_torch.parallel.tiling import (
    tiled_apply_single_device,
)
from celebrity_image_denoiser_tpu_torch.serve.handlers import (
    EnhanceError,
    ServeState,
)

THRESHOLD = 64
# (H, W) before padding to 4: over the threshold on one axis or both
BIG = {"tall": (99, 37), "wide": (37, 99), "both": (99, 99)}
AXES = {"height": ((1, 200, 48, 3), (1,)), "width": ((1, 48, 200, 3), (2,)),
        "both": ((1, 200, 200, 3), (2, 1))}


@pytest.fixture(scope="module")
def weights():
    """A random init made by the port, and the same weights for JAX."""
    port = DenoiseGenerator(generator=torch.Generator().manual_seed(0)).eval()
    params, _ = state_dict_to_jax_params(port.state_dict())
    return port, params


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _port_tiler(model, axes, **kw):
    fn = None
    for axis in axes:
        fn = tiled_apply_single_device(model, tile_h=64, halo=32, axis=axis,
                                       apply_fn=fn, **kw)
    return fn


@pytest.mark.parametrize("case", list(AXES))
def test_tiler_matches_jax(weights, case):
    port, params = weights
    shape, axes = AXES[case]
    x = _x(shape)
    jm = jax_models.DenoiseGenerator()
    jfn = None
    for axis in axes:
        inner = jfn
        jfn = jtiling.tiled_apply_single_device(
            jm, params, {}, tile_h=64, halo=32, axis=axis,
            apply_fn=None if inner is None else
            (lambda p, s, t, _f=inner: _f(t)))
    y_jax = np.asarray(jfn(jnp.asarray(x)))
    with torch.no_grad():
        y = _port_tiler(port, axes)(torch.from_numpy(x)).numpy()
    assert y.shape == y_jax.shape == shape
    np.testing.assert_allclose(y, y_jax, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", list(AXES))
def test_tiled_matches_untiled(weights, case):
    """Exact: edge tiles end at the true border, interior tiles carry 32
    rows of true context, more than the U-Net's receptive field."""
    port, _ = weights
    shape, axes = AXES[case]
    x = torch.from_numpy(_x(shape, seed=1))
    with torch.no_grad():
        y_full = port(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = _port_tiler(port, axes)(x)
    np.testing.assert_allclose(y.numpy(), y_full.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_a_halo_too_small_is_not_exact(weights):
    """The control: with a 4-pixel halo the seams show."""
    port, _ = weights
    x = torch.from_numpy(_x((1, 200, 48, 3), seed=2))
    with torch.no_grad():
        y_full = port(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = tiled_apply_single_device(port, tile_h=64, halo=4)(x)
    assert (y - y_full).abs().max().item() > 1e-4


def _tiles_seen(extent, tile_h, halo, axis=1):
    """The (start, length) of every tile the tiler hands its forward."""
    seen = []

    def fwd(t):
        seen.append(t.shape[axis])
        assert t.is_contiguous()
        return t

    shape = [1, 8, 8, 3]
    shape[axis] = extent
    x = torch.arange(float(np.prod(shape))).reshape(shape)
    y = tiled_apply_single_device(tile_h=tile_h, halo=halo, apply_fn=fwd,
                                  axis=axis)(x)
    assert torch.equal(y, x)  # the crops put every row back in its place
    return seen


@pytest.mark.parametrize("extent, tile_h, expect", [
    (256, 64, [96, 128, 128, 96]),
    (200, 64, [96, 128, 104, 40]),  # the last tile is shorter than the halo
    (4100, 2048, [2080, 2084, 36]),  # 4097 rows padded, threshold 2048
    (3072, 2048, [2080, 1056]),
    (64, 64, [64]),
])
@pytest.mark.parametrize("axis", [1, 2])
def test_tile_shapes(extent, tile_h, expect, axis):
    """Each tile is [max(start-32, 0), min(stop+32, h)); at most three
    distinct shapes, or four when the last tile is shorter than the halo
    (the one before it then ends at the border too)."""
    seen = _tiles_seen(extent, tile_h, 32, axis)
    assert seen == expect
    last = extent - (len(seen) - 1) * tile_h
    assert len(set(seen)) <= (3 if last >= 32 or len(seen) < 3 else 4)


@pytest.mark.parametrize("kw, x_shape, match", [
    ({"halo": 30}, (1, 64, 8, 3), "divisible by 4"),
    ({"tile_h": 62}, (1, 64, 8, 3), "divisible by 4"),
    ({"axis": 3}, (1, 64, 8, 3), "axis must be 1"),
    ({"axis": 0}, (1, 64, 8, 3), "axis must be 1"),
    ({}, (1, 66, 8, 3), "must be divisible by 4"),
    ({"axis": 2}, (1, 8, 66, 3), "must be divisible by 4"),
    ({"tile_h": 0}, (1, 64, 8, 3), "positive"),
], ids=["halo", "tile", "axis3", "axis0", "height", "width", "tile0"])
def test_tiler_validation(kw, x_shape, match):
    args = {"tile_h": 64, "halo": 32, "apply_fn": lambda t: t, **kw}
    with pytest.raises(ValueError, match=match):
        tiled_apply_single_device(**args)(torch.zeros(x_shape))


def test_tiler_needs_a_forward():
    with pytest.raises(ValueError, match="model or an apply_fn"):
        tiled_apply_single_device()


def test_scale_crops_on_the_output_side():
    """A ×2 forward: the crop is scaled, the halo stays in input rows."""
    def up2(t):
        return t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    x = torch.arange(1 * 40 * 8 * 1, dtype=torch.float32).reshape(1, 40, 8, 1)
    y = tiled_apply_single_device(tile_h=16, halo=8, scale=2,
                                  apply_fn=up2)(x)
    assert torch.equal(y, up2(x))


# ---------------------------------------------------------------------------
# the server
def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([120 + 80 * np.sin(xx / 5.0), 100 + 60 * np.cos(yy / 7.0),
                     90 + 50 * np.sin((xx + yy) / 9.0)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(
        np.uint8)


def _served(st, img):
    r = st.enhance("denoise", imageio.encode_png(img), "image/png",
                   include_graph=False)
    return imageio.decode_png(base64.b64decode(r["denoised_image_base64"]))


@pytest.fixture(scope="module")
def servers():
    return {"tiled": ServeState(device="cpu", tile_threshold_rows=THRESHOLD),
            "untiled": ServeState(device="cpu"),
            "jax": JaxState(quantize=None, tile_threshold_rows=THRESHOLD)}


def _diff(a, b):
    assert a.shape == b.shape
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


@pytest.mark.parametrize("case", list(BIG))
def test_big_input_is_served_tiled(servers, case):
    img = _image(*BIG[case], seed=len(case))
    out = _served(servers["tiled"], img)
    assert servers["tiled"].last_compute_backend() == "float+tiled"
    assert out.shape == img.shape
    d = _diff(out, _served(servers["untiled"], img))
    assert servers["untiled"].last_compute_backend() == "float"
    assert d.max() <= 1


@pytest.mark.parametrize("case", list(BIG))
def test_tiled_server_matches_tiled_jax_server(servers, case):
    img = _image(*BIG[case], seed=10 + len(case))
    out = _served(servers["tiled"], img)
    ref = _served(servers["jax"], img)
    hh, ww = (-(-e // 4) * 4 for e in BIG[case])
    assert ("tiled", "denoise", hh > THRESHOLD, ww > THRESHOLD) in \
        servers["jax"]._fns
    d = _diff(out, ref)
    assert d.max() <= 1, d.max()
    assert np.mean(d == 0) >= 0.995, np.mean(d == 0)


def test_tiled_labels_are_counted(servers):
    st = ServeState(device="cpu", tile_threshold_rows=THRESHOLD)
    _served(st, _image(20, 20, seed=0))
    _served(st, _image(*BIG["both"], seed=0))
    assert st.stats.snapshot()["compute_backends"] == {"float": 1,
                                                       "float+tiled": 1}


@pytest.mark.parametrize("case", list(BIG))
def test_big_input_never_runs_one_untiled_forward(servers, case):
    """Each forward a big request makes is one tile: no wider than the
    threshold plus a halo on each side, one forward per tile."""
    st = servers["tiled"]
    shapes = []
    hook = st.models["denoise"].register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape[2:])))
    try:
        _served(st, _image(*BIG[case], seed=30 + len(case)))
    finally:
        hook.remove()
    hh, ww = (-(-e // 4) * 4 for e in BIG[case])
    tiles = [-(-e // THRESHOLD) if e > THRESHOLD else 1 for e in (hh, ww)]
    assert len(shapes) == tiles[0] * tiles[1], shapes
    assert max(max(s) for s in shapes) <= THRESHOLD + 2 * 32, shapes


@pytest.fixture(scope="module")
def int8_servers():
    return (ServeState(device="cpu", quantize="int8",
                       tile_threshold_rows=THRESHOLD),
            ServeState(device="cpu", quantize="int8"))


@pytest.mark.parametrize("case", list(BIG))
def test_int8_tiled_matches_int8_untiled(int8_servers, case):
    tiled, untiled = int8_servers
    img = _image(*BIG[case], seed=20 + len(case))
    out = _served(tiled, img)
    assert tiled.last_compute_backend() == "int8+tiled"
    assert tiled.int8_rung["denoise"] == "int8-s8skip"
    d = _diff(out, _served(untiled, img))
    assert untiled.last_compute_backend() == "int8"
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("quantize, module, name", [
    (None, double_conv, "double_conv3x3_relu"),
    ("int8", k5, "conv3x3_s8"),
], ids=["float", "int8"])
def test_kernel_errors_inside_a_tile_are_not_caught(monkeypatch, quantize,
                                                    module, name):
    """A kernel that fails inside a tile reaches the caller; through
    ``enhance`` it is a 500, never a response from another route."""
    st = ServeState(device="cpu", quantize=quantize,
                    tile_threshold_rows=THRESHOLD)

    def launch_failed(*a, **k):
        raise RuntimeError(f"{name}: CUDA error 98 (simulated)")

    monkeypatch.setattr(module, name, launch_failed)
    img = _image(*BIG["both"], seed=4)
    with pytest.raises(RuntimeError, match="simulated"):
        st.denoise_image(img)
    with pytest.raises(EnhanceError) as e:
        st.enhance("denoise", imageio.encode_png(img), "image/png",
                   include_graph=False)
    assert e.value.status == 500
    assert st.stats.snapshot()["errors"] == {"denoise:500": 1}
