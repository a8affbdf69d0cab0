"""The request path's uint8 host side (``ServeState.denoise_image``) on the
CPU.

A request's image goes to the device as uint8 and is mapped there through
its family's 256-entry table (``_to_domain``); the served image is the
forward's uint8 output itself.  Held here:

* the witness: the float finish the path no longer runs (u8 → /255 →
  clip(0, 1) → ×255 → u8) is the identity on all 256 values; each
  family's table gathered over 0..255 equals ``_served_input``'s float32
  bit for bit; the input the forward receives equals
  ``_served_input(...)[0]`` bit for bit at sizes the tanh families pad;
* the equivalence: ``denoise_image`` equals the pipeline it replaced
  (``_served_input`` → a float upload → the forward → ``_to_u8`` → the
  float finish → ``_pil_crop``), kept below as ``_float_pipeline``, byte
  for byte: every family (cgan: the Keras generator on the shipped
  ``weights/cgan_epoch_500.keras``) at a size that is a multiple of 4 and
  one that is not (esrgan's shifted, zero-filled crop), on the kernel and
  the plain route, micro-batched, and tiled (restormer, never tiled: the
  same refusal on both paths).
"""

import functools
import threading

import numpy as np
import pytest
import torch

from celebrity_image_denoiser_tpu_torch.core.config import MODEL_CFG
from celebrity_image_denoiser_tpu_torch.serve.handlers import (
    _CROPPED,
    KERAS,
    EnhanceError,
    ServeState,
    _pil_crop,
)
from torch_port_threads import _one_torch_thread  # noqa: F401

FAMILIES = tuple(MODEL_CFG)
# (h, w): a multiple of 4, and one the tanh families pad (esrgan: a box
# shifted by its padding offsets, zeros past the border)
SIZES = ((24, 16), (22, 17))
TIMEOUT = 120  # seconds for any one thread
N_BATCH = 3


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _float_pipeline(st, image, model, plain=False):
    """The request path as it ran before the map moved to the device: the
    host's float input uploaded, the forward, then the host's float
    finish and the crop."""
    xin, _, box = st._served_input(model, image)
    which = KERAS if model == "cgan" else model
    y = st._forward(which, torch.from_numpy(xin).to(st.device), plain=plain)
    y01 = y[0].astype(np.float32) / 255.0
    y_u8 = (np.clip(y01, 0, 1) * 255).astype(np.uint8)
    return _pil_crop(y_u8, box) if model in _CROPPED else y_u8


def _on_threads(fn, args):
    """``fn(arg)`` for each arg, each on a thread of its own, started
    together; the results in order."""
    out = [None] * len(args)
    go = threading.Barrier(len(args))

    def run(i):
        go.wait(TIMEOUT)
        out[i] = fn(args[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def server():
    st = ServeState(device="cpu")
    assert st.keras_cgan is not None  # the shipped .keras serves cgan
    return st


@pytest.fixture(scope="module")
def batching_server():
    # a full batch dispatches at once; the window is never reached
    return ServeState(device="cpu", microbatch_window_ms=600_000.0,
                      microbatch_max=N_BATCH)


@pytest.fixture(scope="module")
def tiled_server():
    return ServeState(device="cpu", tile_threshold_rows=16)


def test_the_float_finish_is_the_identity_on_uint8():
    u8 = np.arange(256, dtype=np.uint8)
    back = (np.clip(u8.astype(np.float32) / 255.0, 0, 1) * 255).astype(
        np.uint8)
    np.testing.assert_array_equal(back, u8)


@pytest.mark.parametrize("model", FAMILIES)
def test_the_table_gathered_over_every_value_is_served_inputs_bits(
        server, model):
    every = np.arange(256, dtype=np.uint8).reshape(16, 16, 1)
    image = np.repeat(every, 3, axis=2)  # 16 x 16: no family pads it
    want = server._served_input(model, image)[0]
    assert want.dtype == np.float32 and want.shape == (1, 16, 16, 3)
    table = server._tables[model]
    assert table.device == server.device and table.dtype == torch.float32
    got = table.index_select(0, torch.arange(256, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want[0, :, :, 0].reshape(256).view(
                                      np.uint32))


@pytest.mark.parametrize("hw", [(21, 18), (23, 30), (16, 16)])
@pytest.mark.parametrize("model", FAMILIES)
def test_the_forward_receives_served_inputs_bits(server, monkeypatch, model,
                                                 hw):
    seen = []
    forward = server._forward

    def spy(name, x, plain=False):
        seen.append(x)
        return forward(name, x, plain=plain)

    monkeypatch.setattr(server, "_forward", spy)
    image = _image(*hw, seed=3)
    server.denoise_image(image, model)
    (x,) = seen
    want = server._served_input(model, image)[0]
    assert x.device == server.device and x.dtype == torch.float32
    assert x.is_contiguous() and tuple(x.shape) == want.shape
    np.testing.assert_array_equal(x.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _check_served(y, want):
    assert y.dtype == np.uint8 and y.ndim == 3 and y.shape[2] == 3
    assert y.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("route", ["kernel", "plain", "microbatched",
                                   "tiled"])
@pytest.mark.parametrize("hw", SIZES, ids=["x4", "odd"])
@pytest.mark.parametrize("model", FAMILIES)
def test_denoise_image_equals_the_float_pipeline(
        server, batching_server, tiled_server, model, hw, route):
    h, w = hw
    if route == "microbatched":
        st = batching_server
        key = str((KERAS if model == "cgan" else model,
                   (*st._input_shape(model, h, w), 3)))
        before = st.batchers.stats().get(key, {"batches": 0, "requests": 0})
        images = [_image(h, w, seed=s) for s in range(N_BATCH)]
        got = _on_threads(lambda im: st.denoise_image(im, model), images)
        want = _on_threads(lambda im: _float_pipeline(st, im, model),
                           images)
        for y, y_ref in zip(got, want):
            _check_served(y, y_ref)
        # each side's requests were served as one coalesced batch
        assert st.batchers.stats()[key] == {
            "batches": before["batches"] + 2,
            "requests": before["requests"] + 2 * N_BATCH}
        return
    st = tiled_server if route == "tiled" else server
    plain = route == "plain"
    image = _image(h, w, seed=1)
    if route == "tiled":  # taller than a tile: the tiler serves it
        image = np.concatenate([image, _image(h, w, seed=2)])
        assert st._big_route((1, *st._input_shape(model, 2 * h, w), 3))[0] \
            == "tiled"
        if not MODEL_CFG[model].get("tiles", True):
            # restormer: refused, not tiled, on both paths alike
            for serve in (st.denoise_image, functools.partial(
                    _float_pipeline, st)):
                with pytest.raises(EnhanceError, match="too large"):
                    serve(image, model)
            return
    y = st.denoise_image(image, model, plain=plain)
    _check_served(y, _float_pipeline(st, image, model, plain=plain))
    if model == "srgan":  # 4x the padded input, not cropped
        hh, ww = st._input_shape(model, *image.shape[:2])
        assert y.shape == (4 * hh, 4 * ww, 3)
    else:
        assert y.shape == image.shape
