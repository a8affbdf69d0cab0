"""K2's float32 body for Cout <= 4 (``csrc/conv3x3_bias_relu.cu``,
``conv3x3_f32_narrow_kernel``) compiled by g++ under the CUDA emulation of
``tests/test_torch_port_kernels.py`` and held against the plain version.

The body walks (tile, 64-channel chunk) items of 8 x 32-pixel tiles through
a ring of 16-byte copies (4-byte ones where Cin is not a multiple of 4 or x
is not 16-byte aligned), with Cout a template parameter (1-4, never padded);
16 lanes share a run of 16 pixels, one group of 4 channels each, and sum
their partial sums by shuffles.
Covered here: every Cout against Cin 3, 10, 16, 64 and 67 (the scalar and
the vector copies, one chunk and several, a ragged last chunk); ragged H and
W on every tile edge; an image smaller than a tile in both dimensions, one
row, one column and one pixel; batch 2; more tiles than the emulated card's
two blocks; ReLU on and off; a zero bias; unaligned x and y; two launches
bit-equal; and a control build that leaves the ring's last chunk out (``-DCID_NARROW_DROP_LAST_CHUNK``), which must miss the same
check.  The body's output is also held against the JAX package's Pallas
kernel in interpret mode, and the plain version at each narrow Cout.  Only
the two conv sources are built, so this file runs beside the heavier
``test_torch_port_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from celebrity_image_denoiser_tpu.ops.pallas import conv_fused
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3
from test_torch_port_kernels import _EMU_TOL, _build_emulated, _rel_err
from torch_port_threads import _one_torch_thread  # noqa: F401

_SOURCES = ("conv3x3_bias_relu.cu", "double_conv3x3_relu.cu")
_TOL = _EMU_TOL[torch.float32]


@pytest.fixture(scope="module")
def narrow_lib(tmp_path_factory):
    return _build_emulated(tmp_path_factory.mktemp("narrow_emulation"),
                           only=_SOURCES)


@pytest.fixture(scope="module")
def narrow_lib_dropped(tmp_path_factory):
    """The same sources with the ring's last chunk left out of the sums."""
    return _build_emulated(tmp_path_factory.mktemp("narrow_dropped"),
                           ("-DCID_NARROW_DROP_LAST_CHUNK",), _SOURCES)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _inputs(seed, n, h, w, cin, cout, zero_bias=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, cin), np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), np.float32)
                         * np.float32((9 * cin) ** -0.5))
    b = (torch.zeros(cout) if zero_bias else
         torch.from_numpy(rng.standard_normal(cout, np.float32)))
    return x, k, b


def _launch(lib, x, k, b, relu, y=None):
    """The narrow body through ``cid_conv3x3_bias_relu`` (f32, one input);
    ``y`` may be a view the caller made."""
    n, h, w, cin = x.shape
    cout = k.shape[3]
    if y is None:
        y = torch.full((n, h, w, cout), float("nan"))
    rc = lib.cid_conv3x3_bias_relu(
        x.data_ptr(), None, k.data_ptr(), b.data_ptr(), y.data_ptr(), n, h,
        w, cin, 0, cout, int(relu), 0, 0, 0, 0, None)
    return rc, y


def _check(lib, x, k, b, relu):
    rc, y = _launch(lib, x, k, b, relu)
    ref = conv3x3.conv3x3_bias_relu_plain(x, k, b, relu=relu)
    assert rc == 0
    assert torch.isfinite(y).all()
    return y, _rel_err(y, ref)


@pytest.mark.parametrize("cin", [3, 10, 16, 64, 67])
@pytest.mark.parametrize("cout", [1, 2, 3, 4])
def test_narrow_body_emulated_on_cpu(narrow_lib, cout, cin):
    """Each Cout against each Cin at 20 x 40 (3 x 2 tiles of 8 x 32, ragged
    on the bottom and right, over two blocks), ReLU on for odd Cin; and two
    launches bit-equal."""
    x, k, b = _inputs(cout * 100 + cin, 1, 20, 40, cin, cout)
    relu = cin % 2 == 1
    y, err = _check(narrow_lib, x, k, b, relu)
    assert err <= _TOL, err
    _, again = _launch(narrow_lib, x, k, b, relu)
    assert torch.equal(y, again)


@pytest.mark.parametrize("shape, relu, zero_bias", [
    ((1, 5, 20, 64), False, False),    # smaller than a tile both ways
    ((2, 33, 65, 64), True, False),    # batch 2, one row/column past a tile
    ((1, 31, 63, 16), False, True),    # one row/column short of a tile
    ((2, 1, 1, 8), True, False),       # one pixel
    ((1, 97, 130, 64), False, True),   # dncnn's last conv: odd, no bias
    ((3, 40, 200, 12), True, False),   # Cin % 8 == 4: half a chunk is zeros
    ((1, 12, 20, 64), False, False),   # past a tile in H, short of it in W
    ((1, 8, 32, 64), True, False),     # exactly one tile
    ((1, 1, 70, 67), False, False),    # one row, a ragged last chunk
    ((2, 17, 1, 64), True, True),      # one column
], ids=["small", "batch2_past", "short", "pixel", "dncnn_tail", "cin12",
        "tall", "one_tile", "one_row", "one_col"])
def test_narrow_body_shapes_emulated_on_cpu(narrow_lib, shape, relu,
                                            zero_bias):
    n, h, w, cin = shape
    x, k, b = _inputs(sum(shape), n, h, w, cin, 3, zero_bias)
    _, err = _check(narrow_lib, x, k, b, relu)
    assert err <= _TOL, err


def test_narrow_body_unaligned_emulated_on_cpu(narrow_lib):
    """x one float off a 16-byte boundary (the 4-byte copies) and y too (the
    scalar stores): the same values as the aligned launch, bit for bit."""
    x, k, b = _inputs(11, 1, 45, 70, 64, 3)
    y_al, err = _check(narrow_lib, x, k, b, False)
    assert err <= _TOL, err
    xbuf = torch.empty(x.numel() + 1)
    xu = xbuf[1:].view(x.shape)
    xu.copy_(x)
    ybuf = torch.full((y_al.numel() + 1,), float("nan"))
    yu = ybuf[1:].view(y_al.shape)
    rc, _ = _launch(narrow_lib, xu, k, b, False, yu)
    assert rc == 0 and torch.equal(yu, y_al)


def test_narrow_body_refuses_wide_outputs(narrow_lib):
    """The entry takes Cout 1-4 in f32; wider outputs take the TF32 entry."""
    x, k, b = _inputs(12, 1, 8, 8, 16, 5)
    rc, _ = _launch(narrow_lib, x, k, b, False)
    assert rc != 0


@pytest.mark.parametrize("cin", [3, 16, 64])
def test_narrow_dropped_chunk_fails_the_check(narrow_lib, narrow_lib_dropped,
                                              cin):
    """The control: a build whose ring leaves its last chunk out of the sums
    misses the tolerance that the real build holds, at the same inputs."""
    x, k, b = _inputs(13 + cin, 1, 40, 70, cin, 3)
    _, good = _check(narrow_lib, x, k, b, False)
    _, bad = _check(narrow_lib_dropped, x, k, b, False)
    assert good <= _TOL < bad, (good, bad)


def test_narrow_body_matches_pallas(narrow_lib, interpret_pallas):
    """The emulated body against the JAX package's K2 (``conv_fused.py``,
    interpret mode) at the U-Net's last conv, 64 -> 3, no ReLU."""
    x, k, b = _inputs(14, 1, 16, 40, 64, 3)
    ref = conv_fused.conv3x3_bias_relu(jnp.asarray(x.numpy()),
                                       jnp.asarray(k.numpy()),
                                       jnp.asarray(b.numpy()), relu=False,
                                       tile_h=16)
    rc, y = _launch(narrow_lib, x, k, b, False)
    assert rc == 0
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("cout", [1, 2, 4])
def test_narrow_plain_matches_pallas(interpret_pallas, cout):
    """The wrapper's plain version (what a CPU tensor runs) against the JAX
    K2 in interpret mode at the other narrow widths (Cout 3 is
    ``test_conv3x3_matches_pallas[cout3_norelu]``)."""
    x, k, b = _inputs(15 + cout, 1, 16, 8, 64, cout)
    ref = conv_fused.conv3x3_bias_relu(jnp.asarray(x.numpy()),
                                       jnp.asarray(k.numpy()),
                                       jnp.asarray(b.numpy()), relu=True,
                                       tile_h=16)
    got = conv3x3.conv3x3_bias_relu(x, k, b, relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
