"""The port's serving quality gate (``serve/quality.py``) against the JAX
package's, on the CPU.

* The fixture (``structured_clean``, ``noisy_fixture``) and ``psnr_u8``
  equal the JAX functions bit for bit; ``recorded_margin`` and
  ``recorded_gate_floor`` agree with JAX's on a good, a missing, a
  malformed and a non-numeric ``meta.json``.
* The shipped ``weights/denoise`` clear 70% of the 7.71 dB recorded in
  their ``meta.json`` through the port's float and int8 servers, and the
  port's float gain is within 0.05 dB of the JAX server's.
* The control: a copy of the shipped weights with every array perturbed as
  ``tests/test_serve.py::test_degraded_checkpoint_fails_the_margin_gate``
  perturbs them, the original ``meta.json`` kept, fails the floor.
"""

import base64
import json
import shutil

import numpy as np
import pytest

from celebrity_image_denoiser_tpu.serve import quality as jquality
from celebrity_image_denoiser_tpu.serve.handlers import ServeState as JaxState
from celebrity_image_denoiser_tpu_torch.core.config import default_weights_dir
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.serve import quality
from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState
from torch_port_threads import _one_torch_thread  # noqa: F401

WEIGHTS = default_weights_dir()


@pytest.mark.parametrize("size", [16, 64, 128, 256])
def test_structured_clean_equals_jax(size):
    a, b = quality.structured_clean(size), jquality.structured_clean(size)
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size, seed", [(64, 1), (256, 2), (40, 7)])
def test_noisy_fixture_equals_jax(size, seed):
    for a, b in zip(quality.noisy_fixture(size, seed),
                    jquality.noisy_fixture(size, seed)):
        np.testing.assert_array_equal(a, b)


def test_psnr_u8_equals_jax():
    clean, noisy = quality.noisy_fixture(64, 1)
    assert quality.psnr_u8(noisy, clean) == jquality.psnr_u8(noisy, clean)
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (9, 7, 3), np.uint8)
    b = rng.integers(0, 256, (9, 7, 3), np.uint8)
    assert quality.psnr_u8(a, b) == jquality.psnr_u8(a, b)
    assert quality.GATE_FRACTION == jquality.GATE_FRACTION


_META = {
    "good": '{"fixture_gain_db": 7.71, "battery_gain_db": 2.5}',
    "int": '{"fixture_gain_db": 3}',
    "missing_key": '{"gain_db": 15.1}',
    "malformed": '{"fixture_gain_db": 7.7',
    "not_an_object": "[7.71]",
    "string": '{"fixture_gain_db": "7.71"}',
    "bool": '{"fixture_gain_db": true}',
    "null": '{"fixture_gain_db": null}',
    "no_file": None,
}


@pytest.mark.parametrize("case", list(_META))
@pytest.mark.parametrize("key", ["fixture_gain_db", "battery_gain_db"])
def test_recorded_margin_and_floor_agree_with_jax(tmp_path, case, key):
    (tmp_path / "denoise").mkdir()
    if _META[case] is not None:
        (tmp_path / "denoise" / "meta.json").write_text(_META[case])
    wd = str(tmp_path)
    got = quality.recorded_margin(wd, "denoise", key=key)
    assert got == jquality.recorded_margin(wd, "denoise", key=key)
    assert got is None or type(got) is float
    for default in (0.0, 1.0, 9.0):
        assert quality.recorded_gate_floor(wd, "denoise", default, key=key) \
            == jquality.recorded_gate_floor(wd, "denoise", default, key=key)


def test_fixture_gain_waits_for_the_other_families():
    """No family waits any more: cgan's fixture runs through its Keras
    backend with label 5, as the JAX fixture asks (the gains are measured in
    ``tests/test_torch_port_cgan.py``; srgan, esrgan and dncnn in
    ``tests/test_torch_port_families.py``)."""
    calls = []

    class Recorder:
        def enhance(self, model, png, ctype, **kw):
            calls.append((model, kw))
            img = imageio.decode_png(png)
            return {"denoised_image_base64":
                    base64.b64encode(imageio.encode_png(img)).decode()}

    for model in ("cgan", "denoise"):
        assert quality.fixture_gain_db(Recorder(), model) == 0.0
    assert calls == [("cgan", {"include_graph": False,
                               "cgan_backend": "keras", "label": 5}),
                     ("denoise", {"include_graph": False})]


@pytest.fixture(scope="module")
def port_gains():
    return {q: quality.fixture_gain_db(ServeState(device="cpu", quantize=q),
                                       "denoise")
            for q in (None, "int8")}


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_shipped_weights_clear_the_recorded_floor(port_gains, quantize):
    assert quality.recorded_margin(WEIGHTS, "denoise") is not None, (
        "weights/denoise/meta.json must record fixture_gain_db")
    floor = quality.recorded_gate_floor(WEIGHTS, "denoise", default=1.0)
    assert floor == pytest.approx(0.7 * 7.71)
    assert port_gains[quantize] >= floor, (port_gains[quantize], floor)


def test_float_gain_matches_the_jax_server(port_gains):
    jax_gain = jquality.fixture_gain_db(JaxState(quantize=None), "denoise")
    assert abs(port_gains[None] - jax_gain) <= 0.05, (port_gains[None],
                                                      jax_gain)


@pytest.fixture(scope="module")
def degraded_weights(tmp_path_factory):
    """weights/denoise with every array perturbed by N(0, 0.15·std), drawn
    in the JAX tree's order from seed 0 (test_serve.py:470-476); the
    original meta.json is kept, as a real regression would not rewrite its
    own acceptance record."""
    from celebrity_image_denoiser_tpu.ckpt import (
        load_checkpoint,
        save_checkpoint,
    )
    import jax

    src = f"{WEIGHTS}/denoise"
    sections, meta = load_checkpoint(src)
    rng = np.random.default_rng(0)

    def degrade(x):
        x = np.asarray(x)
        return x + rng.normal(0, 0.15 * float(np.std(x) + 1e-6),
                              x.shape).astype(x.dtype)

    sections = dict(sections)
    sections["generator"] = jax.tree.map(degrade, sections["generator"])
    root = tmp_path_factory.mktemp("degraded") / "weights"
    save_checkpoint(str(root / "denoise"), sections, meta=meta)
    shutil.copy(f"{src}/meta.json", root / "denoise" / "meta.json")
    return str(root)


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_degraded_checkpoint_fails_the_floor(degraded_weights, quantize):
    st = ServeState(weights_dir=degraded_weights, device="cpu",
                    quantize=quantize)
    assert st.healthz()["weights_loaded"] == ["denoise"]
    with open(f"{degraded_weights}/denoise/meta.json") as f:
        assert json.load(f)["fixture_gain_db"] == 7.71
    gain = quality.fixture_gain_db(st, "denoise")
    floor = quality.recorded_gate_floor(degraded_weights, "denoise",
                                        default=1.0)
    assert gain < floor, (gain, floor)
