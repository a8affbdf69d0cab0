"""Restormer on the port (``models/restormer.py``), its kernels K7
(``csrc/mdta_attention.cu``), K8 (``csrc/dwconv3x3.cu``) and K9
(``csrc/pointwise_gemm.cu``) and its place on the request path, on the
CPU.

Held here:

* the parameter count at the published widths (26,111,668, counted on the
  meta device) and the published parameter names;
* the seeded initialisation equal, bit for bit, to the plain reference's
  (``reference/restormer.py``, which imports nothing of the port), at a
  shrunken width and at the published one;
* the forward against the reference: the kernel and plain routes at a
  shrunken width, and ``ServeState.denoise_image(image, "restormer")`` at
  the published widths at sizes that need padding;
* K7, K8 and K9 compiled by g++ under the CUDA emulation of
  ``test_torch_port_kernels.py`` against their plain versions, at
  Restormer's odd channel counts (hidden 127, 255 and 1021), head sizes 48
  and 96, pixel counts that do not fill a block, and for K9 each GEMM shape
  of the forward, the v slice of qkv read in place, a weight per image and
  rows whose channel mean is large against their spread; K9's one-product
  control build misses its tolerance;
* the spans and the kernel calls of one forward (44 MDTA, 44 GDFN, 6
  resampling steps; K2 8, K7 44, K8 88, K9 178 of which 88 fold a
  LayerNorm, and no LayerNorm pass);
* the planted faults of ``models/restormer_faults.py`` (the temperature left
  out, k's normalisation left out, GELU in its tanh form, one head's
  attention on another head's v, LayerNorm's row scale left out), each
  above the configuration's limit on ``worst_image_mad``, the sound program
  below it;
* the serving contract: built at first use, float only, listed, served.
"""

import base64
import contextlib
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from celebrity_image_denoiser_tpu_torch.core.config import MODEL_CFG
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.models import (
    restormer,
    restormer_faults,
)
from celebrity_image_denoiser_tpu_torch.ops.cuda import (
    channel_attention,
    conv3x3,
    dwconv3x3,
    pointwise_gemm,
)
from celebrity_image_denoiser_tpu_torch.reference import restormer as ref
from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState
from torch_port_threads import _one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "celebrity_image_denoiser_tpu_torch" / "csrc"
CFG = MODEL_CFG["restormer"]
SMALL = {"dim": 8, "num_blocks": (1, 1, 1, 1), "num_refinement_blocks": 1,
         "heads": (1, 2, 4, 8)}
INIT = {"init_seed": CFG["init_seed"],
        "temperature_range": CFG["temperature_range"],
        "output_scale": CFG["output_scale"]}


def _limit() -> float:
    cfg = json.loads((ROOT / "port_bench" / "configs" / "restormer.json")
                     .read_text())
    return cfg["limits"]["worst_image_mad"]["max"]


def _reference(arch=None):
    return ref.seed_parameters(ref.build(arch), INIT["init_seed"],
                               INIT["temperature_range"],
                               INIT["output_scale"])


@pytest.fixture(scope="module")
def server():
    return ServeState(device="cpu")


@pytest.fixture(scope="module")
def published_reference():
    return _reference()


def _served_by_reference(model, image: np.ndarray) -> np.ndarray:
    """The reference's served uint8 for one uint8 (h, w, 3) upload: centred
    zero padding to a multiple of 8, the network, the crop, clip, x 255,
    truncated."""
    h, w = image.shape[:2]
    ph, pw = (-h) % 8, (-w) % 8
    top, left = ph // 2, pw // 2
    x = torch.from_numpy(imageio.to_float01(image)).permute(2, 0, 1)
    x = torch.nn.functional.pad(x, (left, pw - left, top, ph - top))
    y = model(x.unsqueeze(0))[0, :, top:top + h, left:left + w]
    return (torch.clamp(y.permute(1, 2, 0), 0, 1) * 255).to(
        torch.uint8).numpy()


def _image(h, w, seed):
    from port_bench import gen

    return gen.noisy_u8(seed, 1, max(h, w), 0.1, "cpu")[0, :h, :w].numpy()


# ---------------------------------------------------------------------------
# parameters
def test_parameter_count_at_the_published_widths():
    meta = restormer.Restormer(init_seed=None)
    assert all(p.device.type == "meta" for p in meta.parameters())
    assert sum(p.numel() for p in meta.parameters()) == 26_111_668
    assert ref.n_parameters() == 26_111_668


def test_the_parameters_carry_the_published_names():
    got = list(restormer.Restormer(init_seed=None).state_dict())
    assert got == list(ref.build().state_dict())
    for key in ("patch_embed.proj.weight",
                "encoder_level1.0.norm1.body.weight",
                "encoder_level1.0.attn.temperature",
                "encoder_level1.0.attn.qkv_dwconv.weight",
                "latent.7.ffn.project_out.weight", "down3_4.body.0.weight",
                "up2_1.body.0.weight", "reduce_chan_level2.weight",
                "refinement.3.ffn.dwconv.weight", "output.weight"):
        assert key in got, key
    shapes = dict(restormer.Restormer(init_seed=None).named_parameters())
    # the FFN's hidden widths: int(2.66 C)
    assert [tuple(shapes[f"{lvl}.0.ffn.project_out.weight"].shape)[1]
            for lvl in ("encoder_level1", "encoder_level2",
                        "encoder_level3", "latent")] == [127, 255, 510, 1021]


@pytest.mark.parametrize("arch", [SMALL, None], ids=["small", "published"])
def test_the_seeded_initialisation_equals_the_references(arch):
    port = restormer.Restormer(**(arch or {}), **INIT)
    want = _reference(arch).state_dict()
    got = port.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    temps = [v for k, v in got.items() if k.endswith("temperature")]
    lo, hi = CFG["temperature_range"]
    assert all(bool(((t >= lo) & (t <= hi)).all()) for t in temps)
    assert len({float(t.flatten()[0]) for t in temps}) == len(temps)
    assert all(bool((v == 1).all()) for k, v in got.items()
               if k.endswith("body.weight") and v.dim() == 1)


# ---------------------------------------------------------------------------
# the forward
@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_the_small_model_matches_the_reference(route):
    port = restormer.Restormer(**SMALL, **INIT).eval()
    model = _reference(SMALL)
    x = torch.rand((2, 16, 24, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = port(x.permute(0, 3, 1, 2), route=route).permute(0, 2, 3, 1)
    want = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    # the fold of A into the projection and the reduction orders of the
    # GEMMs, the Gram matrix and LayerNorm: float32 roundings, ~1e-7
    assert (y - want).abs().max() < 1e-5
    with pytest.raises(ValueError, match="multiples of 8"):
        with torch.no_grad():
            port(x[:, :12].permute(0, 3, 1, 2))


@pytest.mark.parametrize("hw", [(21, 18), (16, 40), (9, 7)])
def test_denoise_image_matches_the_reference(server, published_reference,
                                             hw):
    image = _image(*hw, seed=2 ** 31 + hw[0])
    got = server.denoise_image(image, "restormer")
    assert got.shape == image.shape and got.dtype == np.uint8
    want = _served_by_reference(published_reference, image)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # the port and the reference differ by float32 roundings (~1e-7 of a
    # value: the fold of A into the projection, the GEMMs' and reductions'
    # orders); a value that close to a count's edge truncates to the
    # neighbouring count
    assert d.max() <= 1 and np.mean(d == 0) >= 0.995, (d.max(),
                                                       np.mean(d == 0))


# ---------------------------------------------------------------------------
# K7, K8 and K9 under the CUDA emulation
def _emulate(d, defines=()):
    """csrc/dwconv3x3.cu, csrc/mdta_attention.cu and csrc/pointwise_gemm.cu
    compiled by g++ under the emulation of ``test_torch_port_kernels.py``
    into ``d``."""
    import shutil

    from test_torch_port_kernels import _MOCK_CUDA_H, _emulated_source

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to emulate the CUDA sources")
    (d / "mock_cuda.h").write_text(_MOCK_CUDA_H)
    srcs = []
    for p in sorted(CSRC.iterdir()):
        if p.suffix == ".cuh":
            (d / p.name).write_text(_emulated_source(p.read_text()))
        elif p.name in ("dwconv3x3.cu", "mdta_attention.cu",
                        "pointwise_gemm.cu"):
            out = d / (p.stem + ".cpp")
            out.write_text(_emulated_source(p.read_text()))
            srcs.append(str(out))
    so = d / "librestormer.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                        "-fPIC", "-DCID_EMULATE_MMA", *defines, f"-I{d}",
                        *srcs, "-o", str(so)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cid_dwconv3x3.argtypes = [P] * 3 + [I] * 5 + [P]
    lib.cid_mdta_workspace.argtypes = [I] * 4
    lib.cid_mdta_workspace.restype = L
    lib.cid_mdta_splits.argtypes = [I, I, L]
    lib.cid_mdta_attention.argtypes = [P] * 5 + [I, L, I, I, I, P]
    lib.cid_pointwise_gemm.argtypes = [P, L, P, L, P, P, I, L, I, I, I, P]
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulate(tmp_path_factory.mktemp("restormer_emulation"))


@pytest.fixture(scope="module")
def emulated_one_product(tmp_path_factory):
    """The same sources built with ``-DCID_TF32_NO_CORRECTION``: K9 with
    one TF32 product a multiply, which must miss its tolerance."""
    return _emulate(tmp_path_factory.mktemp("restormer_one_product"),
                    ("-DCID_TF32_NO_CORRECTION",))


@pytest.mark.parametrize("shape", [
    (1, 3, 5, 254, True),     # GDFN at C 48: hidden 127
    (1, 2, 3, 510, True),     # C 96: hidden 255
    (1, 2, 2, 2042, True),    # C 384: hidden 1021
    (2, 9, 17, 144, False),   # MDTA at C 48, several tiles and strips
    (1, 11, 3, 288, False),   # C 96, a column group past the image
    (1, 1, 1, 6, True),       # one pixel
], ids=lambda s: "x".join(map(str, s[:4])) + ("-gate" if s[4] else ""))
def test_k8_emulated_matches_its_plain_version(emulated, shape):
    n, h, w, c, gate = shape
    g = torch.Generator().manual_seed(c)
    x = torch.randn((n, h, w, c), generator=g)
    wt = torch.randn((3, 3, c), generator=g) / 3
    outs = []
    for _ in range(2):
        y = torch.full((n, h, w, c // 2 if gate else c), float("nan"))
        assert emulated.cid_dwconv3x3(x.data_ptr(), wt.data_ptr(),
                                      y.data_ptr(), n, h, w, c, int(gate),
                                      None) == 0
        outs.append(y)
    want = dwconv3x3.dwconv3x3_plain(x, wt, gate=gate)
    # the same nine products; the sums' order and erff's last bit
    assert (outs[0] - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(outs[0], outs[1])
    assert emulated.cid_dwconv3x3(x.data_ptr(), wt.data_ptr(), y.data_ptr(),
                                  n, h, w, 5, 1, None) != 0  # odd: refused


@pytest.mark.parametrize("shape", [
    (2, 9, 17, 144),   # MDTA at C 48: strips of 8 rows and a ragged one
    (1, 17, 3, 288),   # an odd width: the last column pair half past it
    (1, 1, 1, 4),      # one pixel, one channel group
    (1, 6, 10, 20),    # 5 channel groups: a warp spans pixels
], ids=lambda s: "x".join(map(str, s)))
def test_k8_emulated_float4_body_equals_the_scalar_body(emulated, shape):
    """Without the gate and with C % 4 == 0 on 16-byte aligned buffers K8
    runs its float4 body; the same input one float off that alignment runs
    the scalar body.  The two sum the same taps in the same order."""
    n, h, w, c = shape
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn((n, h, w, c), generator=g)
    wt = torch.randn((3, 3, c), generator=g) / 3
    outs = []
    for off in (0, 1):
        buf = torch.empty(x.numel() + 1)
        xs = buf[off:off + x.numel()].view(x.shape)
        xs.copy_(x)
        y = torch.full((n, h, w, c), float("nan"))
        assert (xs.data_ptr() % 16 == 0) is (off == 0)
        assert emulated.cid_dwconv3x3(xs.data_ptr(), wt.data_ptr(),
                                      y.data_ptr(), n, h, w, c, 0, None) == 0
        outs.append(y)
    assert torch.equal(outs[0], outs[1])
    want = dwconv3x3.dwconv3x3_plain(x, wt)
    assert (outs[0] - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("shape", [
    (1, 5, 7, 48, 1),    # head 48 (levels 1-4), 35 pixels: a chunk and 3
    (1, 6, 11, 96, 1),   # head 96 (decoder level 1, refinement)
    (2, 3, 3, 192, 2),   # two heads of 96, 9 pixels: under one chunk
    (1, 4, 4, 384, 8),   # the latent's eight heads of 48
    (1, 9, 9, 15, 3),    # heads of 5: the scalar loads
    (1, 1, 2, 96, 1),    # the largest head, two pixels
], ids=lambda s: "x".join(map(str, s)))
def test_k7_emulated_matches_its_plain_version(emulated, shape):
    n, h, w, c, heads = shape
    g = torch.Generator().manual_seed(c + heads)
    qkv = torch.randn((n, h, w, 3 * c), generator=g)
    temp = torch.rand((heads,), generator=g) * 1.5 + 0.5
    d = c // heads
    splits = emulated.cid_mdta_splits(n, heads, h * w)
    outs = []
    for _ in range(2):
        part = torch.empty(emulated.cid_mdta_workspace(n, heads, d, splits))
        count = torch.zeros(n * heads, dtype=torch.int32)
        a = torch.full((n, heads, d, d), float("nan"))
        assert emulated.cid_mdta_attention(
            qkv.data_ptr(), temp.data_ptr(), part.data_ptr(),
            count.data_ptr(), a.data_ptr(), n, h * w, c, heads, splits,
            None) == 0
        assert not count.any()  # the last block set it back to zero
        outs.append(a)
    want = channel_attention.channel_attention_plain(qkv, heads, temp)
    # softmax rows of numbers in [0, 1]: the Gram sums' and norms' orders
    assert (outs[0] - want).abs().max() < 1e-6
    assert torch.equal(outs[0], outs[1])


# (N, H, W, K, Cout, LayerNorm folded, residual, weight per image, row
# stride, channel offset, rows' channel mean): K9 as the forward calls it
K9_CASES = {
    "qkv 48->144 LN": (1, 3, 7, 48, 144, True, False, False, 48, 0, 0.0),
    "v W_eff + x 96->96, 2 images": (2, 5, 5, 96, 96, False, True, True, 96,
                                     0, 0.0),
    "project_in 48->254 LN": (1, 2, 9, 48, 254, True, False, False, 48, 0,
                              0.0),
    "project_out 127->48 + x": (1, 4, 5, 127, 48, False, True, False, 127, 0,
                                0.0),
    "project_in 384->2042 LN": (1, 3, 5, 384, 2042, True, False, False, 384,
                                0, 0.0),
    "project_out 1021->384 + x": (1, 2, 9, 1021, 384, False, True, False,
                                  1021, 0, 0.0),
    # the v slice of qkv in place: rows 3C apart, from channel 2C on
    "v slice 48->48, rows 144 apart": (1, 5, 6, 48, 48, False, True, True,
                                       144, 96, 0.0),
    "v slice 96->96, 2 images of 2 tiles": (2, 20, 21, 96, 96, False, True,
                                            True, 288, 192, 0.0),
    # 280 rows: a tile and 24 rows of the next
    "280 rows 48->64": (1, 4, 70, 48, 64, False, False, False, 48, 0, 0.0),
    "one pixel 48->48 LN": (1, 1, 1, 48, 48, True, False, False, 48, 0, 0.0),
    # a channel mean of 1e3 against a spread of 1: E[x^2] - E[x]^2 would
    # lose the variance to cancellation
    "mean 1e3 spread 1, LN": (1, 3, 3, 48, 144, True, False, False, 48, 0,
                              1e3),
    # four tiles or more (two emulated SMs): a block takes all of a tile's
    # passes and takes the variance once
    "840 rows 48->144 LN, all passes a block": (1, 28, 30, 48, 144, True,
                                                False, False, 48, 0, 5.0),
    "961 rows 127->130 + x": (1, 31, 31, 127, 130, False, True, False, 127,
                              0, 0.0),
}
# x max|ref|: three TF32 products and a partial sum every 32 channels read
# 2.2e-7 to 7.3e-7 here; one TF32 product 1.9e-4 to 4.2e-4
K9_TOL = 5e-6


@pytest.mark.parametrize("case", [*K9_CASES, "one-product control"])
def test_k9_emulated_matches_its_plain_version(emulated,
                                               emulated_one_product, case):
    control = case == "one-product control"
    n, h, w, k, cout, ln, res, per_image, lda, off, mean = K9_CASES[
        "qkv 48->144 LN" if control else case]
    lib = emulated_one_product if control else emulated
    g = torch.Generator().manual_seed(k + cout)
    a = (torch.randn((n, h, w, lda), generator=g) + mean)[..., off:off + k]
    wt = torch.randn(((n,) if per_image else ()) + (cout, k),
                     generator=g) / k ** 0.5
    r = torch.randn((n, h, w, cout), generator=g) if res else None
    split = pointwise_gemm.gemm_weights(wt)
    outs = []
    for _ in range(2):
        y = torch.full((n, h, w, cout), float("nan"))
        assert lib.cid_pointwise_gemm(
            a.data_ptr(), lda, split.data_ptr(),
            split[0].numel() if per_image else 0,
            None if r is None else r.data_ptr(), y.data_ptr(),
            n if per_image else 1, h * w * (1 if per_image else n), k, cout,
            int(ln), None) == 0
        outs.append(y)
    want = pointwise_gemm.pointwise_gemm_plain(a, wt, layer_norm=ln,
                                               residual=r)
    err = ((outs[0] - want).abs().max() / want.abs().max()).item()
    assert (err <= K9_TOL) is not control, err
    assert torch.equal(outs[0], outs[1])


def test_the_kernel_wrappers_refuse_what_they_cannot_run():
    x = torch.zeros((1, 4, 4, 6))
    with pytest.raises(ValueError, match="even channel count"):
        dwconv3x3.dwconv3x3(x[..., :5].contiguous(), torch.zeros(3, 3, 5),
                            gate=True)
    with pytest.raises(ValueError, match="heads"):
        channel_attention.channel_attention(torch.zeros((1, 2, 2, 3 * 97)),
                                            1, torch.ones(1))
    assert tuple(dwconv3x3.tap_weights(torch.zeros(7, 1, 3, 3)).shape) == \
        (3, 3, 7)
    x = torch.zeros((1, 2, 3, 24))
    with pytest.raises(ValueError, match="one stride between pixel rows"):
        pointwise_gemm.pointwise_gemm(x.transpose(1, 2)[..., :8],
                                      torch.zeros(4, 8))
    with pytest.raises(ValueError, match="w must be"):
        pointwise_gemm.pointwise_gemm(x, torch.zeros(2, 4, 24))  # 1 image
    with pytest.raises(ValueError, match="split weights"):
        pointwise_gemm.pointwise_gemm(x, torch.zeros(4, 24),
                                      w_tf32=torch.zeros(1, 3, 2, 128, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        pointwise_gemm.pointwise_gemm(x.to("meta"),
                                      torch.zeros(4, 24, device="meta"))
    assert tuple(pointwise_gemm.gemm_weights(torch.zeros(130, 40)).shape) \
        == (2, 8, 2, 128, 8)


# ---------------------------------------------------------------------------
# spans and kernel calls
def test_one_forward_enters_each_span_and_kernel_as_often_as_the_model_has(
        monkeypatch):
    model = restormer.Restormer(**INIT).eval()
    spans, calls = {}, {"K2": 0, "K7": 0, "K8": 0, "K8 gated": 0, "K9": 0,
                        "K9 LN": 0}

    @contextlib.contextmanager
    def counting(name):
        spans[name] = spans.get(name, 0) + 1
        yield

    def spy(key, fn):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    k2 = conv3x3.conv3x3_bias_relu
    monkeypatch.setattr(restormer, "span", counting)
    monkeypatch.setattr(conv3x3, "conv3x3_bias_relu", spy("K2", k2))
    monkeypatch.setattr(channel_attention, "channel_attention",
                        spy("K7", channel_attention.channel_attention))
    monkeypatch.setattr(dwconv3x3, "dwconv3x3",
                        spy("K8", dwconv3x3.dwconv3x3))
    k9 = pointwise_gemm.pointwise_gemm

    def k9_spy(*a, layer_norm=False, **kw):
        calls["K9"] += 1
        calls["K9 LN"] += layer_norm
        return k9(*a, layer_norm=layer_norm, **kw)
    monkeypatch.setattr(pointwise_gemm, "pointwise_gemm", k9_spy)
    depthwise = restormer.depthwise

    def gated(x, w, gate, route):
        calls["K8 gated"] += gate
        return depthwise(x, w, gate, route)
    monkeypatch.setattr(restormer, "depthwise", gated)
    with torch.no_grad():
        model(torch.rand((1, 3, 16, 16)))
    assert spans == {"cid.restormer.attention": 44, "cid.restormer.ffn": 44,
                     "cid.restormer.resample": 6}
    assert calls == {"K2": 8, "K7": 44, "K8": 88, "K8 gated": 44, "K9": 178,
                     "K9 LN": 88}
    # LayerNorm runs inside K9 only: the model has no pass of its own
    assert not hasattr(restormer, "layer_norm")


# ---------------------------------------------------------------------------
# planted faults
@pytest.mark.parametrize("fault", [None, *restormer_faults.FAULTS],
                         ids=["sound", *restormer_faults.FAULTS])
def test_each_planted_fault_fails_the_comparison(server, published_reference,
                                                 fault):
    worst = 0.0
    # 64 x 64: one value a count off reads 8.1e-5, under the limit
    with restormer_faults.planted(fault):
        for seed in (2 ** 31 + 5, 2 ** 31 + 6):
            image = _image(64, 64, seed)
            got = server.denoise_image(image, "restormer").astype(np.int16)
            want = _served_by_reference(published_reference, image)
            worst = max(worst, float(np.abs(got - want).mean()))
    assert (worst > _limit()) is (fault is not None), worst


# ---------------------------------------------------------------------------
# the serving contract
def test_restormer_is_built_at_first_use_and_served_in_float():
    st = ServeState(device="cpu", quantize="int8")
    assert "restormer" not in st.models
    assert st.info()["models"][-1] == "restormer"
    assert st.healthz()["models"][-1] == "restormer"
    assert st.ladder("restormer") is None  # no int8 rung: no calibration
    assert "restormer" not in st.models
    png = imageio.encode_png(_image(20, 13, seed=3))
    r = st.enhance("restormer", png, include_graph=False)
    assert set(r) == {"denoised_image_base64", "noise_graph_base64",
                      "backend"}
    out = imageio.decode_png(base64.b64decode(r["denoised_image_base64"]))
    assert out.shape == (20, 13, 3)
    assert st.last_compute_backend() == "float"
    assert isinstance(st.models["restormer"], restormer.Restormer)
    assert st._model("restormer") is st.models["restormer"]
    assert st._input_shape("restormer", 20, 13) == (24, 16)
    assert st._padding("restormer", 20, 13) == (1, 2, 2, 2)


@pytest.mark.parametrize("how", ["tiled", "sharded"])
def test_an_input_restormer_would_tile_or_shard_is_refused(server, how):
    """Its attention spans the image, so no tile or strip gives the same
    answer: over the threshold the server refuses the request rather than
    tile or shard it, and with tiling off and no mesh serves it whole."""
    from celebrity_image_denoiser_tpu_torch.parallel import make_mesh
    from celebrity_image_denoiser_tpu_torch.serve.handlers import (
        EnhanceError,
    )

    kw = ({"mesh": make_mesh(devices=["cpu"] * 2), "use_tiling": False}
          if how == "sharded" else {})
    st = ServeState(device="cpu", tile_threshold_rows=16, **kw)
    image = _image(20, 13, seed=4)  # padded to 24 x 16: over 16 rows
    assert st._big_route((1, 24, 16, 3))[0] == how
    with pytest.raises(EnhanceError, match="too large for restormer") as e:
        st.denoise_image(image, "restormer")
    assert e.value.status == 400
    with pytest.raises(EnhanceError):
        st.enhance("restormer", imageio.encode_png(image),
                   include_graph=False)
    assert st.stats.snapshot()["errors"] == {"restormer:400": 1}
    assert "restormer" not in st.models  # refused before its forward
    st.warmup(((20, 13),), models=("restormer",))  # skipped, not raised
    assert "restormer" not in st.models
    assert st.denoise_image(image, "dncnn").shape == image.shape  # + how
    assert st.last_compute_backend() == "float+" + how
    whole = ServeState(device="cpu", tile_threshold_rows=16,
                       use_tiling=False)
    whole.models["restormer"] = server._model("restormer")  # built once
    np.testing.assert_array_equal(whole.denoise_image(image, "restormer"),
                                  server.denoise_image(image, "restormer"))
    assert whole.last_compute_backend() == "float"
