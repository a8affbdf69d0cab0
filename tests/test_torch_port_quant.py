"""The port's int8 serving (``ops/quant.py``, ``ops/quant_unet.py``, the int8
kernels' plain versions, the serving ladder) against the JAX package, on the
CPU.

* ``act_scale`` and ``quantize_weight`` are bit-identical to JAX's; the
  plain s8 conv and transpose conv equal ``quant_unet._conv_q`` /
  ``_convt_q`` exactly, in s32, bf16 and s8.
* The s8 program, given the same per-conv amaxes as JAX's, has the same
  scales and folded weights bit for bit, and its output equals the JAX
  function run op by op.  Run under ``jax.jit`` on the CPU, the JAX program
  differs: XLA rewrites ``x / s`` by a constant into ``x · (1/s)``, skips the
  bf16 rounding of the transpose convs' bias add and of the tanh output
  (excess precision; read in the compiled HLO).  A plain program with those
  three rewrites equals the jitted one, which shows the cause; the port keeps
  the written order (true division, as its kernels must).
* Each package calibrated on the same array: u8 pixels within one count.
* The generic transform with bias correction, the replay's loud errors, the
  topology check, and the serving ladder (s8-skip → generic → float behind
  the 40 dB gate), as ``tests/test_quant.py`` holds the JAX package.

The JAX side runs as its own tests run it on the CPU; calibration arrays and
inputs are numpy, handed to both.
"""

import base64

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu.ckpt import load_checkpoint
from celebrity_image_denoiser_tpu.ops import quant as jquant
from celebrity_image_denoiser_tpu.ops import quant_unet as jquant_unet
from celebrity_image_denoiser_tpu_torch.ckpt.convert import (
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    calibration_batch,
)
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.ops import quant, quant_unet
from celebrity_image_denoiser_tpu_torch.ops.conv import Conv2d
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3
from celebrity_image_denoiser_tpu_torch.ops.cuda import conv3x3_s8 as k5
from celebrity_image_denoiser_tpu_torch.ops.cuda import convt2x2_s8 as k6
from celebrity_image_denoiser_tpu_torch.serve import quality
from celebrity_image_denoiser_tpu_torch.serve.handlers import (
    EnhanceError,
    ServeState,
)
from celebrity_image_denoiser_tpu_torch.serve.quality import (
    psnr_u8,
    structured_clean,
)
from torch_port_threads import _one_torch_thread  # noqa: F401

WEIGHTS = "weights/denoise"
BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _bits(t):
    return np.asarray(t, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def jax_model():
    return jax_models.DenoiseGenerator()


@pytest.fixture(scope="module")
def params():
    sections, _ = load_checkpoint(WEIGHTS)
    # a random init made by the port (the JAX init takes seconds to compile)
    rand = DenoiseGenerator(generator=torch.Generator().manual_seed(0))
    return {"shipped": sections["generator"],
            "random": state_dict_to_jax_params(rand.state_dict())[0]}


def _port(p) -> DenoiseGenerator:
    m = DenoiseGenerator()
    m.load_state_dict(jax_params_to_state_dict(p), strict=True)
    return m.eval()


def _jax_amaxes(jax_model, p, calib):
    """The per-conv amaxes JAX's builders record (quant_unet.py:118-126)."""
    tap = jquant._Calibrate()

    def cal(x):
        tap.taps.clear()
        with jquant._mode(tap):
            jax_model.apply(p, {}, x, train=False)
        return [t[0] for t in tap.taps]

    return [_t(a) for a in jax.jit(cal)(jnp.asarray(calib))]


def _u8(y):
    """The serving output map: clip(y·0.5+0.5) → truncate to uint8."""
    return (np.clip(np.asarray(y, np.float32) * 0.5 + 0.5, 0, 1)
            * 255).astype(np.uint8).astype(np.int16)


# ---------------------------------------------------------------------------
# quantizer primitives
def test_act_scale_is_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    amax = (rng.uniform(0, 3, 64) * 10.0 ** rng.uniform(-3, 1, 64)).astype(
        np.float32)
    amax[5] = 1e-9   # a near-dead channel: hits the 1% floor
    amax[9] = 0.0
    got = quant.act_scale(_t(amax)).numpy()
    want = np.asarray(jquant.act_scale(jnp.asarray(amax)))
    assert np.array_equal(_bits(got), _bits(want))
    assert got[5] == got[9] == np.float32(0.01) * amax.max() / np.float32(127)


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "convt"])
def test_quantize_weight_and_fold_are_bit_identical_to_jax(transposed):
    """Per-output-channel weights, with per-input-channel activation scales
    folded in, in PyTorch's layout against JAX's (HWIO; (kH, kW, Cout, Cin)
    for a transpose conv)."""
    rng = np.random.default_rng(1)
    k = 2 if transposed else 3
    jk = (rng.normal(0, 1, (k, k, 16, 8)) * 10.0 ** rng.uniform(-2, 1, 8)
          ).astype(np.float32)
    s_c = quant.act_scale(_t(rng.uniform(0.01, 2, 8 if transposed else 16)
                             .astype(np.float32)))
    # JAX: out axis 3 (conv) or 2 (transpose), the fold on the other one
    out_axis, in_axis = (2, 3) if transposed else (3, 2)
    shape = [1, 1, 1, 1]
    shape[in_axis] = -1
    jw, js = jquant.quantize_weight(
        jnp.asarray(jk) * jnp.asarray(s_c.numpy()).reshape(shape), out_axis)
    tw = _t(jk).permute(3, 2, 0, 1)  # PyTorch's layout of either
    w_i8, w_scale, _ = quant.fold_and_quantize(tw, s_c, transposed)
    assert np.array_equal(_bits(w_scale.numpy()), _bits(js))
    assert np.array_equal(w_i8.permute(2, 3, 1, 0).numpy(), np.asarray(jw))


def _s8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("two_inputs", [False, True], ids=["one", "concat"])
def test_plain_s8_conv_equals_jax_conv_q(two_inputs):
    """K5's plain version against ``_conv_q`` (eager, op by op): the s32 sums
    (up to 9·256·127², past 2^24), the bf16 output and the s8 output,
    exactly; with two inputs the second a cropped view (the skip concat)."""
    rng = np.random.default_rng(2)
    cin = 256
    x = _s8(rng, 2, 7, 9, cin)
    x[0, 2:5, 3:6] = 127  # a window of maxima: the largest sums
    w = _s8(rng, 3, 3, cin, 24)
    w[:, :, :, 0] = 127
    ws = (rng.uniform(1e-5, 2e-4, 24)).astype(np.float32)
    b = jnp.asarray(rng.normal(0, 0.3, 24), jnp.bfloat16)
    s = rng.uniform(0.005, 0.05, 24).astype(np.float32)
    acc = np.asarray(jquant_unet._conv_i32(jnp.asarray(x), jnp.asarray(w)))
    h = jquant_unet._conv_q(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
                            b)
    q = np.asarray(jquant_unet._q(jax.nn.relu(h), jnp.asarray(s)))
    wt = _t(w).permute(3, 0, 1, 2).contiguous()
    bt = _t(np.asarray(b).view(np.uint16)).view(BF16)
    args = {"x": _t(x)}
    if two_inputs:  # channels [0, 128) and [128, 256), the latter a crop
        big = torch.zeros(2, 8, 11, cin - 128, dtype=torch.int8)
        big[:, :7, :9] = _t(x[..., 128:])
        args = {"x": _t(x[..., :128]), "x2": big[:, :7, :9]}
    assert np.abs(acc).max() > 2 ** 24
    assert np.array_equal(k5.conv3x3_s32(_t(x), wt).numpy(), acc)
    got = k5.conv3x3_s8_plain(args["x"], wt, _t(ws), bt, x2=args.get("x2"))
    assert torch.equal(got, _t(np.asarray(h).view(np.uint16)).view(BF16))
    got = k5.conv3x3_s8(args["x"], wt, _t(ws), bt, relu=True,
                        out_scale=_t(s), x2=args.get("x2"))
    assert np.array_equal(got.numpy(), q)
    raw = k5.conv3x3_s8(args["x"], wt, _t(ws), x2=args.get("x2"))
    assert np.array_equal(_bits(raw.numpy()), _bits(acc.astype(np.float32)
                                                    * ws))


def test_plain_s8_convt_equals_jax_convt_q():
    """K6's plain version against ``_convt_q`` (the flipped, axis-swapped
    kernel in a fractionally-strided conv), eager: s32, bf16 and s8."""
    rng = np.random.default_rng(3)
    x, w = _s8(rng, 2, 5, 6, 128), _s8(rng, 2, 2, 64, 128)
    ws = rng.uniform(1e-5, 2e-4, 64).astype(np.float32)
    b = jnp.asarray(rng.normal(0, 0.3, 64), jnp.bfloat16)
    s = rng.uniform(0.005, 0.05, 64).astype(np.float32)
    k2 = jnp.swapaxes(jnp.flip(jnp.asarray(w), axis=(0, 1)), 2, 3)
    acc = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), k2, (1, 1), ((1, 1), (1, 1)), lhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    h = jquant_unet._convt_q(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
                             b)
    q = np.asarray(jquant_unet._q(h, jnp.asarray(s)))
    bt = _t(np.asarray(b).view(np.uint16)).view(BF16)
    assert np.array_equal(k6.convt2x2_s32(_t(x), _t(w)).numpy(), acc)
    got = k6.convt2x2_s8(_t(x), _t(w), _t(ws), bt)
    assert torch.equal(got, _t(np.asarray(h).view(np.uint16)).view(BF16))
    got = k6.convt2x2_s8(_t(x), _t(w), _t(ws), bt, out_scale=_t(s))
    assert np.array_equal(got.numpy(), q)


def test_plain_q8_first_conv_matches_jax_conv_f():
    """K2's s8-out mode against ``_q(relu(_conv_f(x, W0, b0)), s)``: the f32
    sums of the bf16 conv run in another order in XLA's CPU conv, so a bf16
    rounding may fall the other way — at most one s8 step, on < 1%."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.uniform(-1, 1, (2, 16, 18, 3)), jnp.bfloat16)
    w = rng.normal(0, 0.3, (3, 3, 3, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    s = rng.uniform(0.002, 0.01, 64).astype(np.float32)
    want = np.asarray(jquant_unet._q(jax.nn.relu(jquant_unet._conv_f(
        x, jnp.asarray(w, jnp.bfloat16), jnp.asarray(b))), jnp.asarray(s)))
    xt = _t(np.asarray(x).view(np.uint16)).view(BF16)
    got = conv3x3.conv3x3_bias_relu_q8(xt, _t(w).to(BF16), _t(b), _t(s))
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


# ---------------------------------------------------------------------------
# the s8 skip-storage program
@pytest.mark.parametrize("which, shape", [("shipped", (2, 32, 32, 3)),
                                          ("random", (2, 32, 32, 3)),
                                          ("shipped", (1, 30, 34, 3)),
                                          ("random", (1, 30, 34, 3))])
def test_s8_program_matches_jax_given_the_same_amaxes(jax_model, params,
                                                      which, shape):
    """Tier (a): the JAX per-conv amaxes handed to the port: the 12 scales
    and the eleven folded s8 weights are equal bit for bit, and the output
    equals the JAX function run op by op (no XLA fusion) on every element
    (the bar: ≥ 99.9% equal, one bf16 ulp elsewhere).  1×30×34 takes the
    skip crop twice."""
    p = params[which]
    rng = np.random.default_rng(5)
    calib = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    amaxes = _jax_amaxes(jax_model, p, calib)
    qt = quant_unet.QuantizedDenoiseUNet(_port(p), amaxes)
    for i, a in enumerate(amaxes):
        assert np.array_equal(_bits(qt.scales[i].numpy()),
                              _bits(jquant.act_scale(jnp.asarray(a.numpy()))))
    s = [jquant.act_scale(jnp.asarray(a.numpy())) for a in amaxes]
    fold = {1: s[1], 2: s[10][64:], 3: s[3], 4: s[7][128:], 5: s[5],
            6: s[6], 7: s[7], 8: s[8], 9: s[9], 10: s[10], 11: s[11]}
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    kernels = {"/".join(str(k.key) for k in path[:-1]): v
               for path, v in flat if path[-1].key == "kernel"}
    for i in range(1, 12):
        kern = kernels[quant_unet.PATHS[i].replace(".", "/")]
        out_axis = 2 if i in quant_unet.TRANSPOSED else 3
        shape_ = [1, 1, 1, 1]
        shape_[5 - out_axis] = -1
        jw, js = jquant.quantize_weight(kern * fold[i].reshape(shape_),
                                        out_axis)
        tw = getattr(qt, f"w{i}")
        tw = tw if i in quant_unet.TRANSPOSED else tw.permute(1, 2, 3, 0)
        assert np.array_equal(tw.numpy(), np.asarray(jw)), i
        assert np.array_equal(_bits(getattr(qt, f"ws{i}").numpy()), _bits(js))
    qj = jquant_unet.quantize_apply_denoise_unet(jax_model, p, {},
                                                 jnp.asarray(calib))
    want = np.asarray(qj(jnp.asarray(x)), np.float32)  # op by op
    got = qt(_t(x)).numpy()
    assert got.shape == want.shape  # 30×34 crops to 28×32, as in JAX
    diff = np.abs(got - want)
    ulp = np.abs(want) * 2.0 ** -8 + 1e-30
    assert (diff == 0).mean() >= 0.999 and (diff <= ulp).all()


@pytest.mark.parametrize("which, shape", [("shipped", (2, 32, 32, 3)),
                                          ("random", (1, 30, 34, 3))])
def test_s8_program_float_output_conv_matches_jax(jax_model, params, which,
                                                  shape):
    """``quant_last=False`` (the output conv 64 → 3 in bf16, not s8): given
    JAX's amaxes, the port's program equals JAX's
    ``quantize_apply_denoise_unet(quant_last=False)`` run op by op, at the
    bar of the ``quant_last=True`` test (≥ 99.9% equal, one bf16 ulp
    elsewhere); it holds no s8 weight for conv 11."""
    p = params[which]
    rng = np.random.default_rng(6)
    calib = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    amaxes = _jax_amaxes(jax_model, p, calib)
    qt = quant_unet.QuantizedDenoiseUNet(_port(p), amaxes, quant_last=False)
    assert not hasattr(qt, "w11") and qt.wf11.dtype == BF16
    qj = jquant_unet.quantize_apply_denoise_unet(
        jax_model, p, {}, jnp.asarray(calib), quant_last=False)
    want = np.asarray(qj(jnp.asarray(x)), np.float32)  # op by op
    got = qt(_t(x)).numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    ulp = np.abs(want) * 2.0 ** -8 + 1e-30
    assert (diff == 0).mean() >= 0.999 and (diff <= ulp).all()
    # and it is not the quant_last=True program
    q8 = quant_unet.QuantizedDenoiseUNet(_port(p), amaxes)
    assert not np.array_equal(q8(_t(x)).numpy(), got)


def _xla_cpu_order(q: quant_unet.QuantizedDenoiseUNet, x):
    """The port's program with the three rewrites XLA's CPU compiler makes
    in the jitted JAX program: x / s by a constant as x · (1/s), the
    transpose convs' bias added in f32 without the bf16 rounding, and tanh
    left in f32."""
    def qz(h, s):
        return torch.clamp(torch.round(h.float() * (1.0 / s)), -127,
                           127).to(torch.int8)

    def conv(i, h, relu=True, out=True, x2=None):
        if x2 is not None:
            h = torch.cat([h, x2], 3)
        y = (k5.conv3x3_s32(h, getattr(q, f"w{i}")).float()
             * getattr(q, f"ws{i}")).to(BF16) + getattr(q, f"b{i}")
        y = torch.relu(y) if relu else y
        return qz(y, getattr(q, f"so{i}")) if out else y

    def up(i, h):
        y = (k6.convt2x2_s32(h, getattr(q, f"w{i}")).float()
             * getattr(q, f"ws{i}")).to(BF16).float() + getattr(q, f"b{i}")
        return qz(y, getattr(q, f"so{i}"))

    y0 = conv3x3.conv3x3_bias_relu_plain(x.to(BF16), q.wf0, torch.zeros(64),
                                         relu=False)
    e1 = conv(1, qz(torch.relu(y0 + q.b0), q.so0))
    e2 = conv(3, conv(2, quant_unet.maxpool_s8(e1)))
    d2a = up(6, conv(5, conv(4, quant_unet.maxpool_s8(e2))))
    e2 = e2[:, :d2a.shape[1], :d2a.shape[2]]
    d1a = up(9, conv(8, conv(7, d2a, x2=e2)))
    e1 = e1[:, :d1a.shape[1], :d1a.shape[2]]
    return torch.tanh(conv(11, conv(10, d1a, x2=e1), relu=False,
                           out=False).float())


def test_s8_program_gap_to_the_jitted_jax_program_is_xla_rounding(jax_model,
                                                                   params):
    """Shipped weights, 2×32×32, the same amaxes: the jitted JAX program
    equals the port's program with XLA's CPU rewrites (``_xla_cpu_order``)
    within 1e-6 (XLA's tanh against PyTorch's), and on every element once
    both are rounded to bf16; the port's own program (the written order)
    stays within one u8 count of it on ≥ 99% of the served pixels."""
    p = params["shipped"]
    rng = np.random.default_rng(6)
    calib = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    qt = quant_unet.QuantizedDenoiseUNet(
        _port(p), _jax_amaxes(jax_model, p, calib))
    qj = jquant_unet.quantize_apply_denoise_unet(jax_model, p, {},
                                                 jnp.asarray(calib))
    want = np.asarray(jax.jit(qj)(jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        xla = _xla_cpu_order(qt, _t(x)).numpy()
    assert np.abs(xla - want).max() <= 1e-6
    assert torch.equal(_t(xla).to(BF16), _t(want).to(BF16))
    diff = np.abs(_u8(qt(_t(x))) - _u8(want))
    assert (diff <= 1).mean() >= 0.99


def test_s8_program_calibrated_by_each_package_agrees(jax_model, params):
    """Tier (b): each package calibrates on the same array (its own f32
    forward, its own amaxes): the served u8 pixels (jitted JAX program) are
    within one count on ≥ 99%."""
    p = params["shipped"]
    calib = calibration_batch(True, 32).numpy()
    x = np.random.default_rng(7).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    qj = jquant_unet.quantize_apply_denoise_unet(jax_model, p, {},
                                                 jnp.asarray(calib))
    want = _u8(jax.jit(qj)(jnp.asarray(x)))
    got = _u8(quant_unet.quantize_apply_denoise_unet(_port(p), _t(calib))(
        _t(x)))
    assert (np.abs(got - want) <= 1).mean() >= 0.99


def test_s8_builder_rejects_other_topologies_and_split_concat():
    """A conv sequence that is not the U-Net's raises ValueError (the ladder
    then tries the generic rung); the rejected split-concat variant is not
    ported and says so."""
    model = torch.nn.Sequential(Conv2d(3, 64, 3, padding=1), torch.nn.ReLU(),
                                Conv2d(64, 3, 3, padding=1))
    calib = torch.zeros(2, 16, 16, 3)
    with pytest.raises(ValueError, match="denoise U-Net"):
        quant_unet.quantize_apply_denoise_unet(model, calib)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quant_unet.quantize_apply_denoise_unet(DenoiseGenerator(), calib,
                                               split_concat=True)


def test_calibration_hooks_see_the_jax_call_order():
    """Twelve taps in JAX's order on route='autograd'; the kernel route hides
    conv 1 of each pair inside the fused pair, so it must never calibrate
    (it shows only the two transpose convs)."""
    m = DenoiseGenerator().eval()
    x = calibration_batch(True, 16)
    taps = quant.calibrate(m, x)
    assert [quant_unet._jax_shape(t[1]) for t in taps] == quant_unet.EXPECTED
    assert [t[3] for t in taps] == [256, 256, 64, 64, 16, 16, 16, 64, 64,
                                    64, 256, 256]
    seen = []
    hooks = [mod.register_forward_hook(lambda *a: seen.append(1))
             for mod in m.modules() if isinstance(mod, torch.nn.Conv2d)]
    with torch.inference_mode():
        m(x.permute(0, 3, 1, 2), route="kernel")
    for h in hooks:
        h.remove()
    assert not seen


# ---------------------------------------------------------------------------
# the generic transform
def test_generic_bias_corrected_transform_matches_jax(jax_model, params):
    """``quantize_apply(bias_correct=True)`` on a random init, each package
    calibrating and correcting on the same array: the two int8 forwards
    agree at > 60 dB (the f32 convs sum in other orders and XLA divides by
    reciprocals), and both track float at ≥ 40 dB."""
    p = params["random"]
    rng = np.random.default_rng(8)
    calib = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    qj = jquant.quantize_apply(jax_model, p, {}, jnp.asarray(calib),
                               bias_correct=True)
    yj = np.asarray(jax.jit(qj)(jnp.asarray(x)))
    m = _port(p)
    qt = quant.quantize_apply(m, _t(calib), bias_correct=True)
    yt = qt(_t(x)).numpy()
    # the 3-channel convs (first and last) stay float, as in JAX
    assert [e is None for e in qt.entries] == [True] + [False] * 10 + [True]
    with torch.inference_mode():
        yf = m(_t(x).permute(0, 3, 1, 2), route="autograd").permute(
            0, 2, 3, 1).numpy()

    def db(a, b):
        return 10 * np.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-12))

    assert db(yt, yj) > 60.0 and db(yt, yf) > 40.0 and db(yj, yf) > 40.0


def test_generic_corrections_match_jax_collect_pass(jax_model, params):
    """The bias corrections themselves, per conv, against JAX's
    ``_BiasCorrectCollect`` run on the port's own calibration (same
    entries), to 1e-3 of the largest correction."""
    p = params["random"]
    calib = np.random.default_rng(9).uniform(-1, 1, (4, 32, 32, 3)).astype(
        np.float32)
    qt = quant.quantize_apply(_port(p), _t(calib), bias_correct=True)
    # (kH, kW, dim 1, dim 0): JAX's layout of a conv and a transpose conv
    entries = [None if e is None else
               (jnp.asarray(e[0].permute(2, 3, 1, 0).numpy()),
                jnp.asarray(e[1].numpy()), jnp.asarray(e[2].numpy()))
               for e in qt.entries]
    ctx = jquant._BiasCorrectCollect(list(entries))
    sub = jnp.asarray(quant.bias_correct_subsample(_t(calib)).numpy())
    with jquant._mode(ctx):
        jax_model.apply(p, {}, sub, train=False)
    want = [np.asarray(c) for c in ctx.corrections if c is not None]
    got = [e[3].numpy() for e in qt.entries if e is not None]
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-3 * scale)


def test_quantized_fraction_counts_the_unet():
    m = DenoiseGenerator().eval()
    frac = quant.quantized_fraction(m, calibration_batch(True, 32))
    assert 0.95 < frac < 1.0  # the two 3-channel convs stay float


class _Mutable(torch.nn.Module):
    """A model whose conv call sequence can change after calibration."""

    def __init__(self):
        super().__init__()
        self.a = Conv2d(16, 16, 3, padding=1)
        self.b = Conv2d(16, 32, 3, padding=1)
        self.b_alt = Conv2d(16, 24, 3, padding=1)
        self.mode = "wide"

    def forward(self, x):
        h = self.a(x)
        if self.mode == "short":
            return h
        return (self.b if self.mode == "wide" else self.b_alt)(h)


def test_int8_replay_topology_change_fails_loudly():
    """Positional replay never applies the wrong int8 weights: a shape
    mismatch, fewer calls and more calls than calibrated all raise."""
    torch.manual_seed(7)
    model = _Mutable().eval()
    rng = np.random.default_rng(7)
    calib = _t(rng.uniform(-1, 1, (2, 16, 16, 16)).astype(np.float32))
    qapply = quant.quantize_apply(model, calib, skip=lambda w: False)
    x = calib[:1]
    qapply(x)  # unchanged topology replays fine
    model.mode = "alt"
    with pytest.raises(ValueError, match="replay mismatch"):
        qapply(x)
    model.mode = "short"
    with pytest.raises(ValueError, match="under-consumed"):
        qapply(x)
    model.mode = "wide"
    qshort = quant.QuantizedApply(model, qapply.entries[:1])
    with pytest.raises(ValueError, match="over-consumed"):
        qshort(x)


def test_calibration_batch_sigma_list():
    assert calibration_batch(True, 32).shape == (8, 32, 32, 3)
    b = calibration_batch(False, 16, sigmas=(0.05, 0.12, 0.25))
    assert b.shape == (24, 16, 16, 3) and b.min() >= 0 and b.max() <= 1
    t = calibration_batch(True, 16)
    assert t.min() >= -1 and t.max() <= 1
    assert torch.equal(t, calibration_batch(True, 16))  # seeded


# ---------------------------------------------------------------------------
# serving
def _png(img):
    return imageio.encode_png(img)


def test_int8_serving_answers_enhance_through_the_s8_program():
    st = ServeState(device="cpu", quantize="int8")
    assert st.healthz()["quantize"] == "int8"
    img = structured_clean(48)
    r = st.enhance("denoise", _png(img), "image/png", include_graph=False)
    # each family's ladder is built at its first use, as in the JAX server
    assert st.int8_rung == {"denoise": "int8-s8skip"}
    assert r["backend"] == "torch" and st.last_compute_backend() == "int8"
    out = imageio.decode_png(base64.b64decode(r["denoised_image_base64"]))
    assert out.shape == (48, 48, 3)
    assert st.stats.snapshot()["compute_backends"] == {"int8": 1}


def test_s8_skip_builder_failure_falls_back_to_generic_int8(monkeypatch):
    """The specialised builder refusing the model (a ValueError) moves the
    ladder to the generic transform, not to float."""
    def boom(*a, **k):
        raise ValueError("not the denoise U-Net conv sequence (simulated)")

    monkeypatch.setattr(quant_unet, "quantize_apply_denoise_unet", boom)
    st = ServeState(weights_dir="/nonexistent-weights", seed=7,
                    quantize="int8", device="cpu")
    r = st.enhance("denoise", _png(np.zeros((32, 32, 3), np.uint8)),
                   "image/png", include_graph=False)
    assert r["denoised_image_base64"]
    assert st.last_compute_backend() == "int8"
    assert st.int8_rung["denoise"] == "int8-generic"


def test_runtime_agreement_gate_falls_back_to_float(monkeypatch):
    """Every rung that fails the 40 dB gate (simulated: zeros) is refused,
    and the model serves float."""
    def broken(model, calib, **kw):
        return lambda x: torch.zeros_like(x)

    monkeypatch.setattr(quant_unet, "quantize_apply_denoise_unet", broken)
    monkeypatch.setattr(quant, "quantize_apply", broken)
    st = ServeState(weights_dir="/nonexistent-weights", seed=7,
                    quantize="int8", device="cpu")
    r = st.enhance("denoise", _png(np.full((32, 32, 3), 200, np.uint8)),
                   "image/png", include_graph=False)
    assert r["denoised_image_base64"]
    assert st.last_compute_backend() == "float"
    assert st.int8_rung["denoise"] is None


def test_kernel_errors_are_not_caught_into_a_fallback(monkeypatch):
    """Only a builder's ValueError or a failed gate moves the ladder down: a
    kernel that fails to build or launch propagates."""
    def launch_failed(*a, **k):
        raise RuntimeError("conv3x3_s8: CUDA error 98 (simulated)")

    monkeypatch.setattr(k5, "conv3x3_s8", launch_failed)
    # the ladder is built at the family's first use
    st = ServeState(device="cpu", quantize="int8")
    with pytest.raises(RuntimeError, match="simulated"):
        st.ladder("denoise")
    # a request does not quietly serve float either: a 500
    with pytest.raises(EnhanceError) as e:
        st.enhance("denoise", _png(np.zeros((16, 16, 3), np.uint8)))
    assert e.value.status == 500 and "denoise" not in st.int8_rung


def test_serve_cli_defaults_to_int8():
    from celebrity_image_denoiser_tpu_torch.cli.serve import build_parser

    assert build_parser().parse_args([]).quantize == "int8"
    assert build_parser().parse_args(["--quantize", "off"]).quantize == "off"


def test_quantized_serving_quality_gate():
    """The shipped weights through /enhance under quantize='int8': ≥ 40 dB
    against the float server's pixels, and still a denoiser (gain > 1 dB,
    and the fixture gain at least 70% of the one recorded with the
    weights), on the s8 rung — the gate must bite, not pass on a float
    fallback."""
    clean = structured_clean(128)
    rng = np.random.default_rng(4)
    noisy = np.clip(clean.astype(np.float64) + rng.normal(0, 25, clean.shape),
                    0, 255).astype(np.uint8)
    png = _png(noisy)
    st_f = ServeState(device="cpu")
    st_q = ServeState(device="cpu", quantize="int8")
    rf = st_f.enhance("denoise", png, "image/png", include_graph=False)
    rq = st_q.enhance("denoise", png, "image/png", include_graph=False)
    assert st_q.last_compute_backend() == "int8"
    assert st_q.int8_rung["denoise"] == "int8-s8skip"
    yf, yq = (imageio.decode_png(base64.b64decode(r["denoised_image_base64"])
                                 ).astype(np.float32) for r in (rf, rq))
    mse = float(np.mean((yf - yq) ** 2))
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 40.0
    assert psnr_u8(yq.astype(np.uint8), clean) - psnr_u8(noisy, clean) > 1.0
    floor = quality.recorded_gate_floor(st_q.weights_dir, "denoise",
                                        default=1.0)
    assert quality.fixture_gain_db(st_q, "denoise") >= floor > 5.0
    assert st_q.last_compute_backend() == "int8"


# ---------------------------------------------------------------------------
# a conv geometry with no int8 kernel, and the kernel's input bound
def _on_a_card(x):
    """``x`` as ``_no_kernel`` sees a tensor on a card: only its device."""
    return type("OnCard", (), {"device": torch.device("cuda")})()


def test_no_int8_kernel_is_a_builder_value_error():
    """Off the CPU a geometry no int8 kernel takes raises ``NoInt8Kernel``,
    a ``ValueError`` naming the geometry; on the CPU it is not an error."""
    x = torch.zeros(1, 64, 4, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match=r"weight \(128, 64, 4, 4\)") as e:
        quant._no_kernel(_on_a_card(x), "conv", (128, 64, 4, 4), 2)
    assert isinstance(e.value, quant.NoInt8Kernel)
    assert quant._no_kernel(x, "conv", (128, 64, 4, 4), 2) is None


@pytest.mark.parametrize("when", ["build", "gate"])
def test_no_int8_kernel_moves_the_ladder_down(monkeypatch, when):
    """A rung whose builder, or whose forward under the gate, meets a conv
    with no int8 kernel is left for the next one (here every rung: float),
    as the JAX ladder serves float for such a model; the server starts."""
    def no_kernel():
        quant._no_kernel(_on_a_card(None), "conv", (128, 64, 4, 4), 2)

    def builder(model, calib, **kw):
        if when == "build":
            no_kernel()
        return lambda x: no_kernel()

    monkeypatch.setattr(quant_unet, "quantize_apply_denoise_unet", builder)
    monkeypatch.setattr(quant, "quantize_apply", builder)
    st = ServeState(weights_dir="/nonexistent-weights", seed=7,
                    quantize="int8", device="cpu")
    assert st.ladder("denoise") is None
    st.enhance("denoise", _png(np.zeros((16, 16, 3), np.uint8)),
               "image/png", include_graph=False)
    assert st.last_compute_backend() == "float"


def test_int8_conv2d_checks_the_kernel_input_bound(monkeypatch):
    """A 3×3 conv with more input channels than K5 takes (a multiple of 32
    beyond ``MAX_CIN``) is not sent to K5: on the CPU it takes the exact
    float64 product, on a card it raises ``NoInt8Kernel`` for the geometry,
    not K5's wrapper error."""
    g = torch.Generator().manual_seed(9)
    cin = k5.MAX_CIN + k5.CHUNK
    x = torch.randint(-127, 128, (1, cin, 5, 4), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (8, cin, 3, 3), generator=g,
                      dtype=torch.int8)
    ws = torch.rand(8, generator=g) * 1e-3
    got = quant.int8_conv2d(x, w, ws, 1, 1)
    want = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)
    assert torch.equal(got, want.to(torch.int32).float()
                       * ws.view(1, -1, 1, 1))

    real = quant._no_kernel
    monkeypatch.setattr(quant, "_no_kernel",
                        lambda xx, *a: real(_on_a_card(xx), *a))
    with pytest.raises(quant.NoInt8Kernel,
                       match=rf"weight \(8, {cin}, 3, 3\)"):
        quant.int8_conv2d(x, w, ws, 1, 1)
