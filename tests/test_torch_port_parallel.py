"""The port's serving mesh (``parallel/{mesh,dataparallel,tiling}.py``) and
the server's mesh routes (``ServeState(mesh=, use_tiling=,
bucket_divisor=)``), against the JAX package on the CPU.

A serving mesh is one process over several devices; here every entry is the
CPU (``make_mesh(devices=["cpu"] * n)``), the counterpart of the JAX tests'
8 virtual CPU devices (``tests/conftest.py``).

* ``make_mesh``: shapes, axis names, repeats and the JAX function's errors.
* ``data_parallel_apply`` over 4 entries against JAX's on the 8-device
  mesh, rtol/atol 1e-5 (f32: oneDNN's convs against XLA's).
* ``spatial_sharded_apply`` bit-equal to the port's own untiled forward:
  the height and the width of a denoise input (1×256×64), srgan ×4, a
  height whose share per device is not a multiple of 4 (strips of unequal
  height), dncnn without pooling, and the int8 s8 program; within 1e-5 of
  JAX's ``spatial_sharded_apply`` on the same weights.
* ``tiled_apply`` against JAX's at halo 32 over 8 shards on the whole
  output, the border band included, rtol/atol 1e-5; at halo 4 it differs
  from the full forward; its errors.
* The server: the routing of inputs over the threshold follows the JAX
  server's rule (its ``_dispatch_forward`` run with the forwards stubbed);
  a sharded request equals the mesh-free server's bytes, float and int8;
  ``use_tiling=False`` shards the height; micro-batched requests over the
  mesh equal the same requests served alone; ``warmup`` warms the
  data-parallel dispatch; ``bucket_divisor=64`` within the serve tolerance
  of JAX's ``ServeState(bucket_divisor=64)`` (≤ 1 count, ≥ 99.5% equal).
* ``cli.serve --spatial-shard``: a mesh over every card, the JAX warning
  with one device.
"""

import base64
import collections
import concurrent.futures
import logging
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from celebrity_image_denoiser_tpu import models as jax_models
from celebrity_image_denoiser_tpu import parallel as jax_parallel
from celebrity_image_denoiser_tpu.serve.handlers import ServeState as JaxState
from celebrity_image_denoiser_tpu_torch import parallel
from celebrity_image_denoiser_tpu_torch.ckpt.convert import (
    state_dict_to_jax_params,
)
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    calibration_batch,
)
from celebrity_image_denoiser_tpu_torch.models import registry
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.ops import quant_unet
from celebrity_image_denoiser_tpu_torch.parallel.tiling import strip_bounds
from celebrity_image_denoiser_tpu_torch.serve import handlers
from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

THRESHOLD = 64
TIMEOUT = 60


@pytest.fixture(scope="module")
def weights():
    """A random denoise U-Net made by the port, eval mode, and the same
    weights as a JAX tree."""
    port = DenoiseGenerator(generator=torch.Generator().manual_seed(0)).eval()
    params, _ = state_dict_to_jax_params(port.state_dict())
    return port, params


def _cpu_mesh(n=4, **kw):
    return parallel.make_mesh(devices=["cpu"] * n, **kw)


def _nhwc(model, x):
    with torch.inference_mode():
        return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _x(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _run(fn, x):
    """A mesh forward of numpy ``x``, inference mode."""
    with torch.inference_mode():
        return fn(torch.from_numpy(x))


# ---------------------------------------------------------------------------
# the mesh
def test_make_mesh_shapes_and_errors():
    mesh = _cpu_mesh(8)
    assert mesh.shape["data"] == 8 and mesh.size == 8
    assert mesh.axis_devices() == [torch.device("cpu")] * 8
    two = parallel.make_mesh((2, 4), ("replica", "data"),
                             devices=["cpu"] * 8)
    assert two.shape == {"replica": 2, "data": 4}
    assert len(two.axis_devices("data")) == 4
    assert len(two.axis_devices("replica")) == 2
    # the first prod(shape) devices, as JAX's make_mesh
    assert parallel.make_mesh((3,), devices=["cpu"] * 8).shape["data"] == 3
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        parallel.make_mesh((16,), devices=["cpu"] * 8)
    if not torch.cuda.is_available():  # no quiet fallback onto the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()


def test_shard_batch_and_replicate():
    mesh = _cpu_mesh(4)
    chunks = parallel.shard_batch(torch.arange(8.0).view(8, 1), mesh)
    assert [c.flatten().tolist() for c in chunks] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_batch(torch.zeros(6, 1), mesh)
    m = torch.nn.Linear(2, 2)
    reps = parallel.replicate(m, mesh)
    assert len(reps) == 4 and len({id(r) for r in reps} | {id(m)}) == 5
    for r in reps:
        assert torch.equal(r.weight, m.weight)
        assert r.weight.data_ptr() != m.weight.data_ptr()
    # the module's own device: its first entry there takes the module
    reps = parallel.replicate(m, mesh, home=torch.device("cpu"))
    assert reps[0] is m and len({id(r) for r in reps}) == 4


def test_data_parallel_apply_matches_jax(weights):
    port, params = weights
    x = _x((16, 32, 32, 3))
    y = _run(parallel.data_parallel_apply(port, _cpu_mesh(4)), x)
    y_single = _nhwc(port, torch.from_numpy(x))
    assert torch.equal(y, y_single)
    jmesh = jax_parallel.make_mesh()
    assert jmesh.shape["data"] == 8
    jfn = jax_parallel.data_parallel_apply(jax_models.DenoiseGenerator(),
                                           jmesh)
    y_jax = jfn(jax_parallel.replicate(params, jmesh),
                jax_parallel.replicate({}, jmesh),
                jax_parallel.shard_batch(jnp.asarray(x), jmesh))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# spatial sharding
def _int8_program(port):
    calib = calibration_batch(True, 32, generator=torch.Generator()
                              .manual_seed(1))
    return quant_unet.quantize_apply_denoise_unet(port, calib)


SHARD_CASES = {
    # (model, input shape, spatial_dim, scale, multiple)
    "height": ("denoise", (1, 256, 64, 3), 1, 1, 4),
    "width": ("denoise", (1, 64, 256, 3), 2, 1, 4),
    "srgan_x4": ("srgan", (1, 64, 32, 3), 1, 4, 4),
    "unequal_strips": ("denoise", (1, 260, 40, 3), 1, 1, 4),
    "dncnn_no_pool": ("dncnn", (1, 66, 30, 3), 1, 1, 1),
    "int8": ("int8", (1, 96, 40, 3), 1, 1, 4),
}


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_spatial_sharded_apply_is_bit_equal_to_the_untiled_forward(
        weights, case):
    """Each strip runs with 32 rows of true context and is cropped: the
    single-device tiler's arithmetic over devices, so every value equals
    the untiled forward's.  260 rows over 4 devices are 65 a device, off
    the U-Net's 2×2-pool grid: the strips are cut at multiples of 4
    (64, 64, 64, 68)."""
    name, shape, dim, scale, multiple = SHARD_CASES[case]
    x = torch.from_numpy(_x(shape, seed=len(case)))
    if name == "int8":
        model = _int8_program(weights[0])

        def fwd(m, t):
            return m(t)
    else:
        model = (weights[0] if name == "denoise" else registry.build_generator(
            name, generator=torch.Generator().manual_seed(3)).eval())
        fwd = None
    if case == "unequal_strips":
        assert strip_bounds(260, 4, 4) == [0, 64, 128, 192, 260]
    fn = parallel.spatial_sharded_apply(model, _cpu_mesh(4), spatial_dim=dim,
                                        apply_fn=fwd, scale=scale,
                                        multiple=multiple)
    with torch.inference_mode():
        y = fn(x)
        ref = model(x) if fwd else _nhwc(model, x)
    assert y.shape == ref.shape
    assert torch.equal(y, ref), (y - ref).abs().max()


def test_spatial_sharded_apply_matches_jax(weights):
    port, params = weights
    x = _x((1, 256, 64, 3), seed=5)
    y = _run(parallel.spatial_sharded_apply(port, _cpu_mesh(8)), x)
    jmesh = jax_parallel.make_mesh()
    fn = jax_parallel.spatial_sharded_apply(jax_models.DenoiseGenerator(),
                                            jmesh)
    repl = jax_parallel.replicated(jmesh)
    hsh = NamedSharding(jmesh, P(None, "data", None, None))
    y_jax = fn(jax.device_put(params, repl), jax.device_put({}, repl),
               jax.device_put(jnp.asarray(x), hsh))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=1e-5,
                               atol=1e-5)


def test_spatial_sharded_apply_validation(weights):
    mesh = _cpu_mesh(4)
    with pytest.raises(ValueError, match="spatial_dim"):
        parallel.spatial_sharded_apply(weights[0], mesh, spatial_dim=3)
    with pytest.raises(ValueError, match="divisible by 4"):
        parallel.spatial_sharded_apply(weights[0], mesh)(
            torch.zeros(1, 66, 16, 3))
    with pytest.raises(ValueError, match="too small"):
        parallel.spatial_sharded_apply(weights[0], mesh)(
            torch.zeros(1, 12, 16, 3))


# ---------------------------------------------------------------------------
# halo tiling
def test_tiled_apply_matches_jax_on_the_whole_output(weights):
    """One exchange of 32 rows, zeros at the image's top and bottom: the
    whole output, border band included, within 1e-5 of JAX's; the interior
    equals the full forward's and the border band deviates from it as
    JAX's does (< 0.1)."""
    port, params = weights
    x = _x((1, 256, 64, 3), seed=6)
    y = _run(parallel.tiled_apply(port, _cpu_mesh(8), halo=32), x)
    y_jax = jax_parallel.tiled_apply(jax_models.DenoiseGenerator(), params,
                                     {}, jax_parallel.make_mesh(), halo=32)(
        jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=1e-5,
                               atol=1e-5)
    full = _nhwc(port, torch.from_numpy(x))
    d = (y - full).abs()
    assert float(d[:, 28:-28].max()) <= 1e-5 and float(d.max()) < 0.1


def test_tiled_apply_too_small_a_halo_differs(weights):
    port, _ = weights
    x = _x((1, 256, 64, 3), seed=7)
    y = _run(parallel.tiled_apply(port, _cpu_mesh(8), halo=4), x)
    assert float((y - _nhwc(port, torch.from_numpy(x))).abs().max()) > 1e-4


def test_tiled_apply_validation(weights):
    port, _ = weights
    with pytest.raises(ValueError, match="halo must be divisible by 4"):
        parallel.tiled_apply(port, _cpu_mesh(4), halo=6)
    fn = parallel.tiled_apply(port, _cpu_mesh(4), halo=32)
    with pytest.raises(ValueError, match="n_shards\\*4=16"):
        fn(torch.zeros(1, 100, 16, 3))
    with pytest.raises(ValueError, match="< halo 32"):
        fn(torch.zeros(1, 64, 16, 3))


# ---------------------------------------------------------------------------
# the server
def _jax_route(shape, n_dev, use_tiling, monkeypatch):
    """The JAX server's label for an input of ``shape`` (its
    ``_dispatch_forward``, with the sharded, tiled and whole forwards
    stubbed: only the routing runs)."""
    from celebrity_image_denoiser_tpu.parallel import tiling as jtiling

    monkeypatch.setattr(jtiling, "spatial_sharded_apply",
                        lambda *a, **k: (lambda p, s, x: x))
    monkeypatch.setattr(jtiling, "tiled_apply_single_device",
                        lambda *a, **k: (lambda x: x))
    st = JaxState.__new__(JaxState)
    st.tile_threshold_rows, st.use_tiling = THRESHOLD, use_tiling
    st.mesh = jax_parallel.make_mesh(devices=jax.devices()[:n_dev])
    st.batchers = None
    st._fns = {"denoise": lambda p, s, x: x, ("qapply", "denoise"): None}
    st._build_locks = collections.defaultdict(threading.Lock)
    st._build_locks_guard = threading.Lock()
    st._path_note = threading.local()
    st._dispatch_forward("denoise", None, None, None, np.zeros(shape),
                         False)
    return st.last_compute_backend()


# (H, W) of the forward's input: over on one axis, on both, an extent that
# is not a device multiple
ROUTE_SHAPES = [(128, 40), (40, 128), (128, 128), (132, 40), (40, 130),
                (130, 132), (130, 40), (40, 40), (66, 130)]


@pytest.mark.parametrize("use_tiling", [True, False])
def test_routing_follows_the_jax_rule(use_tiling, monkeypatch):
    st = ServeState(device="cpu", mesh=_cpu_mesh(4), use_tiling=use_tiling,
                    tile_threshold_rows=THRESHOLD)
    seen = set()
    for hw in ROUTE_SHAPES:
        shape = (1, *hw, 3)
        big, _ = st._big_route(shape)
        got = "float" + ("" if big is None else "+" + big)
        assert got == _jax_route(shape, 4, use_tiling, monkeypatch), hw
        seen.add(got)
    assert "float+sharded" in seen
    if use_tiling:
        assert seen == {"float", "float+sharded", "float+tiled"}
    else:  # the height shards when both axes are over
        assert st._big_route((1, 128, 128, 3)) == ("sharded", 1)
    # one device: never sharded, as the JAX rule (n_dev > 1)
    one = ServeState(device="cpu", mesh=_cpu_mesh(1),
                     tile_threshold_rows=THRESHOLD)
    assert one._big_route((1, 128, 40, 3)) == ("tiled", None)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([120 + 80 * np.sin(xx / 5.0), 100 + 60 * np.cos(yy / 7.0),
                     90 + 50 * np.sin((xx + yy) / 9.0)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(
        np.uint8)


def _served(st, img, model="denoise"):
    r = st.enhance(model, imageio.encode_png(img), "image/png",
                   include_graph=False)
    return imageio.decode_png(base64.b64decode(r["denoised_image_base64"]))


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_sharded_requests_equal_the_mesh_free_server(quantize):
    """Over the threshold with a mesh of 4: tall and wide inputs are served
    sharded (labelled so), both axes tiled; every response equals the
    mesh-free server's, byte for byte; ``use_tiling=False`` shards the
    height of an input over on both axes; esrgan (unpadded, no pooling)
    shards too (in float: its int8 ladder takes 17 s to build here)."""
    mesh = _cpu_mesh(4)
    kind = quantize or "float"
    st = ServeState(device="cpu", quantize=quantize, mesh=mesh,
                    tile_threshold_rows=THRESHOLD)
    no_tiling = ServeState(device="cpu", quantize=quantize, mesh=mesh,
                           tile_threshold_rows=THRESHOLD, use_tiling=False)
    ref = ServeState(device="cpu", quantize=quantize)
    for (h, w), server, label, model in (
            ((99, 37), st, "sharded", "denoise"),
            ((37, 99), st, "sharded", "denoise"),
            ((99, 99), st, "tiled", "denoise"),
            ((99, 99), no_tiling, "sharded", "denoise"),
            ((100, 30), st, "sharded", "esrgan")):
        if quantize and model == "esrgan":
            continue
        img = _image(h, w, seed=h + w)
        out = _served(server, img, model)
        assert server.last_compute_backend() == f"{kind}+{label}", (h, w)
        want = _served(ref, img, model)
        assert ref.last_compute_backend() == kind
        np.testing.assert_array_equal(out, want, err_msg=f"{model} {h}x{w}")
    # one replica list per served object, shared by every mesh path; the
    # entry on the server's own device is the served object itself
    for server in (st, no_tiling):
        for (name, kind_of), reps in server._replicas.items():
            obj = server._served(name, "kernel")[0]
            assert kind_of == ("float" if obj is server._model(name)
                               else "int8")
            assert len(reps) == 4 and reps[0] is obj
            assert len({id(r) for r in reps}) == 4
    assert set(no_tiling._replicas) == {("denoise", kind)}
    assert set(st._replicas) == {("denoise", kind)} | (
        set() if quantize else {("esrgan", "float")})


def _concurrently(fn, args):
    barrier = threading.Barrier(len(args))

    def one(a):
        barrier.wait(timeout=TIMEOUT)
        return fn(a)

    with concurrent.futures.ThreadPoolExecutor(len(args)) as ex:
        return [f.result(timeout=TIMEOUT)
                for f in [ex.submit(one, a) for a in args]]


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_microbatches_over_the_mesh_equal_requests_served_alone(quantize):
    """Six concurrent requests coalesce into one batch, padded to 8 by
    repeating the last row and split over 4 devices: each response equals
    the same request served alone, byte for byte."""
    n = 6
    imgs = [_image(24, 24, seed=i) for i in range(n)]
    st = ServeState(device="cpu", quantize=quantize, mesh=_cpu_mesh(4),
                    microbatch_window_ms=60_000.0, microbatch_max=n)
    alone = ServeState(device="cpu", quantize=quantize)
    got = _concurrently(lambda img: _served(st, img), imgs)
    for img, out in zip(imgs, got):
        np.testing.assert_array_equal(out, _served(alone, img))
    assert st.batchers.stats() == {
        str(("denoise", (24, 24, 3))): {"batches": 1, "requests": n}}
    assert [name for name, _ in st._replicas] == ["denoise"]


def test_dp_dispatch_pads_to_a_device_multiple_and_crops(weights,
                                                         monkeypatch):
    st = ServeState(device="cpu", mesh=_cpu_mesh(4))
    seen = []
    build = handlers.data_parallel_apply

    def spy(*args, **kwargs):
        dp = build(*args, **kwargs)
        return lambda xs: (seen.append(xs.shape[0]), dp(xs))[1]

    monkeypatch.setattr(handlers, "data_parallel_apply", spy)
    dispatch = st._batched_dispatch("denoise")
    xs = torch.from_numpy(_x((5, 16, 16, 3)))
    y = dispatch(xs)
    assert seen == [8] and y.shape == (5, 16, 16, 3) and y.dtype == torch.uint8
    with torch.inference_mode():
        want = st._to_u8("denoise", _nhwc(st.models["denoise"], xs))
    assert torch.equal(y, want)


def test_warmup_warms_the_data_parallel_dispatch():
    st = ServeState(device="cpu", mesh=_cpu_mesh(4),
                    microbatch_window_ms=5.0, microbatch_max=4)
    st.warmup(((16, 16),), models=("denoise",))
    assert set(st._replicas) == {("denoise", "float")}


def test_bucket_divisor_matches_the_jax_server():
    """``bucket_divisor=64``: a 70×50 upload runs padded to 128×64 in both
    servers, and the responses agree within the serve tolerance."""
    st = ServeState(device="cpu", bucket_divisor=64)
    assert st._input_shape("denoise", 70, 50) == (128, 64)
    jst = JaxState(quantize=None, bucket_divisor=64)
    img = _image(70, 50, seed=9)
    out, want = _served(st, img), _served(jst, img)
    d = np.abs(out.astype(np.int16) - want.astype(np.int16))
    assert out.shape == (70, 50, 3)
    assert d.max() <= 1 and np.mean(d == 0) >= 0.995, (d.max(),
                                                       np.mean(d == 0))
    seen = []
    hook = st.models["denoise"].register_forward_pre_hook(
        lambda m, a: seen.append(tuple(a[0].shape[2:])))
    try:
        st.warmup(((70, 50),), models=("denoise",))
    finally:
        hook.remove()
    assert seen == [(128, 64)]


def test_cli_serve_spatial_shard(monkeypatch, caplog):
    from celebrity_image_denoiser_tpu_torch.cli import serve

    args = serve.build_parser().parse_args(["--spatial-shard", "--device",
                                            "cpu"])
    with caplog.at_level(logging.WARNING, logger="cid_torch.serve"):
        assert serve.build_mesh(args) is None
    assert "only 1 device is visible" in caplog.text
    assert serve.build_mesh(serve.build_parser().parse_args([])) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = serve.build_mesh(serve.build_parser().parse_args(
        ["--spatial-shard"]))
    assert mesh.shape["data"] == 4
    assert [str(d) for d in mesh.devices.flat] == [f"cuda:{i}"
                                                  for i in range(4)]
