"""The port's request micro-batching (``serve/batching.py``) and its use by
``ServeState``, on the CPU: the counterparts of the JAX package's
``tests/test_serve.py`` micro-batching tests.

* Concurrent same-shape requests coalesce into one batch, whose responses
  equal the same requests served one at a time (float and int8, bit for
  bit on the CPU);
* a failing chunk fails only its own waiters; a ``BaseException`` in the
  forward marks the waiters failed; a full batch dispatches before the
  window; requests that arrive while the device slot is taken ride the next
  batch together; invalid settings raise at construction;
* each request is labelled in its own thread, also when another thread ran
  its batch; ``warmup`` runs each batch size the batcher can dispatch once;
  ``cli.serve`` passes ``--precompile``, ``--microbatch-ms`` and
  ``--microbatch-max`` through; the kernel launch counter loses no count
  under concurrent launches.

Threads meet at barriers and events, and windows are long enough that a
batch fills before its window ends, so no result depends on the timing of
a loaded machine.
"""

import base64
import concurrent.futures
import threading
import time

import numpy as np
import pytest
import torch

from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.ops.cuda import (
    conv3x3,
    conv3x3_s8,
    convt2x2_s8,
    double_conv,
    noise,
)
from celebrity_image_denoiser_tpu_torch.serve.batching import (
    BatcherPool,
    MicroBatcher,
    _pow2_at_least,
)
from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState
from torch_port_threads import _one_torch_thread  # noqa: F401

LONG_WINDOW_MS = 60_000.0  # a batch that is not full would wait a minute
TIMEOUT = 60  # seconds for any one result


def _png(seed, h=24, w=24):
    rng = np.random.default_rng(seed)
    return imageio.encode_png(rng.integers(0, 256, (h, w, 3), np.uint8))


def _pixels(result):
    return imageio.decode_png(base64.b64decode(
        result["denoised_image_base64"])).astype(np.int16)


def _wait_for(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _concurrently(fn, args):
    """Call ``fn`` on every argument at once (threads released together by
    a barrier); the results, or the exceptions raised, in order."""
    barrier = threading.Barrier(len(args))

    def one(a):
        barrier.wait(timeout=TIMEOUT)
        return fn(a)

    with concurrent.futures.ThreadPoolExecutor(len(args)) as ex:
        futs = [ex.submit(one, a) for a in args]
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=TIMEOUT))
            except BaseException as e:  # noqa: B036 — the outcome itself
                out.append(e)
    return out


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_microbatching_coalesces_and_matches_sequential(quantize):
    n = 6
    pngs = [_png(i) for i in range(n)]
    st_seq = ServeState(device="cpu", quantize=quantize)
    # a full batch (6) dispatches at once; the window is never reached
    st_mb = ServeState(device="cpu", quantize=quantize,
                       microbatch_window_ms=LONG_WINDOW_MS, microbatch_max=n)
    seq = [_pixels(st_seq.enhance("denoise", p, "image/png",
                                  include_graph=False)) for p in pngs]
    mb = _concurrently(lambda p: st_mb.enhance(
        "denoise", p, "image/png", include_graph=False), pngs)
    for a, b in zip(seq, mb):
        np.testing.assert_array_equal(_pixels(b), a)
    assert st_mb.batchers.stats() == {
        str(("denoise", (24, 24, 3))): {"batches": 1, "requests": n}}


def test_pow2_padding_series():
    assert [_pow2_at_least(n, 16) for n in range(1, 18)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 16, 16, 16, 16, 16, 16, 16, 16, 16]
    assert [_pow2_at_least(n, 6) for n in range(1, 8)] == \
        [1, 2, 4, 4, 6, 6, 6]


def test_a_batch_pads_to_a_power_of_two_by_repeating_the_last():
    seen = []

    def fn(xs):
        seen.append(xs.clone())
        return xs * 2.0

    mb = MicroBatcher(fn, window_ms=LONG_WINDOW_MS, max_batch=3)
    xs = [torch.full((1, 2), float(i)) for i in range(3)]
    out = _concurrently(mb, xs)
    assert seen[0].shape[0] == 3  # the cap itself, not 4
    for i, y in enumerate(out):
        assert float(y[0, 0]) == 2.0 * i

    seen.clear()
    mb = MicroBatcher(fn, window_ms=0.0, max_batch=8,
                      slot=threading.BoundedSemaphore(1))
    mb.slot.acquire()  # hold the device: three requests pile up
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(mb, x) for x in xs]
        _wait_for(lambda: len(mb.pending) == 3, "three pending requests")
        mb.slot.release()
        out = [f.result(timeout=TIMEOUT) for f in futs]
    assert seen[0].shape[0] == 4  # 3 requests, padded to 4
    assert float(seen[0][3, 0]) == float(seen[0][2, 0])
    assert sorted(float(y[0, 0]) for y in out) == [0.0, 2.0, 4.0]


def test_microbatch_chunk_error_isolated():
    """A failure in a later chunk does not poison the earlier chunk's
    results."""
    calls = []

    def fn(xs):
        calls.append(xs.shape[0])
        if len(calls) > 1:  # the second chunk fails
            raise RuntimeError("boom")
        return xs * 2.0

    mb = MicroBatcher(fn, window_ms=0.0, max_batch=4,
                      slot=threading.BoundedSemaphore(1))
    xs = [torch.full((1, 2), float(i)) for i in range(6)]
    mb.slot.acquire()  # all six queue behind the held slot: one drain
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        futs = [ex.submit(mb, x) for x in xs]
        _wait_for(lambda: len(mb.pending) == 6, "six pending requests")
        mb.slot.release()
        ok, failed = 0, 0
        for i, f in enumerate(futs):
            try:
                assert float(f.result(timeout=TIMEOUT)[0, 0]) == 2.0 * i
                ok += 1
            except RuntimeError as e:
                assert "boom" in str(e)
                failed += 1
    assert calls == [4, 2]
    assert (ok, failed) == (4, 2)
    assert mb.batches_run == 1 and mb.requests_served == 4


@pytest.mark.parametrize("cls, kw", [
    (MicroBatcher, {"fn": lambda x: x, "window_ms": -1}),
    (MicroBatcher, {"fn": lambda x: x, "window_ms": float("nan")}),
    (MicroBatcher, {"fn": lambda x: x, "max_batch": 0}),
    (BatcherPool, {"window_ms": -1}),
    (BatcherPool, {"window_ms": 1, "max_batch": 0}),
    (BatcherPool, {"window_ms": 1, "max_inflight": 0}),
], ids=["window", "window_nan", "max_batch", "pool_window",
        "pool_max_batch", "pool_inflight"])
def test_config_validation(cls, kw):
    with pytest.raises(ValueError):
        cls(**kw)


def test_serve_state_validates_microbatching_at_construction():
    with pytest.raises(ValueError, match="max_batch"):
        ServeState(device="cpu", microbatch_window_ms=2, microbatch_max=0)


def test_full_batch_dispatches_before_the_window():
    """Four requests with max_batch 4 run at once; the one-minute window
    would outlast the result timeout."""
    mb = MicroBatcher(lambda xs: xs * 2.0, window_ms=LONG_WINDOW_MS,
                      max_batch=4)
    xs = [torch.full((1, 2), float(i)) for i in range(4)]
    out = _concurrently(mb, xs)
    for i, y in enumerate(out):
        assert float(y[0, 0]) == 2.0 * i
    assert mb.batches_run == 1


def test_backpressure_coalesces_under_saturation():
    """While a batch runs (the shared slot taken), arrivals pile up and ride
    the next leader's batch together: the batch size follows the load, not
    the window."""
    running, release = threading.Event(), threading.Event()
    calls = []

    def fn(xs):
        calls.append(xs.shape[0])
        if len(calls) == 1:
            running.set()
            assert release.wait(TIMEOUT)
        return xs * 2.0

    mb = MicroBatcher(fn, window_ms=0.0, max_batch=16,
                      slot=threading.BoundedSemaphore(1))
    xs = [torch.full((1, 2), float(i)) for i in range(9)]
    with concurrent.futures.ThreadPoolExecutor(9) as ex:
        first = ex.submit(mb, xs[0])
        assert running.wait(TIMEOUT)
        rest = [ex.submit(mb, x) for x in xs[1:]]
        _wait_for(lambda: len(mb.pending) == 8, "eight pending requests")
        release.set()
        out = [first.result(timeout=TIMEOUT)] + [
            f.result(timeout=TIMEOUT) for f in rest]
    for i, y in enumerate(out):
        assert float(y[0, 0]) == 2.0 * i
    assert calls == [1, 8]
    assert mb.batches_run == 2 and mb.requests_served == 9


def test_base_exception_marks_waiters_failed():
    """A ``BaseException`` in the forward wakes the followers with a
    ``RuntimeError`` (not a ``KeyError``); the leader re-raises it."""
    class _Abort(BaseException):
        pass

    def fn(xs):
        raise _Abort()

    mb = MicroBatcher(fn, window_ms=LONG_WINDOW_MS, max_batch=3)
    out = _concurrently(mb, [torch.full((1, 2), float(i)) for i in range(3)])
    kinds = sorted(type(o).__name__ for o in out)
    assert kinds == ["RuntimeError", "RuntimeError", "_Abort"]


def test_default_fence_copies_the_batch_to_the_host():
    from celebrity_image_denoiser_tpu_torch.serve.batching import (
        default_fence,
    )

    y = default_fence(torch.arange(6, dtype=torch.uint8).reshape(2, 3))
    assert isinstance(y, np.ndarray) and y.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert default_fence([1, 2]) == [1, 2]


def test_pool_keys_batchers_by_shape_and_shares_the_slot():
    pool = BatcherPool(2.0, max_batch=4)
    a = pool.get(("denoise", (8, 8, 3)), lambda xs: xs)
    assert pool.get(("denoise", (8, 8, 3)), None) is a
    b = pool.get(("denoise", (16, 8, 3)), lambda xs: xs)
    assert b is not a and a.slot is b.slot and a.fence is b.fence
    a(torch.zeros(1, 8, 8, 3))
    assert pool.stats() == {
        str(("denoise", (8, 8, 3))): {"batches": 1, "requests": 1},
        str(("denoise", (16, 8, 3))): {"batches": 0, "requests": 0}}


@pytest.mark.parametrize("quantize, label", [(None, "float"),
                                             ("int8", "int8")])
def test_each_request_is_labelled_in_its_own_thread(quantize, label):
    """The leader runs the batch for its followers; every requester still
    reads its own label, and the stats count each request once."""
    n = 4
    st = ServeState(device="cpu", quantize=quantize,
                    microbatch_window_ms=LONG_WINDOW_MS, microbatch_max=n)

    def one(p):
        st.enhance("denoise", p, "image/png", include_graph=False)
        return st.last_compute_backend()

    assert _concurrently(one, [_png(i) for i in range(n)]) == [label] * n
    assert st.stats.snapshot()["compute_backends"] == {label: n}
    assert st.last_compute_backend() == "n/a"  # this thread served nothing


def test_big_inputs_are_tiled_not_batched():
    st = ServeState(device="cpu", tile_threshold_rows=32,
                    microbatch_window_ms=LONG_WINDOW_MS, microbatch_max=4)
    st.enhance("denoise", _png(0, 40, 20), "image/png", include_graph=False)
    assert st.last_compute_backend() == "float+tiled"
    assert st.batchers.stats() == {}


def _recording(st):
    """Record the batch size of every forward ``st`` runs."""
    sizes = []
    apply = st._apply

    def recording_apply(name, route):
        fn = apply(name, route)

        def run(x):
            sizes.append(x.shape[0])
            return fn(x)
        return run

    st._apply = recording_apply
    return sizes


def test_warmup_runs_each_batch_size_once_then_serves():
    st = ServeState(device="cpu", microbatch_window_ms=1.0, microbatch_max=6)
    sizes = _recording(st)
    st.warmup(((22, 24),), models=("denoise",))  # padded to 24 x 24
    # batch 1 through the batcher, then the pow2 series with the cap
    assert sizes == [1, 2, 4, 6]
    assert st.batchers.stats() == {
        str(("denoise", (24, 24, 3))): {"batches": 1, "requests": 1}}
    r = st.enhance("denoise", _png(3, 22, 24), "image/png",
                   include_graph=False)
    assert _pixels(r).shape == (22, 24, 3)
    assert st.last_compute_backend() == "float"


def test_warmup_of_a_big_size_runs_its_tiles_and_no_batches():
    st = ServeState(device="cpu", tile_threshold_rows=32,
                    microbatch_window_ms=1.0, microbatch_max=4)
    sizes = _recording(st)
    st.warmup(((70, 20),), models=("denoise",))  # 72 x 20: 32-row tiles
    assert sizes == [1, 1, 1]
    assert st.batchers.stats() == {}


def test_warmup_without_microbatching_runs_batch_1():
    st = ServeState(device="cpu")
    sizes = _recording(st)
    st.warmup(((16, 16), (8, 12)), models=("denoise",))
    assert sizes == [1, 1]


def test_warmup_covers_every_family_by_default():
    """As the JAX ``warmup(models=None)``: every family at its forward's
    shape (cgan: its Keras generator), dncnn and esrgan unpadded, srgan
    padded to 16, and restormer, which only the port serves, padded to 8."""
    st = ServeState(device="cpu")
    shapes = []
    apply = st._apply

    def recording_apply(name, route):
        fn = apply(name, route)

        def run(x):
            shapes.append((name, tuple(x.shape)))
            return fn(x)
        return run

    st._apply = recording_apply
    st.warmup(((10, 14),))
    assert shapes == [("denoise", (1, 12, 16, 3)),
                      ("cgan:keras", (1, 12, 16, 3)), ("srgan", (1, 16, 16, 3)),
                      ("esrgan", (1, 10, 14, 3)), ("dncnn", (1, 10, 14, 3)),
                      ("restormer", (1, 16, 16, 3))]


def test_cli_serve_microbatching_and_precompile_flags(monkeypatch):
    from celebrity_image_denoiser_tpu_torch.cli import serve
    from celebrity_image_denoiser_tpu_torch.serve import app

    args = serve.build_parser().parse_args([])
    assert (args.precompile, args.microbatch_ms, args.microbatch_max) == \
        (None, None, 16)
    got = {}

    def run_server(host, port, state, precompile=None):
        got.update(state=state, precompile=precompile, port=port)

    monkeypatch.setattr(app, "run_server", run_server)
    assert serve.main(["--device", "cpu", "--quantize", "off", "--port", "0",
                       "--precompile", "256x256, 64x32,",
                       "--microbatch-ms", "2.5", "--microbatch-max", "8",
                       "--tile-threshold-rows", "512"]) == 0
    st = got["state"]
    assert got["precompile"] == [(256, 256), (64, 32)]
    assert st.batchers.window_ms == 2.5 and st.batchers.max_batch == 8
    assert st.tile_threshold_rows == 512 and st.quantize is None
    serve.main(["--device", "cpu", "--quantize", "off"])
    assert got["state"].batchers is None and got["precompile"] is None
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--precompile", "256by256"])


def test_run_server_warms_the_sizes_first(monkeypatch):
    from celebrity_image_denoiser_tpu_torch.serve import app

    calls = []

    class FakeState:
        device = "cpu"

        def warmup(self, sizes):
            calls.append(("warmup", sizes))

    class FakeServer:
        def serve_forever(self):
            calls.append(("serve",))

        def server_close(self):
            calls.append(("close",))

    monkeypatch.setattr(app, "make_server",
                        lambda host, port, state: FakeServer())
    app.run_server("127.0.0.1", 0, FakeState(), precompile=[(64, 64)])
    assert calls == [("warmup", ((64, 64),)), ("serve",), ("close",)]


def test_launch_counter_loses_no_count_under_threads():
    """Every kernel wrapper adds to its launch counter inside the block that
    holds ``_build.LAUNCH_LOCK``, so request threads launching at once lose
    no count (a bare ``+= 1`` outside it can).  The launching branch needs a
    CUDA tensor, so this reads the wrappers' source."""
    import ast
    import inspect

    def holds_lock(with_node):
        return any(isinstance(it.context_expr, ast.Attribute)
                   and it.context_expr.attr == "LAUNCH_LOCK"
                   and getattr(it.context_expr.value, "id", "") == "_build"
                   for it in with_node.items)

    def counts(node, locked):
        """(locked, unlocked) counter increments under ``node``."""
        if isinstance(node, ast.AugAssign) and \
                getattr(node.target, "id", "").endswith("LAUNCHES"):
            return (1, 0) if locked else (0, 1)
        locked = locked or (isinstance(node, ast.With) and holds_lock(node))
        total = (0, 0)
        for child in ast.iter_child_nodes(node):
            total = tuple(a + b for a, b in zip(total, counts(child, locked)))
        return total

    found = {}
    for mod in (conv3x3, double_conv, conv3x3_s8, convt2x2_s8, noise):
        found[mod.__name__.rsplit(".", 1)[1]] = counts(
            ast.parse(inspect.getsource(mod)), False)
    assert found == {"conv3x3": (2, 0), "double_conv": (1, 0),
                     "conv3x3_s8": (1, 0), "convt2x2_s8": (1, 0),
                     "noise": (2, 0)}, found

