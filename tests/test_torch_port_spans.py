"""The port's spans (``utils/profiling.py::span``, ``SPANS``) on the CPU.

* ``span`` enters no ``record_function`` while no profiler records, and one
  while ``torch.profiler.profile`` runs, also on a thread started inside it;
* ``utils/profiling.trace`` records the host events of every thread;
* ``ServeState.denoise_image`` called from four threads gives one
  ``cid.request`` a call, its five stages nested inside it on its thread and
  in order, and one ``cid.request.to_domain`` (the input's map on the
  device) inside its ``cid.request.upload``; a micro-batched request's
  forward holds the batch's spans;
* the batched dispatch (one device and a mesh) and ``default_fence`` run in
  ``cid.batch.forward`` and ``cid.batch.fence``;
* every name the program enters is in ``SPANS``, and every name of
  ``SPANS`` is entered somewhere in the program; spans change no result.
"""

import json
import os
import pathlib
import re
import threading

import numpy as np
import pytest
import torch

from celebrity_image_denoiser_tpu_torch import parallel
from celebrity_image_denoiser_tpu_torch.serve.batching import default_fence
from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState
from celebrity_image_denoiser_tpu_torch.utils import profiling
from torch_port_threads import _one_torch_thread  # noqa: F401

PACKAGE = pathlib.Path(profiling.__file__).resolve().parents[1]
STAGES = ("cid.request.prepare", "cid.request.upload", "cid.request.forward",
          "cid.request.download", "cid.request.finish")
TO_DOMAIN = "cid.request.to_domain"  # nested in cid.request.upload
TIMEOUT = 60  # seconds for any one thread


def _traced(tmp_path, body):
    """``body()`` inside ``profiling.trace``; its result and the trace's
    complete events whose names start with ``cid.``, by start time."""
    with profiling.trace(str(tmp_path / "t")):
        out = body()
    (f,) = os.listdir(tmp_path / "t")
    events = json.loads((tmp_path / "t" / f).read_text())["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and str(e.get("name", "")).startswith("cid.")),
                   key=lambda e: e["ts"])
    return out, spans


def _inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and child["ts"] >= parent["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def _on_threads(fn, args):
    """``fn(arg)`` for each arg, each on a thread of its own, all started
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


def _images(n, h=20, w=20):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def server():
    return ServeState(device="cpu")


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    def spy(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("cid.request"):
        pass
    assert entered == []
    assert profiling.span("cid.request") is profiling.span("cid.batch.fence")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("cid.request"):
            pass
    assert entered == ["cid.request"]


def test_a_worker_threads_span_is_in_the_trace(tmp_path):
    """A thread started inside ``trace`` records its spans: by default the
    profiler records only the thread that started it."""
    def body():
        t = threading.Thread(target=lambda: profiling.span(
            "cid.request").__enter__().__exit__(None, None, None))
        with profiling.span("cid.batch.fence"):
            t.start()
            t.join(TIMEOUT)
        assert not t.is_alive()

    _, spans = _traced(tmp_path, body)
    by_name = {e["name"]: e for e in spans}
    assert sorted(by_name) == ["cid.batch.fence", "cid.request"]
    assert by_name["cid.request"]["tid"] != by_name["cid.batch.fence"]["tid"]


@pytest.mark.parametrize("model", ["dncnn", "denoise"])
def test_each_request_from_four_threads_has_its_stages_in_order(
        tmp_path, server, model):
    images = _images(4, 22, 18)  # denoise pads to 24 x 20 and crops back
    got, spans = _traced(tmp_path, lambda: _on_threads(
        lambda img: server.denoise_image(img, model), images))
    requests = [e for e in spans if e["name"] == "cid.request"]
    assert len(requests) == 4
    assert len({e["tid"] for e in requests}) == 4
    assert {e["name"] for e in spans} == {"cid.request", TO_DOMAIN, *STAGES}
    for req in requests:
        stages = [e for e in spans if e["name"] in STAGES
                  and _inside(e, req)]
        assert tuple(e["name"] for e in stages) == STAGES
        for a, b in zip(stages, stages[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]
        (to_domain,) = [e for e in spans if e["name"] == TO_DOMAIN
                        and _inside(e, req)]
        assert _inside(to_domain, stages[1])  # the upload
    assert len(spans) == 4 * (2 + len(STAGES))
    # the same answers as without a profiler
    for img, y in zip(images, got):
        np.testing.assert_array_equal(y, server.denoise_image(img, model))


def test_a_micro_batched_requests_forward_holds_the_batch(tmp_path):
    """The leader's forward span holds the batch's dispatch and fence; the
    batch's fence brings every output to the host, so no request has a
    download span."""
    n = 4
    st = ServeState(device="cpu", microbatch_window_ms=60_000.0,
                    microbatch_max=n)
    _, spans = _traced(tmp_path, lambda: _on_threads(
        lambda img: st.denoise_image(img, "denoise"), _images(n)))
    names = [e["name"] for e in spans]
    assert names.count("cid.request") == n
    assert names.count("cid.request.forward") == n
    assert names.count(TO_DOMAIN) == n
    for to_domain in (e for e in spans if e["name"] == TO_DOMAIN):
        assert any(_inside(to_domain, e) for e in spans
                   if e["name"] == "cid.request.upload")
    assert "cid.request.download" not in names
    (fwd,) = [e for e in spans if e["name"] == "cid.batch.forward"]
    (fence,) = [e for e in spans if e["name"] == "cid.batch.fence"]
    (leader,) = [e for e in spans if e["name"] == "cid.request.forward"
                 and _inside(fwd, e)]
    assert _inside(fence, leader)
    assert fwd["ts"] + fwd["dur"] <= fence["ts"]
    assert st.batchers.stats() == {
        str(("denoise", (20, 20, 3))): {"batches": 1, "requests": n}}


@pytest.mark.parametrize("devices", [1, 2])
def test_the_batched_dispatch_and_the_fence_run_in_their_spans(
        tmp_path, devices):
    st = ServeState(device="cpu", mesh=None if devices == 1 else
                    parallel.make_mesh(devices=["cpu"] * devices))
    dispatch = st._batched_dispatch("denoise")
    xs = torch.zeros((3, 16, 16, 3))
    y, spans = _traced(tmp_path, lambda: default_fence(dispatch(xs)))
    assert [e["name"] for e in spans] == ["cid.batch.forward",
                                          "cid.batch.fence"]
    fwd, fence = spans
    assert fwd["tid"] == fence["tid"]
    assert fwd["ts"] + fwd["dur"] <= fence["ts"]
    assert isinstance(y, np.ndarray) and y.shape == (3, 16, 16, 3)
    np.testing.assert_array_equal(y, default_fence(dispatch(xs)))


def test_every_span_the_program_enters_is_named_in_SPANS():
    entered = set()
    for path in PACKAGE.rglob("*.py"):
        entered |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"",
                                  path.read_text()))
    assert entered == set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert all(name.startswith("cid.") for name in profiling.SPANS)
