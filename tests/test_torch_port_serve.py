"""The port's ``/enhance`` server against the JAX server, and its PNG codec.

Both servers run on 127.0.0.1 with ephemeral ports and the shipped weights:
the JAX ``ServeState(quantize=None)`` (the float configuration this slice
ports) and the port's ``ServeState(device="cpu")``.  The same PNG goes to
both; the decoded pixels may differ by at most 1 count (the float forward
is truncated to uint8, so f32 noise can flip a value sitting on an integer)
and at least 99.5% must be identical.  The error contract (unknown model,
non-image upload, malformed multipart) must give the same statuses.

The PNG codec of ``data/imageio.py`` is held against Pillow here: it must
decode what Pillow writes (RGB, RGBA, L, LA) and every one of the five row
filters, and round-trip its own output.
"""

import base64
import io
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from celebrity_image_denoiser_tpu.serve.app import make_server as jax_make_server
from celebrity_image_denoiser_tpu.serve.handlers import ServeState as JaxState
from celebrity_image_denoiser_tpu_torch.ckpt.convert import load_npz_state_dict
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.serve.app import make_server
from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState
from torch_port_threads import _one_torch_thread  # noqa: F401

BOUNDARY = "portparityboundary"


def _serve(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}", t


@pytest.fixture(scope="module")
def servers():
    jax_srv = jax_make_server("127.0.0.1", 0, state=JaxState(quantize=None))
    port_srv = make_server("127.0.0.1", 0, state=ServeState(device="cpu"))
    urls = []
    threads = []
    for srv in (jax_srv, port_srv):
        url, t = _serve(srv)
        urls.append(url)
        threads.append(t)
    yield {"jax": urls[0], "port": urls[1], "port_state": port_srv.state}
    for srv, t in zip((jax_srv, port_srv), threads):
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


def _multipart(png: bytes, content_type="image/png") -> bytes:
    return (f"--{BOUNDARY}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"x.png\"\r\nContent-Type: {content_type}\r\n\r\n"
            ).encode() + png + f"\r\n--{BOUNDARY}--\r\n".encode()


def _post(base, query, body, ctype=f"multipart/form-data; boundary={BOUNDARY}"):
    req = urllib.request.Request(f"{base}/enhance?{query}", data=body,
                                 method="POST",
                                 headers={"Content-Type": ctype})
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


@pytest.mark.parametrize("hw", [(40, 48), (26, 30)],
                         ids=["48x40", "30x26_pad_crop"])
def test_enhance_matches_jax_server(servers, hw):
    img = _image(*hw, seed=hw[0])
    body = _multipart(imageio.encode_png(img))
    out = {}
    for name in ("jax", "port"):
        status, payload = _post(servers[name], "model=denoise&graphs=false",
                                body)
        assert status == 200, payload
        assert set(payload) == {"denoised_image_base64",
                                "noise_graph_base64", "backend"}
        assert payload["backend"] == "torch"
        out[name] = imageio.decode_png(
            base64.b64decode(payload["denoised_image_base64"]))
    assert out["port"].shape == out["jax"].shape == img.shape
    diff = np.abs(out["port"].astype(np.int16) - out["jax"].astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert np.mean(diff == 0) >= 0.995, np.mean(diff == 0)


def test_model_name_is_case_insensitive_and_graph_renders(servers):
    body = _multipart(imageio.encode_png(_image(24, 20, seed=5)))
    status, payload = _post(servers["port"], "model=DeNoise", body)
    assert status == 200, payload
    graph = imageio.decode_png(base64.b64decode(payload["noise_graph_base64"]))
    assert graph.shape[2] == 3 and graph.shape[0] > 100


_PNG = imageio.encode_png(np.zeros((8, 8, 3), np.uint8))


@pytest.mark.parametrize("query, body, ctype", [
    ("model=nosuchmodel", _multipart(_PNG), None),
    ("model=denoise", _multipart(b"plain text", "text/plain"), None),
    ("model=denoise", _multipart(_PNG)[:-10], None),             # truncated
    ("model=denoise", _multipart(_PNG), "application/json"),
    ("model=denoise", _multipart(b"not an image at all"), None),  # 500
], ids=["unknown_model", "non_image", "malformed_multipart",
        "not_multipart", "undecodable"])
def test_error_contract_matches_jax(servers, query, body, ctype):
    kw = {} if ctype is None else {"ctype": ctype}
    s_jax, p_jax = _post(servers["jax"], query, body, **kw)
    s_port, p_port = _post(servers["port"], query, body, **kw)
    assert s_port == s_jax and s_port in (400, 500)
    assert set(p_port) == {"detail"}


def test_unknown_model_lists_the_served_families(servers):
    """An unknown model's 400 lists the five families the port serves, as
    the JAX server's does; cgan is one of them (its Keras backend)."""
    status, payload = _post(servers["port"], "model=vdsr", _multipart(_PNG))
    assert status == 400
    for family in ("denoise", "cgan", "srgan", "esrgan", "dncnn"):
        assert f"'{family}'" in payload["detail"], payload["detail"]
    status, payload = _post(servers["port"], "model=cgan&graphs=false",
                            _multipart(_PNG))
    assert status == 200 and payload["backend"] == "keras", payload


def test_ui_served(servers):
    with urllib.request.urlopen(servers["port"] + "/ui") as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "text/html"
        html = r.read().decode()
    assert "Run Full Pipeline" in html and "/enhance" in html


def test_bursts_of_concurrent_clients_are_accepted(servers):
    """Bursts of 64 clients that connect at once; with the default listen
    backlog of 5, some connections of the later bursts stalled past the
    timeout."""
    import concurrent.futures

    n = 64
    barrier = threading.Barrier(n)

    def one(_):
        barrier.wait(timeout=60)
        with urllib.request.urlopen(servers["port"] + "/", timeout=8) as r:
            return r.status

    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        for _ in range(4):
            assert list(ex.map(one, range(n))) == [200] * n


def test_stats_count_errors_under_the_canonical_name(servers):
    _post(servers["port"], "model=DENOISE", b"--x", ctype="multipart/form-"
          "data; boundary=zzz")
    with urllib.request.urlopen(servers["port"] + "/stats") as r:
        errors = json.loads(r.read())["errors"]
    assert "denoise:400" in errors and "DENOISE:400" not in errors


def test_int8_is_not_served_quietly():
    """Every request says how it ran (int8 or float) and which rung built the
    int8 forward; a quantize mode that does not exist is refused."""
    with pytest.raises(ValueError, match="quantize"):
        ServeState(device="cpu", quantize="int4")
    st = ServeState(device="cpu", quantize="int8")
    st.enhance("denoise", imageio.encode_png(np.zeros((16, 16, 3), np.uint8)))
    assert st.last_compute_backend() == "int8"
    assert st.int8_rung == {"denoise": "int8-s8skip"}


def test_pth_weights_load_with_reference_layout(tmp_path):
    """A reference .pth (DDP-prefixed, under 'generator') loads like the npz."""
    sd = load_npz_state_dict("weights/denoise")
    torch.save({"generator": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 499}, tmp_path / "denoise_epoch_499.pth")
    st = ServeState(weights_dir=str(tmp_path), device="cpu")
    assert st.healthz()["weights_loaded"] == ["denoise"]
    got = st.models["denoise"].state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_missing_weights_keep_random_init(tmp_path):
    st = ServeState(weights_dir=str(tmp_path / "none"), device="cpu")
    assert st.healthz()["weights_loaded"] == []
    out = st.denoise_image(np.zeros((12, 12, 3), np.uint8))
    assert out.shape == (12, 12, 3) and out.dtype == np.uint8


# --------------------------------------------------------------------------
# PNG codec
def _smooth(h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(xx * 5 + yy * 3), (xx * xx + yy), (yy * 7), (xx * 2 + 40)]
    return (np.stack(chans[:c], -1) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode, c", [("RGB", 3), ("RGBA", 4), ("L", 1),
                                     ("LA", 2)])
@pytest.mark.parametrize("kind", ["smooth", "noisy"])
def test_png_decodes_what_pillow_writes(mode, c, kind):
    from PIL import Image

    a = (_smooth(33, 29, c) if kind == "smooth" else
         np.random.default_rng(c).integers(0, 256, (33, 29, c), np.uint8))
    buf = io.BytesIO()
    Image.fromarray(a[:, :, 0] if c == 1 else a, mode).save(buf, "PNG")
    data = buf.getvalue()
    np.testing.assert_array_equal(imageio.decode_png(data), a)
    np.testing.assert_array_equal(
        imageio.imread_rgb(data),
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filter(a: np.ndarray, ftype: int) -> bytes:
    """Encode ``a`` (H, W, C) with every row under filter ``ftype``."""
    h, w, c = a.shape
    rows, prev = [], [0] * (w * c)
    for y in range(h):
        cur = [int(v) for v in a[y].reshape(-1)]
        out = []
        for i, x in enumerate(cur):
            left = cur[i - c] if i >= c else 0
            up, ul = prev[i], (prev[i - c] if i >= c else 0)
            pred = [0, left, up, (left + up) // 2, _paeth(left, up, ul)][ftype]
            out.append((x - pred) & 0xFF)
        rows.append(bytes([ftype] + out))
        prev = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    return (imageio.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_every_filter_type(ftype):
    a = np.random.default_rng(ftype).integers(0, 256, (7, 6, 3), np.uint8)
    np.testing.assert_array_equal(
        imageio.decode_png(_png_with_filter(a, ftype)), a)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_roundtrip(c):
    a = np.random.default_rng(7).integers(0, 256, (19, 23, c), np.uint8)
    np.testing.assert_array_equal(imageio.decode_png(imageio.encode_png(a)), a)
    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(imageio.encode_png(a))))
    np.testing.assert_array_equal(img.reshape(a.shape), a)


def test_png_rejects_corruption():
    data = bytearray(imageio.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[30] ^= 0xFF  # inside IHDR: CRC mismatch
    with pytest.raises(ValueError):
        imageio.decode_png(bytes(data))
    with pytest.raises(ValueError):
        imageio.decode_png(b"\x89PNG\r\n\x1a\n")


def test_a_foreign_npz_is_refused_whole(tmp_path):
    """An npz of another family must not half-load into the generator."""
    (tmp_path / "denoise").mkdir()
    np.savez(tmp_path / "denoise" / "arrays.npz",
             **{"generator.down1.0.kernel": np.ones((3, 3, 3, 64), np.float32),
                "generator.head.kernel": np.ones((3, 3, 3, 8), np.float32)})
    fresh = ServeState(weights_dir=str(tmp_path / "none"), device="cpu")
    st = ServeState(weights_dir=str(tmp_path), device="cpu")
    assert st.healthz()["weights_loaded"] == []
    got, ref = (s.models["denoise"].state_dict() for s in (st, fresh))
    assert all(torch.equal(got[k], ref[k]) for k in ref)
