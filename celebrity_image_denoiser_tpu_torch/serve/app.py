"""HTTP server exposing the reference API contract (stdlib only).

Port of ``celebrity_image_denoiser_tpu/serve/app.py::make_server`` (:58) and
``run_server`` (:172) on ``http.server.ThreadingHTTPServer``:

    GET  /          → {"message", "models", "default_backends"}
    POST /enhance?model=...&graphs=...  multipart: file, [label]
                    → {"denoised_image_base64", "noise_graph_base64",
                       "backend"} | {"detail"} with 400/500
    GET  /healthz   → liveness/readiness (device, loaded weights)
    GET  /stats     → request counters / latency quantiles (serve/stats.py)
    GET  /metrics   → the same in Prometheus text format

The model name is lowercased at the top of the POST handler, so errors
counted before ``run_enhance`` share the canonical stats series.  The
FastAPI variant and the ``/ui`` page are not ported yet.  CORS is open like
the reference.
"""

from __future__ import annotations

import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from celebrity_image_denoiser_tpu_torch.serve.handlers import (
    MAX_UPLOAD,
    EnhanceError,
    ServeState,
    run_enhance,
)
from celebrity_image_denoiser_tpu_torch.serve.multipart import parse_multipart
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.serve.http")

_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
    "Access-Control-Allow-Credentials": "true",
}


def make_server(host: str = "0.0.0.0", port: int = 8000,
                state: Optional[ServeState] = None,
                weights_dir: Optional[str] = None,
                device="cuda") -> ThreadingHTTPServer:
    st = state or ServeState(weights_dir=weights_dir, device=device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            logger.info("%s " + fmt, self.client_address[0], *args)

        def _send(self, status: int, payload, content_type="application/json"):
            body = (json.dumps(payload) if content_type == "application/json"
                    else payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in _CORS.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):
            self._send(200, {})

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/":
                self._send(200, st.info())
            elif parsed.path == "/healthz":
                self._send(200, st.healthz())
            elif parsed.path == "/stats":
                self._send(200, st.stats.snapshot())
            elif parsed.path == "/metrics":
                self._send(200, st.stats.prometheus(),
                           content_type="text/plain; version=0.0.4")
            else:
                self._send(404, {"detail": "Not Found"})

        def do_POST(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path != "/enhance":
                self._send(404, {"detail": "Not Found"})
                return
            qs = urllib.parse.parse_qs(parsed.query)
            model = (qs.get("model", [""])[0] or "").strip().lower()
            try:
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    raise EnhanceError(400, "Invalid Content-Length")
                # bound before buffering: the 50 MB check inside enhance()
                # sees only the decoded file part; a negative length would
                # make rfile.read buffer until the client closes
                if length < 0:
                    raise EnhanceError(400, "Invalid Content-Length")
                if length > 2 * MAX_UPLOAD + 65536:
                    raise EnhanceError(400, "File too large")
                body = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if not ctype.startswith("multipart/form-data"):
                    raise EnhanceError(400, "Expected multipart/form-data")
                try:
                    parts = parse_multipart(body, ctype)
                except ValueError as e:
                    # malformed framing is the client's fault: 400
                    raise EnhanceError(400, f"Malformed multipart body: {e}")
                if "file" not in parts:
                    raise EnhanceError(400, "Uploaded file must be an image")
                fpart = parts["file"]
                result = run_enhance(
                    st,
                    model=model,
                    file_bytes=fpart.data,
                    content_type=fpart.content_type or "",
                    label_raw=(parts["label"].data.decode("utf-8", "replace")
                               if "label" in parts else None),
                    graphs_raw=qs.get("graphs", ["true"])[0],
                )
            except EnhanceError as e:
                if not getattr(e, "_stats_recorded", False):
                    st.stats.record_error(model, e.status)
                self._send(e.status, {"detail": e.detail})
                return
            except Exception as e:
                if not getattr(e, "_stats_recorded", False):
                    st.stats.record_error(model, 500)
                logger.error("Enhancement failed: %s", e, exc_info=True)
                self._send(500, {"detail": "Image enhancement failed"})
                return
            # outside the counting try: a client that disconnects before the
            # response lands got a successful enhancement, not a 500
            self._send(200, result)

    server = ThreadingHTTPServer((host, port), Handler)
    server.state = st
    return server


def run_server(host: str, port: int, state: ServeState) -> None:
    server = make_server(host, port, state=state)
    logger.info("Unified GAN API (torch port, %s) listening on %s:%d",
                state.device, host, port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
