"""Serving logic — the ``POST /enhance`` contract, denoise family, float.

Port of ``celebrity_image_denoiser_tpu/serve/handlers.py`` (``EnhanceError:60``,
``run_enhance:69``, ``_as01:115``, ``ServeState``): the same contract —
unknown model → 400 listing what is served, content type must be image/*
(400), uploads capped at 50 MB (400), undecodable image → 500, response
``{denoised_image_base64, noise_graph_base64, backend}``, tolerant weight
loading that warns and keeps the random init — for the one family this
slice ports, ``denoise``, in float32.

The float forward is ``_build_forward``'s with no quantizer (:290-297):
forward, ``clip(y*0.5+0.5)``, then **truncate** ``y01*255`` to uint8 (the
bench step rounds instead; that belongs to ``models.denoise_unet.
serve_step``).  Inputs are padded to a multiple of 4 (``get_padding``) and
the output cropped back (:820-824).

Not ported yet, and refused rather than served some other way:
``quantize="int8"`` raises ``NotImplementedError``; inputs above
``tile_threshold_rows`` on either axis are a 400 (tiling is not ported);
the other four families are a 400.  There is no micro-batching and no mesh.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from celebrity_image_denoiser_tpu_torch.ckpt.convert import (
    load_npz_state_dict,
    load_pth_state_dict,
)
from celebrity_image_denoiser_tpu_torch.core.config import (
    MODEL_CFG,
    default_weights_dir,
    get_padding,
)
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.data import imageio
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.serve.stats import ServeStats
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.serve")

MAX_UPLOAD = 50 * 1024 * 1024  # app.py:374-375

# default checkpoint names, matching the reference weights dir layout: a
# reference .pth first, else the native npz directory
_CKPT_CANDIDATES = {"denoise": ("denoise_epoch_499.pth", "denoise")}


class EnhanceError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def _mark_recorded(e: Exception) -> None:
    try:
        e._stats_recorded = True
    except AttributeError:
        pass


def run_enhance(st: "ServeState", *, model: str, file_bytes: bytes,
                content_type: str, label_raw=None, graphs_raw="true"):
    """Request semantics shared by server front ends: label parsing (400),
    the ``graphs=false`` opt-out, and counting each failure exactly once."""
    model_key = str(model).strip().lower()
    try:
        if label_raw is not None:
            try:
                int(str(label_raw).strip())
            except ValueError:
                raise EnhanceError(400, "label must be an integer")
        include_graph = str(graphs_raw).strip().lower() != "false"
        return st.enhance(model=model_key, file_bytes=file_bytes,
                          content_type=content_type,
                          include_graph=include_graph)
    except Exception as e:
        status = e.status if isinstance(e, EnhanceError) else 500
        if not getattr(e, "_stats_recorded", False):
            st.stats.record_error(model_key, status)
            _mark_recorded(e)
        raise


def _as01(y_u8: np.ndarray) -> np.ndarray:
    """Forward output (1, H, W, 3) uint8 → host float [0,1] (``_as01:115``;
    u8 → /255 → ×255 → u8 round-trips as in the JAX server)."""
    return np.asarray(y_u8)[0].astype(np.float32) / 255.0


class ServeState:
    """Loaded model + float forward on ``device`` (the card by default)."""

    def __init__(self, weights_dir: Optional[str] = None, seed: int = 0,
                 tile_threshold_rows: int = 2048,
                 quantize: Optional[str] = None, device="cuda"):
        if quantize == "int8":
            raise NotImplementedError(
                "int8 serving is not ported yet (ROADMAP.md queue 1, item 5: "
                "int8 serving and its int8 conv kernel); serve float with "
                "quantize=None / --quantize off")
        if quantize is not None:
            raise ValueError(f"quantize must be None or 'int8', got "
                             f"{quantize!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # float32 serving means float32 arithmetic, as in the JAX
            # server: the transpose convs go to cuDNN, which would otherwise
            # run them in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.quantize = None
        self.weights_dir = weights_dir or default_weights_dir()
        self.tile_threshold_rows = tile_threshold_rows
        gen = torch.Generator().manual_seed(seed)
        self.models: Dict[str, DenoiseGenerator] = {
            "denoise": DenoiseGenerator(generator=gen)}
        self.stats = ServeStats()
        self._weights_loaded = set()
        self._load_weights()
        for m in self.models.values():
            m.to(self.device).eval()

    # -- weight loading (warn-and-continue, app.py:327-345) -----------------
    def _load_weights(self):
        for name, (fname, sub) in _CKPT_CANDIDATES.items():
            path = os.path.join(self.weights_dir, fname)
            npz_dir = os.path.join(self.weights_dir, sub)
            model = self.models[name]
            own = model.state_dict()
            try:
                if os.path.exists(path):
                    # tolerant like the reference's load_state_safely: keys
                    # missing from the file keep their init, and a tensor of
                    # the wrong shape is skipped with a warning
                    sd = load_pth_state_dict(path)
                    fit = {k: v for k, v in sd.items()
                           if k in own and own[k].shape == v.shape}
                    for k in sorted(set(sd) - set(fit)):
                        logger.warning("[%s] skipping %s from %s", name, k,
                                       path)
                    src = path
                elif os.path.isdir(npz_dir):
                    # the native checkpoint is all or nothing, checked
                    # before any tensor is copied
                    fit = load_npz_state_dict(npz_dir)
                    if set(fit) != set(own) or any(
                            fit[k].shape != own[k].shape for k in own):
                        raise ValueError(f"{npz_dir} does not hold the "
                                         f"{name} generator")
                    src = npz_dir
                else:
                    raise FileNotFoundError(path)
                model.load_state_dict(fit, strict=False)
                self._weights_loaded.add(name)
                logger.info("[%s] loaded weights from %s", name, src)
            except FileNotFoundError as e:
                logger.warning("[%s] checkpoint not loaded (%s). Using random "
                               "init for that backend.", name, e)
            except Exception as e:  # a PRESENT but unloadable checkpoint
                logger.warning("[%s] checkpoint failed to load (%s). Using "
                               "random init for that backend.", name, e)

    # -- the float forward (_build_forward:290-297 with no quantizer) -------
    def _forward(self, name: str, x: np.ndarray, plain: bool = False
                 ) -> np.ndarray:
        """(1, H, W, 3) float32 in [-1, 1] → (1, H, W, 3) uint8, truncated."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        with torch.inference_mode():
            y = self.models[name](xt.permute(0, 3, 1, 2), plain=plain)
            y01 = torch.clamp(y * 0.5 + 0.5, 0.0, 1.0)
            u8 = (y01 * 255.0).to(torch.uint8)
        return u8.permute(0, 2, 3, 1).cpu().numpy()

    def denoise_image(self, image: np.ndarray, model: str = "denoise", *,
                      plain: bool = False) -> np.ndarray:
        """uint8 RGB (H, W, 3) → the served uint8 RGB output, same size: pad
        to the family's divisor, normalize, forward, crop back.  ``plain``
        runs the kernels' plain versions (the reference on the card)."""
        h, w = image.shape[:2]
        cfg = MODEL_CFG[model]
        pl_, pt_, pr_, pb_ = get_padding((w, h), cfg["pad_divisor"],
                                         cfg.get("scale", 1))
        hh, ww = h + pt_ + pb_, w + pl_ + pr_
        if max(hh, ww) > self.tile_threshold_rows:
            raise EnhanceError(
                400, f"Input {w}x{h} exceeds tile_threshold_rows="
                     f"{self.tile_threshold_rows}; tiled inference is not "
                     "ported to this server yet")
        padded = np.pad(image, ((pt_, pb_), (pl_, pr_), (0, 0)))
        mean, std = cfg["normalize"]
        xin = imageio.normalize(imageio.to_float01(padded), mean[0],
                                std[0])[None]
        y01 = _as01(self._forward(model, xin, plain=plain))
        y_u8 = (np.clip(y01, 0, 1) * 255).astype(np.uint8)
        return y_u8[pt_:pt_ + h, pl_:pl_ + w]

    # -- info routes ---------------------------------------------------------
    def info(self) -> dict:
        return {
            "message": "Unified GAN API is running",
            "models": list(self.models.keys()),
            "default_backends": {name: "torch" for name in self.models},
        }

    def healthz(self) -> dict:
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += f" ({torch.cuda.get_device_name(self.device)})"
        return {
            "status": "ok",
            "device": dev,
            "models": list(self.models.keys()),
            "weights_loaded": sorted(self._weights_loaded),
            "quantize": self.quantize,
            "uptime_s": self.stats.uptime_s(),
        }

    # -- the enhance endpoint -------------------------------------------------
    def enhance(self, model: str, file_bytes: bytes,
                content_type: str = "image/png",
                include_graph: bool = True) -> dict:
        """Stats are recorded here, so library callers are counted too;
        errors carry the ``_stats_recorded`` marker so front ends never
        double count."""
        t_start = time.perf_counter()
        model_key = str(model).strip().lower()
        try:
            result = self._enhance_impl(model_key, file_bytes, content_type,
                                        include_graph)
        except Exception as e:
            status = e.status if isinstance(e, EnhanceError) else 500
            if not getattr(e, "_stats_recorded", False):
                self.stats.record_error(model_key, status)
                _mark_recorded(e)
            raise
        self.stats.record(model_key, time.perf_counter() - t_start, "float")
        return result

    def _enhance_impl(self, model: str, file_bytes: bytes, content_type: str,
                      include_graph: bool) -> dict:
        t_start = time.perf_counter()
        if model not in self.models:
            if model in MODEL_CFG:
                raise EnhanceError(
                    400, f"Model '{model}' is not ported to this server yet. "
                         f"Choose one of {list(self.models.keys())}")
            raise EnhanceError(
                400, f"Unknown model '{model}'. Choose one of "
                     f"{list(self.models.keys())}")
        if not (content_type or "").startswith("image/"):
            raise EnhanceError(400, "Uploaded file must be an image")
        if len(file_bytes) > MAX_UPLOAD:
            raise EnhanceError(400, "File too large")
        try:
            image = imageio.imread_rgb(file_bytes)
        except Exception:
            raise EnhanceError(500, "Image enhancement failed")
        t_decode = time.perf_counter()

        try:
            y_u8 = self.denoise_image(image, model)
            t_forward = time.perf_counter()
            graph_b64 = ""
            if include_graph:
                from celebrity_image_denoiser_tpu_torch.viz.analysis import (
                    make_graphs,
                )

                # the input view as the JAX server builds it: u8 → [0,1] →
                # ×255 → truncated u8
                x_u8 = (np.clip(imageio.to_float01(image), 0, 1)
                        * 255).astype(np.uint8)
                graph_b64 = make_graphs(x_u8.astype(np.float32) / 255.0,
                                        y_u8.astype(np.float32) / 255.0)
            t_graph = time.perf_counter()
            out_b64 = imageio.encode_png_base64(y_u8)
            done = time.perf_counter()
            h, w = image.shape[:2]
            logger.info(
                "[%s] %dx%d in %.0f ms (decode %.0f, forward+D2H %.0f, "
                "figure %.0f, encode %.0f) compute=float device=%s", model, w,
                h, (done - t_start) * 1e3, (t_decode - t_start) * 1e3,
                (t_forward - t_decode) * 1e3, (t_graph - t_forward) * 1e3,
                (done - t_graph) * 1e3, self.device)
            return {
                "denoised_image_base64": out_b64,
                "noise_graph_base64": graph_b64,
                "backend": "torch",
            }
        except EnhanceError:
            raise
        except Exception as e:
            logger.error("Enhancement failed: %s", e, exc_info=True)
            raise EnhanceError(500, "Image enhancement failed")
