"""Serving logic — the ``POST /enhance`` contract for the denoise, srgan,
esrgan and dncnn families, float and int8.

Port of ``celebrity_image_denoiser_tpu/serve/handlers.py`` (``EnhanceError:60``,
``run_enhance:69``, ``_as01:115``, ``ServeState``): the same contract —
unknown model → 400 listing what is served, content type must be image/*
(400), uploads capped at 50 MB (400), undecodable image → 500, response
``{denoised_image_base64, noise_graph_base64, backend}``, tolerant weight
loading that warns and keeps the random init — for the four families
ported (``self.models``: cgan and cgan_torch wait, ``ROADMAP.md`` queue 1,
item 3, and answer a 400 that lists the four).

The float forward is ``_build_forward``'s with no quantizer (:290-297):
forward, then ``clip(y*0.5+0.5)`` for the tanh families (denoise, srgan)
or ``clip(y)`` for the [0, 1] ones (dncnn, esrgan), then **truncate**
``y01*255`` to uint8 (the bench step rounds instead; that belongs to
``models.denoise_unet.serve_step``).  Each family's serving domain is the
JAX server's (:761-828):

* denoise: normalized to [-1, 1], padded to a multiple of 4
  (``get_padding``), the output cropped back;
* srgan: normalized, padded to a multiple of 16 (divisor 4 × scale 4), the
  output 4× the padded input and not cropped; its analysis view is the
  input bicubic-upscaled to the output's size (Pillow's bicubic,
  ``data/imageio.py::resize_bicubic_u8``);
* dncnn: [0, 1], unpadded, not cropped;
* esrgan: [0, 1], unpadded, then cropped at the padding offsets the JAX
  server computes for it, as Pillow's ``crop`` does: shifted by (left,
  top), zeros past the border (the JAX server's quirk, kept).

On the card the float forward is each generator's kernel route
(``models/folded.py``): K2/K3 for every 3×3 conv, the eval BatchNorm
folded in.

``quantize="int8"`` (``_maybe_quantize:409-550``) builds, once per family
at its first use (``ladder``; a request, ``warmup``), as the JAX server
builds its int8 forward at the family's first request (:267-276), the
first rung of the ladder that passes the
runtime agreement gate (≥ 40 dB against the float forward on
``calib[:2, :32, :32]``, peak-to-peak 2 for the tanh families and 1 for
the [0, 1] ones, :448-468).  The rungs (:501-541): for denoise the s8
skip-storage program (``ops/quant_unet.py``, rung ``int8-s8skip``); for
every family the generic transform with bias correction and the default
skip policy (``ops/quant.py``, rung ``int8-generic``); for esrgan then the
trunk-float policy (``make_indexed_skip(ESRGAN_TRUNK_CALLS)``, rung
``int8-trunkfloat``); then float.  The calibration batch, drawn on the CPU
(``data/synthetic.py``): ``calibration_batch`` at σ 0.12 in the family's
domain, at σ (0.05, 0.12, 0.25) for esrgan, and
``srgan_calibration_batch`` for srgan.  A rung is left only for a
``ValueError`` from its builder (a model
whose conv sequence is not the U-Net's, or ``quant.NoInt8Kernel``: a conv
geometry no int8 kernel takes, raised while the builder or the gate runs)
or a failed gate; an error of a kernel's build or launch propagates, so
the card never quietly serves float in place of a kernel.  The served
input is f32 in [-1, 1]; the int8 program casts it to bf16 at conv 0 and
its tanh output back to f32, which is truncated to uint8 as on the float
path.  The generic rungs replay each generator's autograd route, whose 3×3
convs of 64 input channels reach K5 (``ops/quant.py::int8_conv2d``).  Each
request is labelled ``int8`` or ``float`` (``+tiled`` for a
big input, below) in the log line and in ``ServeStats``
(``last_compute_backend`` reads it, per thread).

Big inputs (``_dispatch_forward:303-401``): a padded input taller or
wider than ``tile_threshold_rows`` runs through exact single-device tiling
(``parallel/tiling.py``, halo 32, tiles of ``tile_threshold_rows`` input
rows, the output cropped at ``scale`` × the input offsets), along the axis
that is over, or with a width tiler nested inside the height
tiler when both are; under ``quantize="int8"`` every tile runs the int8
forward the ladder built.  Such a request is labelled ``float+tiled`` or
``int8+tiled``.

Micro-batching (``microbatch_window_ms``, ``serve/batching.py``):
concurrent batch-1 requests of one padded shape under the threshold share
one forward of a pow2-padded batch, whose uint8 output comes back to the
host in one copy.  The label is set in the requesting thread, since the
batch may run in another.  ``warmup`` runs each padded size once (its tile
shapes when it is over the threshold) and, with micro-batching on, every
batch size the batcher can dispatch, so that the kernels are built and
each shape launched before the first request.

Not ported yet: cgan and cgan_torch (a 400); there is no mesh (spatial
sharding and data-parallel batches, ``ROADMAP.md`` queue 1, item 7).
"""

from __future__ import annotations

import math
import os
import threading
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
from celebrity_image_denoiser_tpu_torch.data.synthetic import (
    calibration_batch,
    srgan_calibration_batch,
)
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.dncnn import DnCNN
from celebrity_image_denoiser_tpu_torch.models.esrgan import ESRGANGenerator
from celebrity_image_denoiser_tpu_torch.models.srgan import SRGANGenerator
from celebrity_image_denoiser_tpu_torch.ops import quant, quant_unet
from celebrity_image_denoiser_tpu_torch.parallel.tiling import (
    tiled_apply_single_device,
)
from celebrity_image_denoiser_tpu_torch.serve.batching import (
    BatcherPool,
    _pow2_at_least,
)
from celebrity_image_denoiser_tpu_torch.serve.stats import ServeStats
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.serve")

MAX_UPLOAD = 50 * 1024 * 1024  # app.py:374-375
GATE_DB = 40.0  # the runtime agreement gate (handlers.py:448-468)
# covers every family's receptive field (parallel/tiling.py): the U-Net's
# about 28 px, esrgan's 24, srgan's 18 input px, dncnn's 17
TILE_HALO = 32

# default checkpoint names, matching the reference weights dir layout
# (handlers.py:50-56): a reference .pth first, else the native npz directory
_CKPT_CANDIDATES = {
    "denoise": ("denoise_epoch_499.pth", "denoise"),
    "srgan": ("srgan_epoch_499.pth", "srgan"),
    "esrgan": ("esrgan_epoch_500.pth", "esrgan"),
    "dncnn": ("dncnn_epoch_499.pth", "dncnn"),
}


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


def _pil_crop(img: np.ndarray, box) -> np.ndarray:
    """Pillow's ``Image.crop(box)`` on an (H, W, C) array: box = (left, top,
    right, bottom); what lies outside the image is zero."""
    left, top, right, bottom = box
    out = np.zeros((bottom - top, right - left) + img.shape[2:], img.dtype)
    h, w = img.shape[:2]
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(bottom, h), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


class ServeState:
    """Loaded models + float or int8 forwards on ``device`` (the card by
    default).  Big inputs route through exact tiling automatically.

    ``microbatch_window_ms``: coalesce concurrent same-shape requests into
    batches of up to ``microbatch_max`` (off by default: it adds up to that
    much latency)."""

    def __init__(self, weights_dir: Optional[str] = None, seed: int = 0,
                 tile_threshold_rows: int = 2048,
                 microbatch_window_ms: Optional[float] = None,
                 microbatch_max: int = 16,
                 quantize: Optional[str] = None, device="cuda"):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got "
                             f"{quantize!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # float32 serving means float32 arithmetic, as in the JAX
            # server: the transpose convs go to cuDNN, which would otherwise
            # run them in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.quantize = quantize
        self.weights_dir = weights_dir or default_weights_dir()
        self.tile_threshold_rows = tile_threshold_rows
        self.batchers = (None if microbatch_window_ms is None else
                         BatcherPool(microbatch_window_ms, microbatch_max))
        gen = torch.Generator().manual_seed(seed)
        self.models: Dict[str, torch.nn.Module] = {
            "denoise": DenoiseGenerator(generator=gen),
            "srgan": SRGANGenerator(scale_factor=MODEL_CFG["srgan"]["scale"],
                                    generator=gen),
            "esrgan": ESRGANGenerator(num_residuals=8, generator=gen),
            "dncnn": DnCNN(generator=gen),
        }
        self.stats = ServeStats()
        self._weights_loaded = set()
        self._load_weights()
        for m in self.models.values():
            m.to(self.device).eval()
        self._path_note = threading.local()
        # per family whose ladder is built: the int8 forward (None: float),
        # the gate's dB and the rung it came from (written last: the flag)
        self._qapply: Dict[str, object] = {}
        self.int8_gate_db: Dict[str, Optional[float]] = {}
        self.int8_rung: Dict[str, Optional[str]] = {}
        self._ladder_lock = threading.Lock()

    def ladder(self, name: str) -> Optional[str]:
        """The int8 rung that serves ``name`` (None: float, or
        ``quantize=None``), its ladder built on the first call."""
        if self.quantize != "int8":
            return None
        if name not in self.int8_rung:
            with self._ladder_lock:
                if name not in self.int8_rung:
                    self._maybe_quantize(name)
        return self.int8_rung[name]

    # -- int8: the ladder (_maybe_quantize:409-550) --------------------------
    @staticmethod
    def _tanh(name: str) -> bool:
        """Whether ``name`` serves in the tanh domain ([-1, 1])."""
        return MODEL_CFG[name]["activation"] == "tanh"

    def _agreement_db(self, name: str, apply_q, calib: torch.Tensor) -> float:
        """The runtime gate's dB of ``apply_q`` against the float forward on
        a 2×32² crop of the calibration batch (peak to peak 2 in the tanh
        domain, 1 in [0, 1], :464)."""
        probe = calib[:2, :32, :32, :].contiguous()
        with torch.inference_mode():
            yf = self.models[name](probe.permute(0, 3, 1, 2)).permute(
                0, 2, 3, 1).float()
            yq = apply_q(probe).float()
        mse = float(torch.mean((yq - yf) ** 2))
        rng = 2.0 if self._tanh(name) else 1.0
        return 10.0 * math.log10(rng ** 2 / max(mse, 1e-12))

    @classmethod
    def calibration(cls, name: str) -> torch.Tensor:
        """The family's calibration batch (:437-446), drawn on the CPU from
        fixed seeds whatever the device, so that the card serves the
        program the CPU tests hold against the JAX package."""
        if name == "srgan":
            return srgan_calibration_batch()
        sigmas = (0.05, 0.12, 0.25) if name == "esrgan" else (0.12,)
        return calibration_batch(cls._tanh(name), sigmas=sigmas)

    def _maybe_quantize(self, name: str) -> None:
        model = self.models[name]
        calib = self.calibration(name).to(self.device)
        builders = []
        if name == "denoise":
            builders.append(("int8-s8skip", lambda: quant_unet.
                             quantize_apply_denoise_unet(model, calib)))
        builders.append(("int8-generic", lambda: quant.quantize_apply(
            model, calib, bias_correct=True)))
        if name == "esrgan":
            # the trunk's convs in float, for checkpoints whose residual
            # trunk outgrew 8 bits (make_indexed_skip's receipt)
            builders.append(("int8-trunkfloat", lambda: quant.quantize_apply(
                model, calib, skip=quant.make_indexed_skip(
                    quant.ESRGAN_TRUNK_CALLS), bias_correct=True)))
        for rung, build in builders:
            try:
                cand = build()
            except ValueError as e:  # e.g. not the U-Net's conv sequence
                logger.warning("[%s] %s builder failed (%s); trying the next "
                               "rung", name, rung, e)
                continue
            try:
                db = self._agreement_db(name, cand, calib)
            except quant.NoInt8Kernel as e:  # a kernel failure stays loud
                logger.warning("[%s] %s has a conv with no int8 kernel (%s); "
                               "trying the next rung", name, rung, e)
                continue
            if db >= GATE_DB:
                logger.info("[%s] %s serving forward built, %.1f dB vs float",
                            name, rung, db)
                self._qapply[name], self.int8_gate_db[name] = cand, db
                self.int8_rung[name] = rung
                return
            logger.warning("[%s] %s FAILED the runtime agreement gate (%.1f "
                           "dB < %.0f); trying the next rung", name, rung, db,
                           GATE_DB)
        logger.warning("[%s] no int8 rung passed; serving the float forward "
                       "for this model", name)
        self._qapply[name], self.int8_gate_db[name] = None, None
        self.int8_rung[name] = None

    def last_compute_backend(self) -> str:
        """``int8`` or ``float``: how this thread's last request ran."""
        return getattr(self._path_note, "value", "n/a")

    # -- weight loading (warn-and-continue, app.py:327-345) -----------------
    def _load_weights(self):
        for name, (fname, sub) in _CKPT_CANDIDATES.items():
            path = os.path.join(self.weights_dir, fname)
            npz_dir = os.path.join(self.weights_dir, sub)
            model = self.models[name]
            own = model.state_dict()
            # BatchNorm's batch counters have no JAX counterpart
            need = {k for k in own if not k.endswith("num_batches_tracked")}
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
                    fit = load_npz_state_dict(npz_dir, module=model)
                    if set(fit) != need or any(
                            fit[k].shape != own[k].shape for k in need):
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

    # -- the forward (_build_forward:278-301, _dispatch_forward:303-407) ----
    def _apply(self, name: str, route: str):
        """The model's forward on NHWC f32 in the family's domain: the int8
        forward where the ladder built one, else the float model."""
        self.ladder(name)
        qapply = self._qapply.get(name)
        if qapply is None:
            model = self.models[name]
            return lambda x: model(x.permute(0, 3, 1, 2), route=route
                                   ).permute(0, 2, 3, 1)
        if isinstance(qapply, quant_unet.QuantizedDenoiseUNet):
            return lambda x: qapply(x, route=route)
        if route == "plain":
            raise ValueError("the generic int8 rung has no plain route")
        return qapply

    def _to_u8(self, name: str, y: torch.Tensor) -> torch.Tensor:
        """The served output map: clip(y·0.5+0.5) in the tanh domain, clip(y)
        in [0, 1]; ×255, truncated."""
        y01 = y * 0.5 + 0.5 if self._tanh(name) else y
        return (torch.clamp(y01, 0.0, 1.0) * 255.0).to(torch.uint8)

    def _tiler(self, name: str, over_h: bool, over_w: bool, route: str):
        """The tiled forward for inputs over the threshold on these axes: a
        width tiler nested inside the height tiler when both are."""
        fn = self._apply(name, route)
        cfg = MODEL_CFG[name]
        # the unpadded families have no pooling: any extent tiles exactly
        multiple = 1 if cfg["normalize"] is None else 4
        for axis, over in ((2, over_w), (1, over_h)):
            if over:
                fn = tiled_apply_single_device(
                    tile_h=self.tile_threshold_rows, halo=TILE_HALO,
                    scale=cfg.get("scale", 1), apply_fn=fn, axis=axis,
                    multiple=multiple)
        return fn

    def _batched_dispatch(self, name: str):
        """How the micro-batcher runs a coalesced batch: the forward and the
        output map on the card (the batcher's fence copies it back)."""
        apply = self._apply(name, "kernel")

        def dispatch(xs: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return self._to_u8(name, apply(xs))
        return dispatch

    def _forward(self, name: str, x: np.ndarray, plain: bool = False
                 ) -> np.ndarray:
        """(N, H, W, 3) float32 in the family's domain → (N, H·s, W·s, 3)
        uint8, truncated;
        through the int8 forward where one was built; tiled when H or W is
        over ``tile_threshold_rows``; through the micro-batcher for a batch-1
        input under it when micro-batching is on."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        route = "plain" if plain else "kernel"
        label = "float" if self.ladder(name) is None else "int8"
        over_h = x.shape[1] > self.tile_threshold_rows
        over_w = x.shape[2] > self.tile_threshold_rows
        tiled = over_h or over_w
        # the label is this thread's: a micro-batch may run in another
        self._path_note.value = label + ("+tiled" if tiled else "")
        if not tiled and not plain and self.batchers is not None \
                and x.shape[0] == 1:
            batcher = self.batchers.get((name, tuple(x.shape[1:])),
                                        self._batched_dispatch(name))
            return batcher(xt)
        fn = (self._tiler(name, over_h, over_w, route) if tiled
              else self._apply(name, route))
        with torch.inference_mode():
            u8 = self._to_u8(name, fn(xt))
        return u8.cpu().numpy()

    def _padding(self, name: str, h: int, w: int):
        """(left, top, right, bottom) padding of an (h, w) input."""
        cfg = MODEL_CFG[name]
        return get_padding((w, h), cfg["pad_divisor"], cfg.get("scale", 1))

    def _input_shape(self, name: str, h: int, w: int):
        """The forward's (H, W) for an (h, w) upload: padded, or as it is
        for the [0, 1] families."""
        if MODEL_CFG[name]["normalize"] is None:
            return h, w
        pl_, pt_, pr_, pb_ = self._padding(name, h, w)
        return h + pt_ + pb_, w + pl_ + pr_

    def _served_input(self, name: str, image: np.ndarray):
        """(the forward's (1, H, W, 3) f32 input, its [0, 1] view, the crop
        box of the original (left, top, right, bottom))."""
        h, w = image.shape[:2]
        pl_, pt_, pr_, pb_ = self._padding(name, h, w)
        cfg = MODEL_CFG[name]
        if cfg["normalize"] is None:  # dncnn, esrgan: [0, 1], unpadded
            x01 = imageio.to_float01(image)
            x = x01
        else:
            x01 = imageio.to_float01(np.pad(image, ((pt_, pb_), (pl_, pr_),
                                                    (0, 0))))
            mean, std = cfg["normalize"]
            x = imageio.normalize(x01, mean[0], std[0])
        # expand_dims, not [None]: a [None] view has a batch stride of 0,
        # and PyTorch's CPU convolution then sums conv 0 in another order
        # than for the same image inside a batch (one s8 step in int8)
        return np.expand_dims(x, 0), x01, (pl_, pt_, pl_ + w, pt_ + h)

    def denoise_image(self, image: np.ndarray, model: str = "denoise", *,
                      plain: bool = False) -> np.ndarray:
        """uint8 RGB (H, W, 3) → the served uint8 RGB output, in the
        family's serving domain (the module docstring): the input's size,
        or 4× its padded size for srgan.  ``plain`` runs the kernels' plain
        versions (the reference on the card)."""
        xin, _, box = self._served_input(model, image)
        y01 = _as01(self._forward(model, xin, plain=plain))
        y_u8 = (np.clip(y01, 0, 1) * 255).astype(np.uint8)
        return _pil_crop(y_u8, box) if model in ("denoise", "esrgan") \
            else y_u8

    def _input_view(self, image: np.ndarray, model: str, out_hw):
        """The analysis figure's view of the input beside an output of
        ``out_hw`` (:770-828): cropped as the output is, or for srgan the
        input bicubic-upscaled to the output's size."""
        _, x01, box = self._served_input(model, image)
        x_u8 = (np.clip(x01, 0, 1) * 255).astype(np.uint8)
        if model in ("denoise", "esrgan"):
            return _pil_crop(x_u8, box)
        if model == "srgan":
            return imageio.resize_bicubic_u8(_pil_crop(x_u8, box),
                                             (out_hw[1], out_hw[0]))
        return x_u8

    def warmup(self, sizes=((256, 256),), models=None) -> None:
        """Run each (H, W) input size once per model (sizes before padding)
        so that first requests do not pay for the kernels' build (nvcc at
        first use) or a first launch at their shapes: a size over the
        threshold runs its tile shapes.  With micro-batching on, also every
        batch size the batcher can dispatch at that padded shape (the pow2
        series up to ``microbatch_max``, the cap included), for the sizes
        the batcher serves (not those that are tiled).  ``models``: only
        these families (default: every family, as the JAX
        ``warmup(models=None)``).  The [0, 1] families run unpadded."""
        for h, w in sizes:
            for name in self.models:
                if models is not None and name not in models:
                    continue
                hh, ww = self._input_shape(name, h, w)
                t0 = time.perf_counter()
                self._forward(name, np.zeros((1, hh, ww, 3), np.float32))
                tiled = max(hh, ww) > self.tile_threshold_rows
                if self.batchers is not None and not tiled:
                    dispatch = self._batched_dispatch(name)
                    mb = self.batchers.max_batch
                    for b in sorted({_pow2_at_least(n, mb)
                                     for n in range(2, mb + 1)}):
                        dispatch(torch.zeros((b, hh, ww, 3),
                                             device=self.device)).cpu()
                logger.info("warmed %s at %dx%d (%.1fs)", name, hh, ww,
                            time.perf_counter() - t0)

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
            "int8_rungs": dict(self.int8_rung),
            "int8_gate_db": dict(self.int8_gate_db),
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
        self.stats.record(model_key, time.perf_counter() - t_start,
                          self.last_compute_backend())
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

                x_u8 = self._input_view(image, model, y_u8.shape[:2])
                graph_b64 = make_graphs(x_u8.astype(np.float32) / 255.0,
                                        y_u8.astype(np.float32) / 255.0)
            t_graph = time.perf_counter()
            out_b64 = imageio.encode_png_base64(y_u8)
            done = time.perf_counter()
            h, w = image.shape[:2]
            logger.info(
                "[%s] %dx%d in %.0f ms (decode %.0f, forward+D2H %.0f, "
                "figure %.0f, encode %.0f) compute=%s device=%s", model, w,
                h, (done - t_start) * 1e3, (t_decode - t_start) * 1e3,
                (t_forward - t_decode) * 1e3, (t_graph - t_forward) * 1e3,
                (done - t_graph) * 1e3, self.last_compute_backend(),
                self.device)
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
