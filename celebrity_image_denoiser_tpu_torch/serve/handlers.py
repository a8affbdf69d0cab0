"""Serving logic — the ``POST /enhance`` contract for the denoise, cgan,
srgan, esrgan and dncnn families, float and int8, and for restormer, a
family the JAX package does not have, in float.

Port of ``celebrity_image_denoiser_tpu/serve/handlers.py`` (``EnhanceError:60``,
``run_enhance:69``, ``ServeState``): the same contract —
unknown model → 400 listing the families, content type must be
image/* (400), uploads capped at 50 MB (400), undecodable image → 500,
response ``{denoised_image_base64, noise_graph_base64, backend}``, tolerant
weight loading that warns and keeps the random init.

The float forward is ``_build_forward``'s with no quantizer (:290-297):
forward, then ``clip(y*0.5+0.5)`` for the tanh families (denoise, srgan)
or ``clip(y)`` for the [0, 1] ones (dncnn, esrgan), then **truncate**
``y01*255`` to uint8 (the bench step rounds instead; that belongs to
``models.denoise_unet.serve_step``).  Each family's serving domain is the
JAX server's (:761-828):

* denoise: normalized to [-1, 1], padded to a multiple of 4
  (``get_padding``), the output cropped back;
* cgan (:721-760): as denoise, through the Keras generator
  (``weights/cgan_epoch_500.keras``, read by ``ckpt/keras.py``; the ladder
  and the micro-batcher know it as ``cgan:keras``) when
  ``cgan_backend=keras``, or ``auto`` and its weights loaded; the model is
  single-input, so ``label`` and ``cond_file`` are ignored, and the
  response says ``"backend": "keras"``.  Otherwise the torch generator
  (``models/cgan_torch.py``, random init: no ``.pth`` is shipped, as in the
  JAX package) draws a 64×64 image from a fresh latent (an OS-seeded
  ``torch.Generator``) and the label, always in float, cropped at the
  padding offsets as Pillow's ``crop`` does: no label and no condition is
  a 400, a ``cond_file`` a 500 (the reference's shape fault), a label
  outside 0..9 a 400 (the JAX server's ``jnp.take`` answers 200 there, an
  image from a NaN embedding row, or from row ``label + 10`` for -10..-1);
* srgan: normalized, padded to a multiple of 16 (divisor 4 × scale 4), the
  output 4× the padded input and not cropped; its analysis view is the
  input bicubic-upscaled to the output's size (Pillow's bicubic,
  ``data/imageio.py::resize_bicubic_u8``);
* dncnn: [0, 1], unpadded, not cropped;
* esrgan: [0, 1], unpadded, then cropped at the padding offsets the JAX
  server computes for it, as Pillow's ``crop`` does: shifted by (left,
  top), zeros past the border (the JAX server's quirk, kept);
* restormer (``models/restormer.py``): [0, 1], zero-padded to a multiple of
  8 (centred, as every padded family is: the published test script pads
  with reflection on the right and bottom instead), the output cropped
  back; float32 only (no int8 rung); built at its first use, not with the
  server (its seeded initialisation draws 26 M parameters), from a
  generator of its own seeded with ``MODEL_CFG``'s ``init_seed``, then its
  published checkpoint ``gaussian_color_denoising_blind.pth`` loaded where
  ``weights/`` holds it.  Never tiled or sharded: its channel attention
  spans the whole image, so no tile or strip of it gives the same answer
  (the published demo's ``--tile`` option gives another, approximate
  function).  An input that would be is refused (400, ``_forward``); with
  ``use_tiling=False`` and no mesh it runs whole at any size.

A request's host side holds uint8 only (``denoise_image``): the upload
goes to the device as uint8, is zero-padded there where the family pads,
and each value is mapped through the family's 256-entry table of its
serving domain (``_domain_table``: the host conversion of
``_served_input`` applied to 0..255, so the forward's input is the same
bits); the served image is the forward's uint8 output itself (copied
into host pages zeroed while the card computes), cropped where the family
is.  The JAX server's ``_as01:115`` round trip (u8 → /255 → clip → ×255 →
u8) is the identity on uint8 and is not run.

On the card the float forward is each generator's kernel route
(``models/folded.py``): K2/K3 for every 3×3 conv, the eval BatchNorm
folded in (cgan: K2 for its 3×3 tail, its 4×4 layers in PyTorch).

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
convs of 64 input channels reach K5 (``ops/quant.py::int8_conv2d``), and
cgan's 4×4 stride-2 convs and transpose convs too, through exact rewrites
(``ops/quant.py::s2d_conv4x4_s8``, ``d2s_convt4x4_s8``).  Each
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
``int8+tiled``.  A family whose configuration says ``tiles: False``
(restormer) is refused instead of tiled or sharded.

Micro-batching (``microbatch_window_ms``, ``serve/batching.py``):
concurrent batch-1 requests of one padded shape under the threshold share
one forward of a pow2-padded batch, whose uint8 output comes back to the
host in one copy.  The label is set in the requesting thread, since the
batch may run in another.  ``warmup`` runs each padded size once (its tile
shapes when it is over the threshold) and, with micro-batching on, every
batch size the batcher can dispatch, so that the kernels are built and
each shape launched before the first request.

The mesh (``mesh=``, a serving ``parallel/mesh.py::Mesh``: one process,
a weight replica per entry, repeats allowed; the served weights
themselves on the first entry of their own device; one list of replicas a
model, shared by both paths), as the JAX server routes it
(:316-359, :552-585):

* an input over the threshold on one axis only, or on both with
  ``use_tiling=False``, whose extent on that axis (the height first) is a
  multiple of the mesh's ``data`` size, is cut into one strip per device
  (``parallel/tiling.py::spatial_sharded_apply``: each strip with 32 rows
  of true context, bit-equal to the untiled forward), labelled
  ``float+sharded`` or ``int8+sharded``; under int8 each strip runs the
  forward the ladder built.  Over on both axes with tiling on, the tiler
  runs; over with tiling off and no shard, the whole image runs at once
  (and through the micro-batcher, as in JAX);
* a coalesced micro-batch is padded to a multiple of the ``data`` size by
  repeating its last row, split over the devices
  (``parallel/dataparallel.py::data_parallel_apply``) and cropped back;
  ``warmup`` warms those padded batches through the same dispatch.

``bucket_divisor`` (e.g. 64) rounds every pad-to size up to its multiple,
in ``warmup`` as in a request (:601, :756): fewer distinct shapes, at the
cost of a wider zero border than the reference's divisor.
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
from celebrity_image_denoiser_tpu_torch.ckpt.keras import load_keras_model
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
from celebrity_image_denoiser_tpu_torch.models.cgan import CGANKerasGenerator
from celebrity_image_denoiser_tpu_torch.models.cgan_torch import (
    CGANTorchGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.models.dncnn import DnCNN
from celebrity_image_denoiser_tpu_torch.models.esrgan import ESRGANGenerator
from celebrity_image_denoiser_tpu_torch.models.restormer import Restormer
from celebrity_image_denoiser_tpu_torch.models.srgan import SRGANGenerator
from celebrity_image_denoiser_tpu_torch.ops import quant, quant_unet
from celebrity_image_denoiser_tpu_torch.parallel.dataparallel import (
    data_parallel_apply,
    replicate,
)
from celebrity_image_denoiser_tpu_torch.parallel.mesh import Mesh
from celebrity_image_denoiser_tpu_torch.parallel.tiling import (
    TILE_HALO,
    spatial_sharded_apply,
    tiled_apply_single_device,
)
from celebrity_image_denoiser_tpu_torch.serve.batching import (
    BatcherPool,
    _pow2_at_least,
)
from celebrity_image_denoiser_tpu_torch.serve.stats import ServeStats
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger
from celebrity_image_denoiser_tpu_torch.utils.profiling import span

logger = get_logger("cid_torch.serve")

MAX_UPLOAD = 50 * 1024 * 1024  # app.py:374-375
GATE_DB = 40.0  # the runtime agreement gate (handlers.py:448-468)

# default checkpoint names, matching the reference weights dir layout
# (handlers.py:50-56): a reference .pth first, else the native npz directory
_CKPT_CANDIDATES = {
    "denoise": ("denoise_epoch_499.pth", "denoise"),
    "cgan": ("cgan_epoch_500_converted.pth", "cgan"),
    "srgan": ("srgan_epoch_499.pth", "srgan"),
    "esrgan": ("esrgan_epoch_500.pth", "esrgan"),
    "dncnn": ("dncnn_epoch_499.pth", "dncnn"),
    "restormer": ("gaussian_color_denoising_blind.pth", "restormer"),
}
# where a family's .pth keeps its state_dict, where not under the default
# keys (the published Restormer checkpoints: ``params``)
_PTH_KEYS = {"restormer": ("params",)}
_CGAN_KERAS = "cgan_epoch_500.keras"
KERAS = "cgan:keras"  # the Keras cGAN's name on the ladder and the batcher


# the families served, in the order the info routes list them
FAMILIES = tuple(MODEL_CFG)

# the families whose output is cropped back to the upload at the padding
# offsets (esrgan runs unpadded and is cropped all the same: a JAX quirk)
_CROPPED = ("denoise", "cgan", "esrgan", "restormer")


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
                content_type: str, cgan_backend: str = "auto",
                label_raw=None, cond_bytes: Optional[bytes] = None,
                graphs_raw="true"):
    """Request semantics shared by server front ends: label parsing (400),
    the ``graphs=false`` opt-out, and counting each failure exactly once."""
    model_key = str(model).strip().lower()
    try:
        label = None
        if label_raw is not None:
            try:
                label = int(str(label_raw).strip())
            except ValueError:
                raise EnhanceError(400, "label must be an integer")
        include_graph = str(graphs_raw).strip().lower() != "false"
        return st.enhance(model=model_key, file_bytes=file_bytes,
                          content_type=content_type,
                          cgan_backend=cgan_backend, label=label,
                          cond_bytes=cond_bytes, include_graph=include_graph)
    except Exception as e:
        status = e.status if isinstance(e, EnhanceError) else 500
        if not getattr(e, "_stats_recorded", False):
            st.stats.record_error(model_key, status)
            _mark_recorded(e)
        raise


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
    default).  Big inputs route through exact tiling automatically, or are
    refused where the family cannot be tiled exactly (restormer).

    ``microbatch_window_ms``: coalesce concurrent same-shape requests into
    batches of up to ``microbatch_max`` (off by default: it adds up to that
    much latency).  ``mesh``, ``use_tiling`` and ``bucket_divisor``: the
    module docstring; the mesh's devices are of ``device``'s type."""

    def __init__(self, weights_dir: Optional[str] = None, seed: int = 0,
                 tile_threshold_rows: int = 2048, use_tiling: bool = True,
                 bucket_divisor: Optional[int] = None,
                 mesh: Optional[Mesh] = None,
                 microbatch_window_ms: Optional[float] = None,
                 microbatch_max: int = 16,
                 quantize: Optional[str] = None, device="cuda"):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got "
                             f"{quantize!r}")
        self.device = resolve_device(device)
        if mesh is not None and any(d.type != self.device.type
                                    for d in mesh.devices.flat):
            raise ValueError(f"mesh {mesh} is not on {self.device.type}")
        self.use_tiling = use_tiling
        self.bucket_divisor = bucket_divisor
        self.mesh = mesh
        # the mesh's weight replicas, one list per served object
        self._replicas: Dict[tuple, list] = {}
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
        # the built models: restormer joins at its first use (``_model``)
        self.models: Dict[str, torch.nn.Module] = {
            "denoise": DenoiseGenerator(generator=gen),
            "cgan": CGANTorchGenerator(generator=gen),
            "srgan": SRGANGenerator(scale_factor=MODEL_CFG["srgan"]["scale"],
                                    generator=gen),
            "esrgan": ESRGANGenerator(num_residuals=8, generator=gen),
            "dncnn": DnCNN(generator=gen),
        }
        self._build_lock = threading.Lock()
        # the Keras cGAN, when its weights load (None: the torch fallback)
        self.keras_cgan: Optional[CGANKerasGenerator] = None
        self.stats = ServeStats()
        self._weights_loaded = set()
        self._load_weights()
        for m in self.models.values():
            m.to(self.device).eval()
        if self.keras_cgan is not None:
            self.keras_cgan.to(self.device).eval()
        self._path_note = threading.local()
        # each family's serving domain of the 256 uint8 values, on the device
        self._tables = {name: torch.from_numpy(self._domain_table(name)).to(
            self.device) for name in MODEL_CFG}
        # per family whose ladder is built: the int8 forward (None: float),
        # the gate's dB and the rung it came from (written last: the flag)
        self._qapply: Dict[str, object] = {}
        self.int8_gate_db: Dict[str, Optional[float]] = {}
        self.int8_rung: Dict[str, Optional[str]] = {}
        self._ladder_lock = threading.Lock()
        self._mesh_lock = threading.Lock()

    def _build_restormer(self) -> torch.nn.Module:
        """Restormer from its own seeded generator (``MODEL_CFG``), its
        published checkpoint loaded where present, on the device."""
        cfg = MODEL_CFG["restormer"]
        # ordinary tensors even where the first lookup runs under
        # inference_mode: a later checkpoint load or copy may write them
        with torch.inference_mode(False):
            model = Restormer(init_seed=cfg["init_seed"],
                              temperature_range=cfg["temperature_range"],
                              output_scale=cfg["output_scale"])
            self._load_family(model, "restormer")
            return model.to(self.device).eval()

    def _model(self, name: str) -> torch.nn.Module:
        """The image-to-image model ``name`` serves with (``KERAS``: the Keras
        cGAN); restormer built here at its first use."""
        if name == KERAS:
            return self.keras_cgan
        if name == "restormer" and name not in self.models:
            with self._build_lock:
                if name not in self.models:
                    self.models[name] = self._build_restormer()
        return self.models[name]

    @staticmethod
    def _cfg(name: str) -> dict:
        return MODEL_CFG[name.split(":")[0]]

    @staticmethod
    def _pads(name: str) -> bool:
        """Whether ``name``'s forward runs on a padded input: the normalized
        families, and the [0, 1] ones whose configuration says so."""
        cfg = ServeState._cfg(name)
        return cfg["normalize"] is not None or cfg.get("padded", False)

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
        return ServeState._cfg(name)["activation"] == "tanh"

    def _agreement_db(self, name: str, apply_q, calib: torch.Tensor) -> float:
        """The runtime gate's dB of ``apply_q`` against the float forward on
        a 2×32² crop of the calibration batch (peak to peak 2 in the tanh
        domain, 1 in [0, 1], :464)."""
        probe = calib[:2, :32, :32, :].contiguous()
        with torch.inference_mode():
            yf = self._model(name)(probe.permute(0, 3, 1, 2)).permute(
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
        if not self._cfg(name).get("int8", True):  # a float-only family
            self._qapply[name], self.int8_gate_db[name] = None, None
            self.int8_rung[name] = None
            return
        model = self._model(name)
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
        """``int8`` or ``float`` (``+tiled``, ``+sharded``): how this
        thread's last request ran."""
        return getattr(self._path_note, "value", "n/a")

    # -- weight loading (warn-and-continue, app.py:327-345) -----------------
    def _load_weights(self):
        for name, model in self.models.items():  # restormer: at its build
            self._load_family(model, name)
        keras_path = os.path.join(self.weights_dir, _CGAN_KERAS)
        try:
            model = CGANKerasGenerator()
            load_keras_model(model, keras_path)
            self.keras_cgan = model
            self._weights_loaded.add("cgan")
            logger.info("Loaded Keras cGAN from %s", keras_path)
        except Exception as e:  # absent or unloadable: the torch fallback
            logger.warning("Keras cGAN not loaded (%s).", e)

    def _load_family(self, model: torch.nn.Module, name: str) -> None:
        """``name``'s checkpoint into ``model``, where one loads."""
        fname, sub = _CKPT_CANDIDATES[name]
        path = os.path.join(self.weights_dir, fname)
        npz_dir = os.path.join(self.weights_dir, sub)
        own = model.state_dict()
        # BatchNorm's batch counters have no JAX counterpart
        need = {k for k in own if not k.endswith("num_batches_tracked")}
        try:
            if os.path.exists(path):
                # tolerant like the reference's load_state_safely: keys
                # missing from the file keep their init, and a tensor of
                # the wrong shape is skipped with a warning
                sd = (load_pth_state_dict(path, _PTH_KEYS[name])
                      if name in _PTH_KEYS else load_pth_state_dict(path))
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
            if name == "cgan":  # no torch cGAN is shipped (as in JAX)
                logger.info("[cgan] no torch checkpoint (%s); the Keras "
                            "backend serves when its weights load", e)
            else:
                logger.warning("[%s] checkpoint not loaded (%s). Using "
                               "random init for that backend.", name, e)
        except Exception as e:  # a PRESENT but unloadable checkpoint
            logger.warning("[%s] checkpoint failed to load (%s). Using "
                           "random init for that backend.", name, e)

    # -- the forward (_build_forward:278-301, _dispatch_forward:303-407) ----
    def _served(self, name: str, route: str):
        """``(obj, fwd)``: what serves ``name`` — the int8 forward where the
        ladder built one, else the float model — and ``fwd(obj, x)``, its
        forward by ``route`` on NHWC f32 in the family's domain (``obj``
        or a replica of it on a mesh device)."""
        self.ladder(name)
        qapply = self._qapply.get(name)
        if qapply is None:
            return self._model(name), lambda m, x: m(
                x.permute(0, 3, 1, 2), route=route).permute(0, 2, 3, 1)
        if isinstance(qapply, quant_unet.QuantizedDenoiseUNet):
            return qapply, lambda q, x: q(x, route=route)
        if route == "plain":
            raise ValueError("the generic int8 rung has no plain route")
        return qapply, lambda q, x: q(x)

    def _apply(self, name: str, route: str):
        """The model's forward on NHWC f32 in the family's domain."""
        obj, fwd = self._served(name, route)
        return lambda x: fwd(obj, x)

    def _mesh_size(self) -> int:
        return 0 if self.mesh is None else self.mesh.shape["data"]

    def _mesh_replicas(self, name: str, obj) -> list:
        """``obj`` (what serves ``name``) on each device of the mesh's
        ``data`` axis, built once and shared by the sharded and the
        data-parallel paths; the entry on the server's own device is
        ``obj`` itself."""
        key = (name, "float" if obj is self._model(name) else "int8")
        if key not in self._replicas:
            with self._mesh_lock:
                if key not in self._replicas:
                    home = torch.empty(0, device=self.device).device
                    self._replicas[key] = replicate(obj, self.mesh,
                                                    home=home)
        return self._replicas[key]

    def _big_route(self, shape) -> tuple:
        """How an input of NHWC ``shape`` runs (JAX's rule, :316-359):
        ``(None, None)`` whole (under the threshold, or over it with tiling
        off and no shard), ``("sharded", dim)`` over the mesh along
        ``dim`` (1 the height, preferred, or 2), ``("tiled", None)``."""
        over_h = shape[1] > self.tile_threshold_rows
        over_w = shape[2] > self.tile_threshold_rows
        if not (over_h or over_w):
            return None, None
        n_dev = self._mesh_size()
        if n_dev > 1 and (not self.use_tiling or not (over_h and over_w)):
            for dim, over in ((1, over_h), (2, over_w)):
                if over and shape[dim] % n_dev == 0:
                    return "sharded", dim
        return ("tiled", None) if self.use_tiling else (None, None)

    def _sharded(self, name: str, dim: int, route: str):
        """The forward over the mesh's devices, ``dim`` cut into one strip
        per device."""
        obj, fwd = self._served(name, route)
        cfg = self._cfg(name)
        return spatial_sharded_apply(
            obj, self.mesh, spatial_dim=dim, apply_fn=fwd, halo=TILE_HALO,
            scale=cfg.get("scale", 1),
            multiple=1 if cfg["normalize"] is None else 4,
            replicas=self._mesh_replicas(name, obj))

    def _to_u8(self, name: str, y: torch.Tensor) -> torch.Tensor:
        """The served output map: clip(y·0.5+0.5) in the tanh domain, clip(y)
        in [0, 1]; ×255, truncated."""
        y01 = y * 0.5 + 0.5 if self._tanh(name) else y
        return (torch.clamp(y01, 0.0, 1.0) * 255.0).to(torch.uint8)

    def _tiler(self, name: str, over_h: bool, over_w: bool, route: str):
        """The tiled forward for inputs over the threshold on these axes: a
        width tiler nested inside the height tiler when both are."""
        fn = self._apply(name, route)
        cfg = self._cfg(name)
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
        output map on the card (the batcher's fence copies it back).  With a
        mesh of more than one device: padded to a multiple of its size by
        repeating the last row, split over the devices, cropped back."""
        n_dev = self._mesh_size()
        if n_dev <= 1:
            apply = self._apply(name, "kernel")

            def dispatch(xs: torch.Tensor) -> torch.Tensor:
                with span("cid.batch.forward"), torch.inference_mode():
                    return self._to_u8(name, apply(xs))
            return dispatch

        obj, fwd = self._served(name, "kernel")
        dp = data_parallel_apply(
            obj, self.mesh, apply_fn=lambda r, x: self._to_u8(name, fwd(r, x)),
            replicas=self._mesh_replicas(name, obj))

        def dispatch_dp(xs: torch.Tensor) -> torch.Tensor:
            n = xs.shape[0]
            rem = (-n) % n_dev
            with span("cid.batch.forward"):
                if rem:
                    xs = torch.cat([xs, xs[-1:].expand(rem, *xs.shape[1:])])
                with torch.inference_mode():
                    return dp(xs)[:n]
        return dispatch_dp

    def _forward(self, name: str, x: torch.Tensor, plain: bool = False
                 ) -> np.ndarray:
        """(N, H, W, 3) float32 on the device, in the family's domain →
        (N, H·s, W·s, 3) uint8 on the host, truncated;
        through the int8 forward where one was built; sharded over the mesh
        or tiled when H or W is over ``tile_threshold_rows``
        (``_big_route``); through the micro-batcher for a batch-1 input
        that runs whole when micro-batching is on (whose fence, not this
        thread, brings the output to the host: no download span then)."""
        route = "plain" if plain else "kernel"
        label = "float" if self.ladder(name) is None else "int8"
        big, dim = self._big_route(x.shape)
        if big is not None and not self._cfg(name).get("tiles", True):
            raise EnhanceError(
                400, f"Image too large for {name}: its attention spans the "
                     f"whole image, so no tile or strip of it gives the same "
                     f"answer; inputs over {self.tile_threshold_rows} rows "
                     f"or columns (after padding) are refused, got "
                     f"{x.shape[1]}x{x.shape[2]}")
        # the label is this thread's: a micro-batch may run in another
        self._path_note.value = label + ("" if big is None else "+" + big)
        with span("cid.request.forward"):
            if big is None and not plain and self.batchers is not None \
                    and x.shape[0] == 1:
                batcher = self.batchers.get((name, tuple(x.shape[1:])),
                                            self._batched_dispatch(name))
                return batcher(x)
            if big == "sharded":
                fn = self._sharded(name, dim, route)
            elif big == "tiled":
                fn = self._tiler(name, x.shape[1] > self.tile_threshold_rows,
                                 x.shape[2] > self.tile_threshold_rows, route)
            else:
                fn = self._apply(name, route)
            with torch.inference_mode():
                u8 = self._to_u8(name, fn(x))
        with span("cid.request.download"):
            # the host's pages of the output, faulted in while the card
            # still computes: a pageable copy into fresh pages holds the
            # card's stream until the host has faulted each one in (3.1 MB
            # at 1024²: 1.7 ms of copy against 0.45 on an H100's host)
            out = torch.zeros(u8.shape, dtype=u8.dtype)
            return out.copy_(u8).numpy()

    def _padding(self, name: str, h: int, w: int):
        """(left, top, right, bottom) padding of an (h, w) input, to the
        family's divisor or ``bucket_divisor`` if that is larger."""
        cfg = self._cfg(name)
        divisor = max(cfg["pad_divisor"], self.bucket_divisor or 0)
        return get_padding((w, h), divisor, cfg.get("scale", 1))

    def _input_shape(self, name: str, h: int, w: int):
        """The forward's (H, W) for an (h, w) upload: padded, or as it is
        for the [0, 1] families that do not pad."""
        if not self._pads(name):
            return h, w
        pl_, pt_, pr_, pb_ = self._padding(name, h, w)
        return h + pt_ + pb_, w + pl_ + pr_

    @staticmethod
    def _domain_table(name: str) -> np.ndarray:
        """The family's serving domain of each uint8 value 0..255 (256
        float32): ``_served_input``'s conversion, elementwise, so gathering
        it gives that conversion's bits for every pixel."""
        x01 = imageio.to_float01(np.arange(256, dtype=np.uint8))
        norm = ServeState._cfg(name)["normalize"]
        if norm is None:
            return x01
        mean, std = norm
        return imageio.normalize(x01, mean[0], std[0])

    def _to_domain(self, name: str, u8: torch.Tensor, pads) -> torch.Tensor:
        """The forward's (1, H, W, 3) f32 input from the (h, w, 3) uint8
        image ``u8`` on the device: zero-padded by ``pads`` (left, top,
        right, bottom) where the family pads, then mapped through its
        table (``_domain_table``); equal to ``_served_input``'s first
        output.  Runs in the span ``cid.request.to_domain``."""
        with span("cid.request.to_domain"):
            if self._pads(name):
                pl_, pt_, pr_, pb_ = pads
                u8 = torch.nn.functional.pad(u8, (0, 0, pl_, pr_, pt_, pb_))
            x = self._tables[name].index_select(0, u8.reshape(-1).int())
            return x.view(1, *u8.shape)

    def _served_input(self, name: str, image: np.ndarray):
        """(the forward's (1, H, W, 3) f32 input, its [0, 1] view, the crop
        box of the original (left, top, right, bottom)), on the host: the
        analysis figure's view (``_input_view``); a request's input is
        ``_to_domain``'s, the same bits."""
        h, w = image.shape[:2]
        pl_, pt_, pr_, pb_ = self._padding(name, h, w)
        cfg = self._cfg(name)
        if not self._pads(name):  # dncnn, esrgan: [0, 1], unpadded
            x01 = imageio.to_float01(image)
            x = x01
        else:
            x01 = imageio.to_float01(np.pad(image, ((pt_, pb_), (pl_, pr_),
                                                    (0, 0))))
            x = x01
            if cfg["normalize"] is not None:
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
        or 4× its padded size for srgan; ``"cgan"`` is the Keras cGAN.
        ``plain`` runs the kernels' plain versions (the reference on the
        card).  The host handles uint8 only: the image goes to the device
        as it is and is mapped there (``_to_domain``), and the forward's
        uint8 output is served as it is, cropped where the family is.
        Runs in the span ``cid.request``, its stages in theirs
        (``utils/profiling.py::SPANS``)."""
        with span("cid.request"):
            with span("cid.request.prepare"):
                h, w = image.shape[:2]
                pads = self._padding(model, h, w)
                box = (pads[0], pads[1], pads[0] + w, pads[1] + h)
                u8 = torch.from_numpy(np.ascontiguousarray(image))
            with span("cid.request.upload"):
                xt = self._to_domain(model, u8.to(self.device), pads)
            which = KERAS if model == "cgan" else model
            y = self._forward(which, xt, plain=plain)
            with span("cid.request.finish"):
                return _pil_crop(y[0], box) if model in _CROPPED else y[0]

    def _cgan_torch(self, image: np.ndarray, label: Optional[int],
                    cond_bytes: Optional[bytes]) -> np.ndarray:
        """The torch cGAN's answer (:838-852): a 64×64 image from a fresh
        latent and ``label``, cropped at the padding offsets of ``image``
        (Pillow's ``crop``: shifted, zeros past the border)."""
        if cond_bytes is not None:  # the reference's channel fault
            raise EnhanceError(500, "Image enhancement failed")
        n_classes = self.models["cgan"].n_classes
        if not 0 <= label < n_classes:
            # checked on the host: on the card an index out of the table
            # trips a device-side assert that no later request survives
            raise EnhanceError(400, f"label must be in 0..{n_classes - 1}")
        seed = int.from_bytes(os.urandom(8), "little")
        z = torch.randn((1, 100), generator=torch.Generator().manual_seed(
            seed)).to(self.device)
        cond = torch.tensor([int(label)], device=self.device)
        with torch.inference_mode():
            y = self.models["cgan"](z, cond)
            y01 = torch.clamp(y * 0.5 + 0.5, 0.0, 1.0)[0].permute(1, 2, 0)
        self._path_note.value = "float"
        y_u8 = (y01.cpu().numpy() * 255).astype(np.uint8)
        h, w = image.shape[:2]
        pl_, pt_, _, _ = self._padding("cgan", h, w)
        return _pil_crop(y_u8, (pl_, pt_, pl_ + w, pt_ + h))

    def _input_view(self, image: np.ndarray, model: str, out_hw):
        """The analysis figure's view of the input beside an output of
        ``out_hw`` (:770-828): cropped as the output is, or for srgan the
        input bicubic-upscaled to the output's size."""
        _, x01, box = self._served_input(model, image)
        x_u8 = (np.clip(x01, 0, 1) * 255).astype(np.uint8)
        if model in _CROPPED:
            return _pil_crop(x_u8, box)
        if model == "srgan":
            return imageio.resize_bicubic_u8(_pil_crop(x_u8, box),
                                             (out_hw[1], out_hw[0]))
        return x_u8

    def warmup(self, sizes=((256, 256),), models=None) -> None:
        """Serve each (H, W) input size once per model (sizes before
        padding; ``denoise_image`` on a zero image) so that first requests
        do not pay for the kernels' build (nvcc at first use) or a first
        launch at their shapes, the input's map included: a size over the
        threshold runs its tile shapes (or its strips over the mesh).  With
        micro-batching on, also every batch size the batcher can dispatch
        at that padded shape (the pow2 series up to ``microbatch_max``, the
        cap included; with a mesh each padded to a multiple of its size and
        split over it), for the sizes the batcher serves (those that run
        whole).  ``models``: only
        these families (default: every family, as the JAX
        ``warmup(models=None)``).  dncnn and esrgan run unpadded; cgan
        warms its Keras generator (the torch one draws from a latent, at one
        shape)."""
        for h, w in sizes:
            for name in FAMILIES:
                if models is not None and name not in models:
                    continue
                which = name
                if name == "cgan":
                    if self.keras_cgan is None:
                        continue
                    which = KERAS
                hh, ww = self._input_shape(name, h, w)
                whole = self._big_route((1, hh, ww, 3))[0] is None
                if not (whole or self._cfg(name).get("tiles", True)):
                    continue  # refused at this size (``_forward``)
                t0 = time.perf_counter()
                self.denoise_image(np.zeros((h, w, 3), np.uint8), name)
                if self.batchers is not None and whole:
                    dispatch = self._batched_dispatch(which)
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
            "models": list(FAMILIES),
            "default_backends": {
                name: ("keras" if self.keras_cgan is not None else "torch")
                + " (configurable)" if name == "cgan" else "torch"
                for name in FAMILIES},
        }

    def healthz(self) -> dict:
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += f" ({torch.cuda.get_device_name(self.device)})"
        return {
            "status": "ok",
            "device": dev,
            "models": list(FAMILIES),
            "weights_loaded": sorted(self._weights_loaded),
            "quantize": self.quantize,
            "int8_rungs": dict(self.int8_rung),
            "int8_gate_db": dict(self.int8_gate_db),
            "uptime_s": self.stats.uptime_s(),
        }

    # -- the enhance endpoint -------------------------------------------------
    def enhance(self, model: str, file_bytes: bytes,
                content_type: str = "image/png", cgan_backend: str = "auto",
                label: Optional[int] = None,
                cond_bytes: Optional[bytes] = None,
                include_graph: bool = True) -> dict:
        """Stats are recorded here, so library callers are counted too;
        errors carry the ``_stats_recorded`` marker so front ends never
        double count."""
        t_start = time.perf_counter()
        model_key = str(model).strip().lower()
        try:
            result = self._enhance_impl(model_key, file_bytes, content_type,
                                        cgan_backend, label, cond_bytes,
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
                      cgan_backend: str, label: Optional[int],
                      cond_bytes: Optional[bytes], include_graph: bool
                      ) -> dict:
        t_start = time.perf_counter()
        if model not in FAMILIES:
            raise EnhanceError(
                400, f"Unknown model '{model}'. Choose one of "
                     f"{list(FAMILIES)}")
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
            use_keras = model == "cgan" and (
                cgan_backend == "keras"
                or (cgan_backend == "auto" and self.keras_cgan is not None))
            if model == "cgan" and not use_keras:
                if cond_bytes is None and label is None:
                    raise EnhanceError(400, "cGAN requires either a label or "
                                            "condition image")
                y_u8 = self._cgan_torch(image, label, cond_bytes)
            elif use_keras and self.keras_cgan is None:
                raise RuntimeError("cgan_backend=keras, but the Keras cGAN "
                                   "did not load")
            else:
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
                "backend": "keras" if use_keras else "torch",
            }
        except EnhanceError:
            raise
        except Exception as e:
            logger.error("Enhancement failed: %s", e, exc_info=True)
            raise EnhanceError(500, "Image enhancement failed")
