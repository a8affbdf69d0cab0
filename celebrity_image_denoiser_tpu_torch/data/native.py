"""Python bindings of the port's native (C++) batch assembly.

Port of ``celebrity_image_denoiser_tpu/data/native.py``: ctypes over the
dependency-free library that ``data/_native/build.py`` compiles from the
port's copy of ``loader.cpp`` with g++ at first use.  ctypes releases the
GIL for the call, so the resize/assembly pool runs in parallel with the
Python decode threads.

* ``assemble_batch`` — uint8 HWC images of any sizes → a float32 NHWC
  batch, bicubic-resized and normalised to ``(x/255 - mean)/std`` (the
  paired datasets);
* ``assemble_batch_u8`` — the same resize into a uint8 NHWC batch, each
  image exactly as ``resize_u8`` gives it (the clean images of the
  on-the-fly path: the card normalises them);
* ``resize_u8`` — one image, uint8 to uint8.

The C++ bicubic is the antialiased Catmull-Rom of PIL's convention in float,
not Pillow's fixed-point passes: it stands within about 2 counts of
``imageio.resize_u8`` on average (``tests/test_native.py:31-41``), so the
python path (``imageio``) stays the bit-exact one.  ``axis_plan`` and
``assemble_batch_plain`` are the loader's own sampling plan and passes in
numpy, for the checks.

``available()`` is False when the library does not build (no compiler, or
a compile error); ``load()`` raises then, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from celebrity_image_denoiser_tpu_torch.data._native import build as _build
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.data.native")

VERSION = 2
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the last build or load failed


def load(rebuild: bool = False) -> ctypes.CDLL:
    """The loaded library (built on the first call, or anew with
    ``rebuild``), every entry's ``argtypes`` declared; raises
    ``RuntimeError`` when it does not build or load.  A failure is
    remembered: later calls raise it again until one asks to ``rebuild``."""
    global _lib, _error
    with _lock:
        if rebuild:
            _lib, _error = None, None
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            path = _build.build(force=rebuild)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _error = f"native loader unavailable: {e}"
            raise RuntimeError(_error) from e
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        IP = ctypes.POINTER(ctypes.c_int)
        lib.cid_assemble_batch.argtypes = [
            ctypes.POINTER(P), IP, IP, I, I, P, I, I, F, F, I]
        lib.cid_assemble_batch.restype = None
        lib.cid_assemble_batch_u8.argtypes = [
            ctypes.POINTER(P), IP, IP, I, I, P, I, I, I]
        lib.cid_assemble_batch_u8.restype = None
        lib.cid_resize_u8.argtypes = [P, I, I, P, I, I, I]
        lib.cid_resize_u8.restype = None
        lib.cid_version.argtypes = []
        lib.cid_version.restype = I
        if lib.cid_version() != VERSION:
            _error = (f"native loader {path} is version {lib.cid_version()}, "
                      f"expected {VERSION}")
            raise RuntimeError(_error)
        logger.info("native batch assembly loaded (%s)", path)
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
    except RuntimeError as e:
        logger.info("%s; using the python path", e)
        return False
    return True


def _threads(threads: Optional[int]) -> int:
    return threads or min(8, os.cpu_count() or 1)


def _sources(images: Sequence[np.ndarray], out_hw, dtype):
    """Checked, contiguous uint8 sources, their pointer arrays, and the
    output batch."""
    if not images:
        raise ValueError("no images to assemble")
    imgs = [np.ascontiguousarray(img, np.uint8) for img in images]
    c = imgs[0].shape[2] if imgs[0].ndim == 3 else 0
    for img in imgs:
        if img.ndim != 3 or img.shape[2] != c or min(img.shape) < 1:
            raise ValueError(f"images must be non-empty (H, W, {c}) uint8, "
                             f"got {img.shape}")
    out = np.empty((len(imgs), out_hw[0], out_hw[1], c), dtype)
    n = len(imgs)
    srcs = (ctypes.c_void_p * n)(*[img.ctypes.data for img in imgs])
    shs = (ctypes.c_int * n)(*[img.shape[0] for img in imgs])
    sws = (ctypes.c_int * n)(*[img.shape[1] for img in imgs])
    return imgs, srcs, shs, sws, c, out


def assemble_batch(images: List[np.ndarray], out_hw: Tuple[int, int],
                   mean: float = 0.5, std: float = 0.5,
                   threads: Optional[int] = None) -> np.ndarray:
    """uint8 HWC images (any sizes) → float32 NHWC batch, bicubic-resized to
    ``out_hw`` and normalised to ``(x/255 - mean)/std``, in parallel C++
    threads."""
    lib = load()
    imgs, srcs, shs, sws, c, out = _sources(images, out_hw, np.float32)
    lib.cid_assemble_batch(srcs, shs, sws, len(imgs), c, out.ctypes.data,
                           out_hw[0], out_hw[1], mean, std, _threads(threads))
    return out


def assemble_batch_u8(images: List[np.ndarray], out_hw: Tuple[int, int],
                      threads: Optional[int] = None) -> np.ndarray:
    """uint8 HWC images (any sizes) → uint8 NHWC batch, each image as
    ``resize_u8`` gives it, in parallel C++ threads."""
    lib = load()
    imgs, srcs, shs, sws, c, out = _sources(images, out_hw, np.uint8)
    lib.cid_assemble_batch_u8(srcs, shs, sws, len(imgs), c, out.ctypes.data,
                              out_hw[0], out_hw[1], _threads(threads))
    return out


def resize_u8(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """One uint8 HWC image → uint8 (out_hw[0], out_hw[1], C)."""
    lib = load()
    (img,), _, _, _, c, out = _sources([img], out_hw, np.uint8)
    lib.cid_resize_u8(img.ctypes.data, img.shape[0], img.shape[1],
                      out.ctypes.data, out_hw[0], out_hw[1], c)
    return out[0]


# ---- the loader's arithmetic in numpy, for the checks ----------------------

def _cubic(x: np.ndarray) -> np.ndarray:
    """Catmull-Rom (a = -0.5), float32, as ``cubic_weight``."""
    x = np.abs(x)
    near = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    far = (((np.float32(-0.5) * x + np.float32(2.5)) * x) - np.float32(4)) \
        * x + np.float32(2)
    return np.where(x < 1, near, np.where(x < 2, far, np.float32(0)))


def axis_plan(src_len: int, dst_len: int):
    """``make_plan``: per output sample its ``taps`` clamped source indices
    and normalised float32 weights, ``(idx, w)`` of shape (dst_len, taps)."""
    f32 = np.float32
    scale = f32(src_len) / f32(dst_len)
    filter_scale = max(scale, f32(1))
    support = f32(2) * filter_scale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(dst_len, dtype=f32) + f32(0.5)) * scale - f32(0.5)
    start = np.floor(center - support).astype(np.int64) + 1
    s = start[:, None] + np.arange(taps)[None, :]
    w = _cubic((s.astype(f32) - center[:, None]) / filter_scale)
    total = np.zeros(dst_len, f32)
    for k in range(taps):  # the C loop's order
        total = total + w[:, k]
    return np.clip(s, 0, src_len - 1), (w / total[:, None]).astype(f32)


def assemble_batch_plain(images: List[np.ndarray], out_hw: Tuple[int, int],
                         mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """``assemble_batch`` in numpy: the same plans and passes (vertical into
    a row, then horizontal), float32, taps summed in the C loop's order."""
    f32 = np.float32
    dh, dw = out_hw
    out = []
    for img in images:
        src = np.asarray(img, np.uint8).astype(f32)
        iy, wy = axis_plan(src.shape[0], dh)
        ix, wx = axis_plan(src.shape[1], dw)
        rows = np.zeros((dh,) + src.shape[1:], f32)
        for k in range(wy.shape[1]):
            rows = rows + wy[:, k, None, None] * src[iy[:, k]]
        acc = np.zeros((dh, dw, src.shape[2]), f32)
        for k in range(wx.shape[1]):
            acc = acc + wx[None, :, k, None] * rows[:, ix[:, k]]
        acc = np.clip(acc, f32(0), f32(255))
        out.append((acc * (f32(1) / f32(255)) - f32(mean))
                   * (f32(1) / f32(std)))
    return np.stack(out)
