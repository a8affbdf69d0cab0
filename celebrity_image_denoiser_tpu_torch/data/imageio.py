"""Host-side image decode/encode and normalization helpers.

Port of ``celebrity_image_denoiser_tpu/data/imageio.py`` (``imread_rgb:20``,
``imwrite:57``, ``encode_png_base64:71``, ``to_float01:88``,
``normalize:93``, ``list_images:105``) for a host that may have no Pillow:
PNG always goes through a small codec written on the standard library's
``zlib`` and ``struct``:

* decode: 8-bit, non-interlaced greyscale, grey+alpha, RGB or RGBA, all
  five row filter types (None, Sub, Up, Average, Paeth), CRCs checked;
* encode: RGB (or grey / RGBA) with filter None, zlib level 1 — lossless
  either way, and the level the JAX server chose for latency (:83-84).

Other formats (JPEG, BMP, …) import PIL inside the branch that needs them;
without PIL such a request fails like any undecodable upload.

``resize_u8`` is Pillow's ``Image.resize(size, BICUBIC | LANCZOS)`` on
8-bit images, bit for bit: the same fixed-point separable passes, the
coefficients computed in the order Pillow's ``Resample.c`` computes them.
It serves ``imread_rgb``'s two Pillow methods (the datasets' and the
renderer's resize) and, as ``resize_bicubic_u8``, the two places the JAX
server and its quality fixture call Pillow (srgan's analysis view,
``serve/handlers.py:825-828``, and its fixture, ``serve/quality.py:77-89``).
``imread_rgb``'s third method, ``"cv2-linear"``, is the JAX function's path
where cv2 is not installed: the triangle filter without antialiasing
through ``ops/resize.py``.  The port never imports cv2 (the card machine
has none); where the JAX function finds cv2 it runs cv2's fixed-point
kernel instead, within 1 count of this one.
"""

from __future__ import annotations

import base64
import functools
import io
import math
import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit only; palette images are not supported)
_COLOR_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_CHANNELS_COLOR = {v: k for k, v in _COLOR_CHANNELS.items()}


def _unfilter(ftype: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Undo one row's PNG filter in place (RFC 2083 §6)."""
    n = len(line)
    if ftype == 0:
        return
    if ftype == 1:  # Sub: running sum per channel, mod 256
        a = np.frombuffer(bytes(line), np.uint8).reshape(-1, bpp)
        line[:] = np.cumsum(a, axis=0, dtype=np.uint8).tobytes()
    elif ftype == 2:  # Up
        line[:] = (np.frombuffer(bytes(line), np.uint8)
                   + np.frombuffer(prev, np.uint8)).tobytes()
    elif ftype == 3:  # Average
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:  # Paeth
        for i in range(n):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            line[i] = (line[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG: unknown filter type {ftype}")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 (H, W, C), C = 1, 2, 3 or 4 as stored.  Raises
    ``ValueError`` on anything malformed or outside the supported subset."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated (no IEND)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG: truncated chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG: bad CRC in {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _COLOR_CHANNELS:
        raise ValueError(f"PNG: only 8-bit grey/grey-alpha/RGB/RGBA is "
                         f"supported (depth {depth}, colour type {color})")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError("PNG: interlaced or non-standard PNGs are not "
                         "supported")
    bpp = _COLOR_CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG: image data does not match IHDR size")
    out = bytearray(h * stride)
    prev = bytes(stride)
    for y in range(h):
        start = y * (stride + 1)
        line = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter(raw[start], line, prev, bpp)
        out[y * stride:(y + 1) * stride] = line
        prev = bytes(line)
    return np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 1|2|3|4) → PNG bytes (filter None, zlib level
    1)."""
    a = np.asarray(arr, dtype=np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _CHANNELS_COLOR:
        raise ValueError(f"cannot encode an array of shape {a.shape} as PNG")
    h, w, c = a.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)  # column 0: filter type None
    raw[:, 1:] = a.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _CHANNELS_COLOR[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """Like PIL's ``convert('RGB')``: grey is repeated, alpha dropped."""
    c = img.shape[2]
    if c in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _decode_rgb(data: bytes) -> np.ndarray:
    """Encoded image bytes → uint8 RGB HWC.  PNG through the codec above; any
    other format through PIL, imported here only."""
    if data.startswith(PNG_SIGNATURE):
        return _to_rgb(decode_png(data))
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def imread_rgb(path_or_bytes, size: Optional[Tuple[int, int]] = None,
               method: str = "bicubic") -> np.ndarray:
    """Decode a file (a path) or encoded bytes to uint8 RGB HWC; with
    ``size`` = (w, h) (PIL's order), resize it by ``method``: "bicubic"
    (Pillow's BICUBIC, the reference's dataset resize), "lanczos" (Pillow's
    LANCZOS, a = 3), both bit-exact with Pillow (``resize_u8``), or
    "cv2-linear" (the triangle filter without antialiasing, rounded to
    uint8: the JAX function's path without cv2, ``ops.resize(arr, (h, w),
    "linear", antialias=False)``)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    arr = _decode_rgb(data)
    if size is None:
        return arr
    if method == "cv2-linear":
        import torch  # noqa: PLC0415 — this method only

        from celebrity_image_denoiser_tpu_torch.ops.resize import resize

        return resize(torch.from_numpy(arr.copy()), (size[1], size[0]),
                      "linear", antialias=False).numpy()
    if method not in _PIL_FILTERS:
        raise ValueError(f"unknown resize method {method!r}; choose from "
                         f"{sorted(_PIL_FILTERS) + ['cv2-linear']}")
    return resize_u8(arr, size, method)


def imwrite(path: str, arr: np.ndarray) -> None:
    """Save uint8 HWC RGB: PNG through the codec above; any other extension
    through PIL, imported here only."""
    arr = np.asarray(arr, dtype=np.uint8)
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        return
    from PIL import Image

    Image.fromarray(arr).save(path)


def list_images(root: str) -> List[str]:
    """Every file under ``root`` with an image extension, sorted."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def encode_png_base64(arr: np.ndarray) -> str:
    """uint8 HWC → base64 PNG string (serving contract ``to_base64_png``)."""
    return base64.b64encode(encode_png(arr)).decode("utf-8")


def to_float01(arr: np.ndarray) -> np.ndarray:
    """uint8 [0,255] → float32 [0,1] (torchvision ToTensor semantics)."""
    return np.asarray(arr, dtype=np.float32) / 255.0


def normalize(arr: np.ndarray, mean=0.5, std=0.5) -> np.ndarray:
    """[0,1] → [-1,1] with the reference's Normalize(0.5, 0.5)."""
    return (arr - mean) / std


_PIL_PRECISION_BITS = 32 - 8 - 2  # Pillow's Resample.c


def _pil_bicubic(x: float) -> float:
    """Pillow's ``bicubic_filter``, a = -0.5."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _pil_lanczos(x: float) -> float:
    """Pillow's ``lanczos_filter``: the sinc truncated by sinc(x / 3)."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


# method → (filter, support), as Pillow's filter table
_PIL_FILTERS = {"bicubic": (_pil_bicubic, 2.0),
                "lanczos": (_pil_lanczos, 3.0)}


@functools.lru_cache(maxsize=256)
def _pil_coeffs(in_size: int, out_size: int, method: str = "bicubic"):
    """Per output sample: the first input sample and the fixed-point
    weights (``precompute_coeffs`` and ``normalize_coeffs_8bpc``), each
    weight computed, summed and divided in Pillow's order.  Read-only: the
    cache hands the same arrays to every caller."""
    kernel, kernel_support = _PIL_FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = kernel_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    k = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        for x, v in enumerate(w):
            f = v * (1 << _PIL_PRECISION_BITS)
            k[xx, x] = int(-0.5 + f) if v < 0 else int(0.5 + f)
        first[xx] = xmin
    first.setflags(write=False)
    k.setflags(write=False)
    return first, k


def _pil_pass(img: np.ndarray, out_size: int, axis: int,
              method: str = "bicubic") -> np.ndarray:
    """One pass of Pillow's separable resample along ``axis`` (uint8 in and
    out: each pass rounds and clips)."""
    in_size = img.shape[axis]
    first, k = _pil_coeffs(in_size, out_size, method)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    src = np.concatenate([src, np.zeros((k.shape[1],) + src.shape[1:],
                                        np.int64)])
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        acc += src[first + j] * k[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_u8(img: np.ndarray, size, method: str = "bicubic") -> np.ndarray:
    """uint8 (H, W[, C]) → (h, w[, C]) for ``size`` = (w, h) (PIL's order),
    as Pillow's ``Image.resize(size, BICUBIC)`` or ``LANCZOS``
    (``method``): the horizontal pass first, then the vertical one, each in
    22-bit fixed point; an axis whose size does not change is not
    resampled."""
    w, h = size
    out = img
    if out.shape[1] != w:
        out = _pil_pass(out, w, 1, method)
    if out.shape[0] != h:
        out = _pil_pass(out, h, 0, method)
    return out


def resize_bicubic_u8(img: np.ndarray, size) -> np.ndarray:
    """``resize_u8`` with Pillow's BICUBIC."""
    return resize_u8(img, size, "bicubic")
