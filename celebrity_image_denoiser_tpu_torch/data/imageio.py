"""Host-side image decode/encode and normalization helpers.

Port of ``celebrity_image_denoiser_tpu/data/imageio.py`` (``imread_rgb:20``,
``encode_png_base64:71``, ``to_float01:88``, ``normalize:93``) for a host
that may have no Pillow: PNG always goes through a small codec written on
the standard library's ``zlib`` and ``struct``:

* decode: 8-bit, non-interlaced greyscale, grey+alpha, RGB or RGBA, all
  five row filter types (None, Sub, Up, Average, Paeth), CRCs checked;
* encode: RGB (or grey / RGBA) with filter None, zlib level 1 — lossless
  either way, and the level the JAX server chose for latency (:83-84).

Other formats (JPEG, BMP, …) import PIL inside the branch that needs them;
without PIL such a request fails like any undecodable upload.

``resize_bicubic_u8`` is Pillow's ``Image.resize(size, BICUBIC)`` on 8-bit
images, bit for bit, for the two places the JAX server and its quality
fixture call it (srgan's analysis view, ``serve/handlers.py:825-828``, and
its fixture, ``serve/quality.py:77-89``).
"""

from __future__ import annotations

import base64
import io
import struct
import zlib

import numpy as np

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


def imread_rgb(data: bytes) -> np.ndarray:
    """Encoded image bytes → uint8 RGB HWC.  PNG through the codec above; any
    other format through PIL, imported here only."""
    if data.startswith(PNG_SIGNATURE):
        return _to_rgb(decode_png(data))
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


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


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter, a = -0.5."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(in_size: int, out_size: int):
    """Per output sample: the first input sample and the fixed-point
    weights (``precompute_coeffs`` and ``normalize_coeffs_8bpc``)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    k = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _pil_bicubic((np.arange(xmax) + xmin - center + 0.5)
                         / filterscale)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        f = w * (1 << _PIL_PRECISION_BITS)
        k[xx, :xmax] = np.where(w < 0, -0.5 + f, 0.5 + f).astype(np.int64)
        first[xx] = xmin
    return first, k


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's separable resample along ``axis`` (uint8 in and
    out: each pass rounds and clips)."""
    in_size = img.shape[axis]
    first, k = _pil_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    src = np.concatenate([src, np.zeros((k.shape[1],) + src.shape[1:],
                                        np.int64)])
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PIL_PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        acc += src[first + j] * k[:, j].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic_u8(img: np.ndarray, size) -> np.ndarray:
    """uint8 (H, W[, C]) → (h, w[, C]) for ``size`` = (w, h) (PIL's order),
    as Pillow's ``Image.resize(size, Image.BICUBIC)``: the horizontal pass
    first, then the vertical one, each in 22-bit fixed point."""
    w, h = size
    out = img
    if out.shape[1] != w:
        out = _pil_pass(out, w, 1)
    if out.shape[0] != h:
        out = _pil_pass(out, h, 0)
    return out
