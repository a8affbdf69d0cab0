"""Read Keras ``.keras`` checkpoints (Keras 3's zip) without TensorFlow and
without ``h5py``.

Port of ``celebrity_image_denoiser_tpu/ckpt/keras_import.py``
(``read_keras_file:40``, ``load_keras_model:76``).  The zip holds
``config.json`` (the layer order) and ``model.weights.h5``, whose datasets
``layers/<name>/vars/<i>`` are the layers' variables.  The JAX package reads
the HDF5 file with h5py; the port carries its own reader (``H5File``) for
the subset that Keras 3 writes through h5py's defaults, which is also what
the JAX package's ``ckpt/export.py::export_keras_cgan:125`` writes:

* superblock version 0 with 8-byte offsets and lengths;
* version-1 object headers (messages 8-byte aligned, continuation blocks);
* groups as symbol tables: a version-1 B-tree over symbol-table nodes
  (``SNOD``), the link names in the group's local heap;
* datasets of little-endian IEEE float32, contiguous and unfiltered.

Anything else (a chunked, compact or filtered dataset, another datatype, a
shared message, a newer superblock or new-style link groups) raises
``H5FormatError`` naming what it met.

``write_h5`` writes that same subset (``ckpt/export.py`` writes Keras
files with it; the card machine has no h5py): the members of a group sorted
by name in one symbol-table node under one B-tree node, so a group takes at
most 8 members (the superblock's leaf K of 4; a Keras weights file has at
most 8) and a larger one raises.

The layers land in the port's module by position (Keras' Sequential order
against the module's definition order), class and shape checked at every
step, as in the JAX loader: Conv2D kernels (kH, kW, I, O) and
Conv2DTranspose kernels (kH, kW, O, I) are the JAX package's layouts
verbatim, so they cross through ``ckpt/convert.py`` as JAX trees do
(→ OIHW and (I, O, kH, kW)); Dense kernels (I, O) → (O, I); a
BatchNormalization's ``gamma, beta, moving_mean, moving_variance`` → the
module's ``weight, bias, running_mean, running_var`` (Keras' moving
variance taken as it is).
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from celebrity_image_denoiser_tpu_torch.ckpt import convert
from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.ckpt.keras")

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
# object header message types
_MSG_NIL, _MSG_DATASPACE, _MSG_LINK_INFO, _MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
_MSG_LINK, _MSG_EXTERNAL, _MSG_LAYOUT, _MSG_GROUP_INFO = 0x6, 0x7, 0x8, 0xA
_MSG_FILTERS, _MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
_MSG_SHARED = 0x02  # message flag: the message lives elsewhere


class H5FormatError(ValueError):
    """The HDF5 file uses a feature outside the subset ``H5File`` reads."""


class H5File:
    """The HDF5 subset Keras 3 writes (see the module docstring), from bytes.
    ``file[path]`` is a numpy array for a dataset; ``file.list(path)`` the
    member names of a group, in the file's (sorted) order."""

    def __init__(self, buf: bytes):
        self.buf = bytes(buf)
        if self.buf[:8] != _SIGNATURE:
            raise H5FormatError("not an HDF5 file (no signature at offset 0)")
        version = self.buf[8]
        if version != 0:
            raise H5FormatError(f"superblock version {version}: only version "
                                "0 is read")
        if (self.buf[13], self.buf[14]) != (8, 8):
            raise H5FormatError(f"offsets of {self.buf[13]} and lengths of "
                                f"{self.buf[14]} bytes: only 8 and 8 are read")
        self.base = self._u64(24)
        # the root group's symbol-table entry: its object header at +8
        self.root = self._u64(56 + 8)

    # -- little-endian fields ------------------------------------------------
    def _u16(self, off: int) -> int:
        return struct.unpack_from("<H", self.buf, off)[0]

    def _u32(self, off: int) -> int:
        return struct.unpack_from("<I", self.buf, off)[0]

    def _u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self.buf, off)[0]

    def _at(self, addr: int, what: str) -> int:
        """A file address as an offset into the buffer, checked."""
        if addr == _UNDEFINED or self.base + addr >= len(self.buf):
            raise H5FormatError(f"{what} at an address outside the file "
                                f"({addr:#x})")
        return self.base + addr

    def _signature(self, off: int, sig: bytes, what: str) -> None:
        if self.buf[off:off + 4] != sig:
            raise H5FormatError(f"{what}: expected {sig!r} at {off:#x}, got "
                                f"{self.buf[off:off + 4]!r}")

    # -- object headers ------------------------------------------------------
    def _messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the version-1 object
        header at ``addr``, continuation blocks followed."""
        off = self._at(addr, "object header")
        if self.buf[off] != 1:
            raise H5FormatError(f"object header version {self.buf[off]} at "
                                f"{addr:#x}: only version 1 is read")
        # 12 bytes of prefix, padded to 16: the messages are 8-byte aligned
        blocks = [(off + 16, self._u32(off + 8))]
        out = []
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end:
                mtype, msize = self._u16(p), self._u16(p + 2)
                flags = self.buf[p + 4]
                data = self.buf[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _MSG_CONTINUATION:
                    blocks.append((self._at(struct.unpack_from("<Q", data)[0],
                                            "continuation block"),
                                   struct.unpack_from("<Q", data, 8)[0]))
                elif mtype != _MSG_NIL:
                    out.append((mtype, flags, data))
        for mtype, flags, _ in out:
            if mtype in (_MSG_LINK_INFO, _MSG_LINK, _MSG_GROUP_INFO):
                raise H5FormatError(f"a group with new-style links (message "
                                    f"{mtype:#x}) at {addr:#x}: only "
                                    "symbol-table groups are read")
            if mtype == _MSG_EXTERNAL:
                raise H5FormatError(f"a dataset in external files at "
                                    f"{addr:#x}")
            if mtype == _MSG_FILTERS:
                raise H5FormatError(f"a filtered (compressed) dataset at "
                                    f"{addr:#x}: only unfiltered data is read")
            if flags & _MSG_SHARED:
                raise H5FormatError(f"a shared message {mtype:#x} at "
                                    f"{addr:#x}")
        return out

    # -- groups --------------------------------------------------------------
    def _group(self, addr: int) -> Dict[str, int]:
        """name -> object header address of the members of the group whose
        object header is at ``addr``."""
        tables = [d for t, _, d in self._messages(addr)
                  if t == _MSG_SYMBOL_TABLE]
        if not tables:
            raise KeyError(f"the object at {addr:#x} is not a group")
        btree, heap = struct.unpack_from("<QQ", tables[0])
        h = self._at(heap, "local heap")
        self._signature(h, b"HEAP", "local heap")
        names = self._at(self._u64(h + 24), "local heap data")
        members: Dict[str, int] = {}
        self._walk_btree(btree, names, members)
        return members

    def _walk_btree(self, addr: int, names: int,
                    members: Dict[str, int]) -> None:
        off = self._at(addr, "B-tree node")
        self._signature(off, b"TREE", "group B-tree node")
        if self.buf[off + 4] != 0:
            raise H5FormatError(f"B-tree node type {self.buf[off + 4]} in a "
                                "group")
        level, used = self.buf[off + 5], self._u16(off + 6)
        # 24 bytes of header, then key, child, key, ..., key (8 bytes each)
        for i in range(used):
            child = self._u64(off + 24 + 8 + 16 * i)
            if level > 0:
                self._walk_btree(child, names, members)
                continue
            s = self._at(child, "symbol table node")
            self._signature(s, b"SNOD", "symbol table node")
            for j in range(self._u16(s + 6)):
                e = s + 8 + 40 * j
                start = names + self._u64(e)
                stop = self.buf.index(b"\0", start)
                members[self.buf[start:stop].decode()] = self._u64(e + 8)

    def _resolve(self, path: str) -> int:
        addr = self.root
        for part in [p for p in path.split("/") if p]:
            members = self._group(addr)
            if part not in members:
                raise KeyError(f"no member {part!r} in the path {path!r}")
            addr = members[part]
        return addr

    def list(self, path: str = "/") -> List[str]:
        return list(self._group(self._resolve(path)))

    def contains(self, path: str) -> bool:
        try:
            self._resolve(path)
        except KeyError:
            return False
        return True

    # -- datasets ------------------------------------------------------------
    def __getitem__(self, path: str) -> np.ndarray:
        addr = self._resolve(path)
        msgs = {t: d for t, _, d in self._messages(addr)}
        if _MSG_LAYOUT not in msgs:
            raise KeyError(f"{path!r} is not a dataset")
        shape = self._dataspace(msgs[_MSG_DATASPACE], path)
        dtype = self._datatype(msgs[_MSG_DATATYPE], path)
        lay = msgs[_MSG_LAYOUT]
        if lay[0] != 3:
            raise H5FormatError(f"{path}: layout message version {lay[0]}: "
                                "only version 3 is read")
        if lay[1] != 1:
            kind = {0: "compact", 2: "chunked"}.get(lay[1], str(lay[1]))
            raise H5FormatError(f"{path}: a {kind} dataset: only contiguous "
                                "datasets are read")
        data_addr, size = struct.unpack_from("<QQ", lay, 2)
        count = int(np.prod(shape, dtype=np.int64))
        if size != count * dtype.itemsize:
            raise H5FormatError(f"{path}: {size} bytes stored for {count} "
                                f"values of {dtype}")
        if count == 0:
            return np.zeros(shape, dtype)
        off = self._at(data_addr, f"{path} data")
        if off + size > len(self.buf):
            raise H5FormatError(f"{path}: data runs past the end of the file")
        return np.frombuffer(self.buf, dtype, count, off).reshape(shape).copy()

    @staticmethod
    def _dataspace(d: bytes, path: str) -> Tuple[int, ...]:
        version, rank = d[0], d[1]
        if version == 1:
            first = 8
        elif version == 2:
            first = 4
        else:
            raise H5FormatError(f"{path}: dataspace version {version}")
        return tuple(struct.unpack_from(f"<{rank}Q", d, first))

    @staticmethod
    def _datatype(d: bytes, path: str) -> np.dtype:
        cls, size = d[0] & 0x0F, struct.unpack_from("<I", d, 4)[0]
        # a float: byte order bit 0 of the class bits; then bit offset,
        # precision, exponent location and size, mantissa location and
        # size, exponent bias
        if cls == 1 and size == 4 and not d[1] & 1 and \
                struct.unpack_from("<HHBBBBI", d, 8) == (0, 32, 23, 8, 0, 23,
                                                         127):
            return np.dtype("<f4")
        raise H5FormatError(f"{path}: datatype class {cls} of {size} bytes "
                            "(bit fields " f"{d[1:4].hex()}): only "
                            "little-endian IEEE float32 is read")


_LEAF_K, _NODE_K = 4, 16  # symbol-table node and group B-tree node K
_MAX_MEMBERS = 2 * _LEAF_K  # one full symbol-table node
_F32_TYPE = (bytes([0x11, 0x20, 0x1F, 0x00]) + struct.pack("<I", 4)
             + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))


class _H5Writer:
    """Lays the file out front to back; ``alloc`` returns 8-byte aligned
    addresses (the base address is 0)."""

    def __init__(self):
        self.buf = bytearray(96)  # the superblock, written last

    def alloc(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += data + bytes(-len(data) % 8)
        return addr

    def patch(self, addr: int, data: bytes) -> None:
        self.buf[addr:addr + len(data)] = data

    @staticmethod
    def _header(messages) -> bytes:
        """A version-1 object header of ``(type, flags, data)`` messages,
        each padded to 8 bytes, plus a NIL message to a 32-byte minimum."""
        body = b""
        for mtype, flags, data in messages:
            data += bytes(-len(data) % 8)
            body += struct.pack("<HHB3x", mtype, len(data), flags) + data
        n = len(messages)
        if len(body) < 32:
            body += struct.pack("<HHB3x", _MSG_NIL, 24 - len(body), 0)
            body += bytes(32 - len(body))
            n += 1
        return struct.pack("<BBHII4x", 1, 0, n, 1, len(body)) + body

    def dataset(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype != np.dtype("<f4"):
            raise ValueError(f"only little-endian float32 datasets are "
                             f"written, got {arr.dtype}")
        data_addr = self.alloc(arr.tobytes()) if arr.size else _UNDEFINED
        rank = arr.ndim
        space = struct.pack("<BBBB4x", 1, rank, 1, 0) + struct.pack(
            f"<{2 * rank}Q", *arr.shape, *arr.shape)
        fill = bytes([2, 2, 2, 1]) + struct.pack("<I", 0)
        layout = struct.pack("<BBQQ", 3, 1, data_addr, arr.nbytes)
        return self.alloc(self._header([
            (_MSG_DATASPACE, 0, space), (_MSG_DATATYPE, 1, _F32_TYPE),
            (0x5, 1, fill), (_MSG_LAYOUT, 0, layout)]))

    def group(self, members: Dict[str, object]) -> Tuple[int, int, int]:
        """Write a group and everything under it; (object header, B-tree,
        local heap) addresses."""
        names = sorted(members, key=lambda n: n.encode())
        if len(names) > _MAX_MEMBERS:
            raise ValueError(f"a group of {len(names)} members: the writer "
                             f"takes at most {_MAX_MEMBERS}")
        entries = []
        for name in names:
            if not name or "/" in name or "." == name:
                raise ValueError(f"bad HDF5 link name {name!r}")
            v = members[name]
            if isinstance(v, dict):
                hdr, btree, heap = self.group(v)
                entries.append((hdr, 1, struct.pack("<QQ", btree, heap)))
            else:
                entries.append((self.dataset(np.asarray(v)), 0, bytes(16)))
        # the local heap: "" at offset 0, then each name, 8-byte padded
        heap_data, offsets = bytearray(8), []
        for name in names:
            offsets.append(len(heap_data))
            raw = name.encode() + b"\0"
            heap_data += raw + bytes(-len(raw) % 8)
        data_addr = self.alloc(bytes(heap_data))
        heap = self.alloc(b"HEAP" + bytes(4) + struct.pack(
            "<QQQ", len(heap_data), 1, data_addr))  # 1: no free block
        # one symbol-table node of up to 2·K entries under one B-tree node
        node = bytearray(b"SNOD" + struct.pack("<BBH", 1, 0, len(names)))
        for off, (hdr, cache, scratch) in zip(offsets, entries):
            node += struct.pack("<QQI4x", off, hdr, cache) + scratch
        node += bytes(8 + 40 * _MAX_MEMBERS - len(node))
        last = offsets[-1] if offsets else 0
        tree = bytearray(b"TREE" + struct.pack(
            "<BBHQQ", 0, 0, 1, _UNDEFINED, _UNDEFINED))
        tree += struct.pack("<QQQ", 0, self.alloc(bytes(node)), last)
        tree += bytes(24 + 8 * (4 * _NODE_K + 1) - len(tree))
        btree = self.alloc(bytes(tree))
        hdr = self.alloc(self._header([(_MSG_SYMBOL_TABLE, 0,
                                        struct.pack("<QQ", btree, heap))]))
        return hdr, btree, heap

    def finish(self, root: Dict[str, object]) -> bytes:
        hdr, btree, heap = self.group(root)
        self.patch(0, _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                   + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                   + struct.pack("<QQQQ", 0, _UNDEFINED, len(self.buf),
                                 _UNDEFINED)
                   + struct.pack("<QQI4xQQ", 0, hdr, 1, btree, heap))
        return bytes(self.buf)


def write_h5(tree: Dict[str, object]) -> bytes:
    """The HDF5 file of ``tree`` (nested dicts of float32 arrays, a dict a
    group, an array a dataset) in the subset ``H5File`` reads; a
    ``ValueError`` (nothing returned) for another dtype, a bad name or a
    group of more than 8 members."""
    return _H5Writer().finish(tree)


def read_keras_file(path: str) -> Tuple[List[dict], Dict[str, List[np.ndarray]]]:
    """(layer configs of ``config.json``, {layer name: [its variables in
    order]}) of a Sequential ``.keras`` file; layers without variables are
    left out of the dict."""
    with zipfile.ZipFile(path) as z:
        cfg = json.loads(z.read("config.json"))
        h5 = H5File(z.read("model.weights.h5"))
    layers = cfg["config"]["layers"]
    top = "layers" if h5.contains("layers") else ""
    weights: Dict[str, List[np.ndarray]] = {}
    for lname in h5.list(top or "/"):
        vpath = f"{top}/{lname}/vars"
        if not h5.contains(vpath):
            continue
        n = len(h5.list(vpath))
        if n:
            weights[lname] = [h5[f"{vpath}/{i}"] for i in range(n)]
    return layers, weights


# Keras class name -> the port's module class at the matching position
_PARAM_CLASSES = {
    "Conv2D": nn.Conv2d,
    "Conv2DTranspose": nn.ConvTranspose2d,
    "Dense": nn.Linear,
    "BatchNormalization": nn.BatchNorm2d,
}


def _param_leaves(module: nn.Module) -> List[Tuple[str, nn.Module]]:
    """(path, module) of the modules of a parameter class, in definition
    order."""
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, tuple(_PARAM_CLASSES.values()))]


def load_keras_model(module: nn.Module, keras_path: str) -> None:
    """Load a ``.keras`` file's weights into ``module`` in place, by
    position (Sequential order), checking class and shape at every step;
    nothing is loaded unless every layer fits."""
    layer_cfgs, weights = read_keras_file(keras_path)
    keras_layers = [(l["config"]["name"], l["class_name"]) for l in layer_cfgs
                    if l["class_name"] in _PARAM_CLASSES
                    and l["config"]["name"] in weights]
    ours = _param_leaves(module)
    if len(keras_layers) != len(ours):
        raise ValueError(f"layer-count mismatch: keras has {len(keras_layers)}"
                         f" parameterized layers, model has {len(ours)}")
    params: Dict[str, np.ndarray] = {}
    state: Dict[str, np.ndarray] = {}
    for (kname, kcls), (path, layer) in zip(keras_layers, ours):
        if not isinstance(layer, _PARAM_CLASSES[kcls]):
            raise ValueError(f"layer class mismatch at {path}: keras {kcls} "
                             f"vs {type(layer).__name__}")
        w = weights[kname]
        if kcls == "BatchNormalization":
            gamma, beta, mean, var = w
            params[f"{path}.scale"], params[f"{path}.bias"] = gamma, beta
            state[f"{path}.mean"], state[f"{path}.var"] = mean, var
            continue
        kernel = w[0]
        # the module's weight in the JAX (Keras) layout
        perm = (1, 0) if kernel.ndim == 2 else convert._KERNEL_PERM_BACK
        expect = tuple(layer.weight.shape[i] for i in perm)
        if tuple(kernel.shape) != expect:
            raise ValueError(f"kernel shape mismatch at {path}: keras "
                             f"{kernel.shape} vs {expect}")
        params[f"{path}.kernel"] = kernel
        if len(w) > 1:
            params[f"{path}.bias"] = w[1]
    with torch.no_grad():
        convert.load_jax_trees(module, params, state)
    logger.info("Loaded Keras weights from %s (%d layers)", keras_path,
                len(ours))
