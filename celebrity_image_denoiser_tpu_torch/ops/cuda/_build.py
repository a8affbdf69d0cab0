"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface, so they are compiled by ``nvcc``
straight into one shared library and bound with ``ctypes`` — no PyTorch
headers, which keeps a cold build to seconds.  Each source is compiled by
its own ``nvcc`` process, all started together, then linked.

The library is built at first use into ``celebrity_image_denoiser_tpu_torch/
_build/`` (listed in ``.gitignore``), named by a hash of the sources and
flags, so an unchanged checkout reuses it and an edited one rebuilds.
Nothing here runs at import: the CPU tests import every module on a machine
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("conv3x3_bias_relu.cu", "double_conv3x3_relu.cu",
           "normalize_gaussian_noise.cu", "conv3x3_s8.cu", "convt2x2_s8.cu",
           "mma_probe.cu")
HEADERS = ("common.cuh", "mma.cuh", "conv_mma.cuh", "conv_s8.cuh",
           "noise.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Held by every kernel wrapper around its launcher's call and around its
# launch count.  The server's request threads launch kernels at the same
# time: a launcher sets its kernel's dynamic shared-memory limit for this
# launch and then launches, and another thread's launch of the same kernel
# in between runs against the wrong limit (CUDA error 701, "too many
# resources requested for launch"); and a bare ``+= 1`` on a module global
# can lose a count.
LAUNCH_LOCK = threading.Lock()


@dataclasses.dataclass
class BuildResult:
    path: Path
    seconds: float
    cached: bool
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand:
            p = Path(cand) / "bin" / "nvcc"
            if p.is_file():
                return str(p)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                       "the CUDA kernels can only be built where the CUDA "
                       "toolkit is installed")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in tuple(sources) + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build(sources=SOURCES, name: str = "cid_kernels") -> BuildResult:
    """Compile ``sources`` (in ``csrc/``; the kernel library's by default)
    into ``_build/lib<name>_<hash>.so`` unless that file exists; raise
    ``RuntimeError`` with nvcc's output on failure."""
    t0 = time.perf_counter()
    out = BUILD_DIR / f"lib{name}_{_digest(sources)}.so"
    if out.exists():
        return BuildResult(out, time.perf_counter() - t0, True, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{Path(src).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    logs, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    try:
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp = BUILD_DIR / f".{out.name}.{tag}"
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return BuildResult(out, time.perf_counter() - t0, False, "\n".join(logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every C entry
    point's ``argtypes``/``restype`` declared: pointers and the stream as
    ``c_void_p`` (a bare int would be cut to 32 bits), ints as ``c_int``,
    element counts, strides and seeds as 64-bit integers."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cid_conv3x3_bias_relu.argtypes = (
                [P] * 5 + [I] * 7 + [L] * 3 + [I, P])
            lib.cid_conv3x3_bias_relu.restype = I
            lib.cid_conv3x3_bias_relu_q8.argtypes = [P] * 5 + [I] * 6 + [P]
            lib.cid_conv3x3_bias_relu_q8.restype = I
            lib.cid_conv3x3_s8.argtypes = [P] * 7 + [I] * 8 + [L] * 3 + [P]
            lib.cid_conv3x3_s8.restype = I
            lib.cid_convt2x2_s8.argtypes = [P] * 6 + [I] * 6 + [P]
            lib.cid_convt2x2_s8.restype = I
            lib.cid_double_conv3x3_relu.argtypes = (
                [P] * 7 + [I] * 7 + [L] * 3 + [I, P])
            lib.cid_double_conv3x3_relu.restype = I
            lib.cid_normalize_gaussian_noise.argtypes = [
                P, P, ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_float,
                I, P]
            lib.cid_normalize_gaussian_noise.restype = I
            F = ctypes.c_float
            lib.cid_noise_batch.argtypes = (
                [P] * 4 + [ctypes.c_uint, P, ctypes.c_ulonglong, L, L, I, P,
                           P, I, I] + [F] * 8 + [I, P])
            lib.cid_noise_batch.restype = I
            lib.cid_probe_mma_sync.argtypes = [P] * 4
            lib.cid_probe_mma_sync.restype = I
            lib.cid_probe_wgmma.argtypes = [P] * 3 + [I, P]
            lib.cid_probe_wgmma.restype = I
            lib.cid_probe_mma_s8.argtypes = [P] * 4
            lib.cid_probe_mma_s8.restype = I
            lib.cid_probe_wgmma_s8.argtypes = [P] * 3 + [I, P]
            lib.cid_probe_wgmma_s8.restype = I
            lib.cid_probe_quantize.argtypes = [P, I, P, I, P, P]
            lib.cid_probe_quantize.restype = I
            lib.cid_error_string.argtypes = [I]
            lib.cid_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def dtype_code(dtype) -> int:
    """The C entry points' activation dtype code (common.cuh)."""
    import torch

    return {torch.float32: 0, torch.bfloat16: 1}[dtype]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = library().cid_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
