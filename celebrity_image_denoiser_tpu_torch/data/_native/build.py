"""Build the port's native loader (``loader.cpp``, g++) into a shared
library under ``celebrity_image_denoiser_tpu_torch/_build/`` (listed in
``.gitignore``; nothing is written into the package tree), with the JAX
package's flags, so both compute the same floats on one host.  The file is
named by a hash of the source, the flags and the host's CPU (``-march=native``
code runs only where it was built), so an unchanged checkout on one host
reuses it and an edited one, or another host, rebuilds.  The compiler is
``$CXX``, else ``g++``.  Run it
directly to build (``--force`` rebuilds):

    python -m celebrity_image_denoiser_tpu_torch.data._native.build
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path

SRC = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-pthread")


def _host() -> bytes:
    """The machine and its CPU's feature flags (Linux), which
    ``-march=native`` compiles for."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")),
                         "")
    except OSError:
        pass
    return (platform.machine() + flags).encode()


def output_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_host())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libcid_native_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """The library's path, compiled unless it exists (or always with
    ``force``); raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    out = output_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}_{threading.get_ident()}"
    cmd = [os.environ.get("CXX", "g++"), *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"native loader build failed: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader build failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
