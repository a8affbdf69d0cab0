"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Nothing
here falls back: asking for CUDA on a machine without it raises, so a run
that was meant for the card can never quietly measure or serve on the host.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_CUDNN_LOCK = threading.Lock()
_cudnn_scopes = [0, False]  # scopes open, the flag before the first


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the length of a ``with``: the
    same inputs give the same sums at every call.  The flag is the
    process's, so scopes open in several threads share it: the first to
    enter sets it, the last to leave puts back what it was (a forward of
    another model that overlaps such a scope runs deterministic too)."""
    with _CUDNN_LOCK:
        if _cudnn_scopes[0] == 0:
            _cudnn_scopes[1] = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
        _cudnn_scopes[0] += 1
    try:
        yield
    finally:
        with _CUDNN_LOCK:
            _cudnn_scopes[0] -= 1
            if _cudnn_scopes[0] == 0:
                torch.backends.cudnn.deterministic = _cudnn_scopes[1]
