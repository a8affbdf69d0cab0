"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  Nothing
here falls back: asking for CUDA on a machine without it raises, so a run
that was meant for the card can never quietly measure or serve on the host.
"""

from __future__ import annotations

import torch


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
