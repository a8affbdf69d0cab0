"""The comparison that decides ``correct``.

A traffic loop's ``State.compare(reference)`` returns the numbers it
compared, ``{name: value}``; ``judge`` holds each number that the
configuration's ``limits`` name against its limit, ``{"max": x}`` (at most
x) or ``{"min": y}`` (at least y).  A limited number that the loop did not
give fails, and a configuration without limits is never correct, so what
is compared is the configuration's to say, not this file's.

``ImageTally`` is the serving loops' comparison: served uint8 images
against the plain reference's, image by image.  Its number compared is the
worst image's mean absolute difference in counts (``worst_image_mad``): a
mean over each image's pixels is steady from seed to seed where a maximum
over single pixels is not, and taking the worst image catches one answer
that is wrong.  ``images_compared`` counts the images; ``share_off_by_2``
(the share of values that differ by more than one count, over all images)
and the largest single difference are printed beside them.
"""

from __future__ import annotations

import torch

RELATIONS = {"max": "<=", "min": ">="}


class ImageTally:
    """Accumulates the comparison of served images with the reference's."""

    def __init__(self):
        self.images = 0
        self.values = 0
        self.off_by_2 = 0
        self.worst_mad = 0.0
        self.max_abs = 0

    def add(self, got: torch.Tensor, ref: torch.Tensor) -> None:
        """``got`` and ``ref``: (N, H, W, C) uint8, on one device."""
        if got.shape != ref.shape:
            raise ValueError(f"served shape {tuple(got.shape)} is not the "
                             f"reference's {tuple(ref.shape)}")
        d = (got.to(torch.int16) - ref.to(torch.int16)).abs()
        per_image = d.flatten(1).float().mean(dim=1)
        self.images += d.shape[0]
        self.values += d.numel()
        self.off_by_2 += int((d > 1).sum())
        self.worst_mad = max(self.worst_mad, float(per_image.max()))
        self.max_abs = max(self.max_abs, int(d.max()))

    def numbers(self) -> dict:
        return {"worst_image_mad": self.worst_mad,
                "share_off_by_2": self.off_by_2 / max(self.values, 1),
                "max_abs_counts": self.max_abs,
                "images_compared": self.images}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "relation", "ok"}} for each limited
    number."""
    out = {}
    for name, limit in limits.items():
        if len(limit) != 1 or next(iter(limit)) not in RELATIONS:
            raise ValueError(f"limit of {name!r} is {limit!r}; expected "
                             '{"max": x} or {"min": y}')
        (kind, bound), = limit.items()
        value = numbers.get(name)
        ok = value is not None and (value <= bound if kind == "max"
                                    else value >= bound)
        out[name] = {"value": value, "limit": bound,
                     "relation": RELATIONS[kind], "ok": ok}
    return out
