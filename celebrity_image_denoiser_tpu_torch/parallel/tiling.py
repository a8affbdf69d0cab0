"""Exact overlap-tiled inference on one device, for inputs too large to run
whole.

Port of ``celebrity_image_denoiser_tpu/parallel/tiling.py::
tiled_apply_single_device`` (:156-221).  Tensors are NHWC, as in the JAX
package: ``axis`` 1 tiles the height, 2 the width.

Each tile ``[start, stop)`` of ``tile_h`` rows (or columns) runs with
``halo`` rows of true context on either side, ``[max(start - halo, 0),
min(stop + halo, h))``, and its output is cropped back to ``[start,
stop)``.  Edge tiles end at the true image border, where the model applies
the same zero padding as on the whole image, and ``tile_h`` and ``halo``
are multiples of 4, so every tile meets the U-Net's two 2×2 pools on the
whole image's grid.  The result therefore equals the untiled forward when
the halo covers the receptive field: about 28 px for the denoise U-Net
(3×3 conv pairs at strides 1, 2 and 4 through the encoder and decoder);
the default halo is 32.

The multiple of 4 is the U-Net's (and srgan's, whose serving pads to 16).
dncnn and esrgan have no pooling and run unpadded, so any extent tiles
exactly for them: ``multiple=1``.  The JAX tiler asks for a multiple of 4
of every model, so the JAX server answers 500 to a dncnn or esrgan input
over the threshold whose extent is not one (``ROADMAP.md`` queue 3).

A tile taken along the height of a batch-1 NHWC tensor is contiguous; one
taken along the width is not, and the kernel wrappers refuse such input, so
every tile is made contiguous (a copy for width tiles) before it runs.

The tiles take at most four distinct shapes: the first, the middle ones,
the last, and the one before the last when the last is shorter than the
halo (that tile's halo then runs into the border).  The JAX docstring says
three; its jit compiles one program per shape.

Not ported yet: ``tiled_apply`` (:64) with ``_exchange_halos`` (:45) and
``spatial_sharded_apply`` (:115), which need a mesh (``ROADMAP.md`` queue
1, item 7).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def tiled_apply_single_device(
        model: Optional[torch.nn.Module] = None, *, tile_h: int = 256,
        halo: int = 32, scale: int = 1,
        apply_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        axis: int = 1, multiple: int = 4
        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``fn(x)``: ``x`` (N, H, W, C) → the stitched (N, H·scale,
    W·scale, C') output of the per-tile forward.

    ``apply_fn(tile) -> y`` is the per-tile forward on NHWC tensors: the
    server passes its int8 forward here, or a width tiler to nest inside a
    height tiler for an input too large on both axes.  Default: ``model``
    (an NCHW module) in eval mode.  ``scale`` is the model's spatial scale
    factor; the crop is scaled on the output side.  The tiled extent, ``tile_h``
    and ``halo`` must be multiples of ``multiple``: 4 for a model with the
    U-Net's two 2×2 pools (serving pads first), 1 for one without pooling."""
    if halo % 4 != 0 or tile_h % 4 != 0:
        raise ValueError("halo and tile_h must be divisible by 4")
    if multiple not in (1, 4):
        raise ValueError(f"multiple must be 1 or 4, got {multiple}")
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (height) or 2 (width), got {axis}")
    if tile_h <= 0:
        raise ValueError(f"tile_h must be positive, got {tile_h}")
    if apply_fn is None:
        if model is None:
            raise ValueError("pass a model or an apply_fn")

        def apply_fn(t: torch.Tensor) -> torch.Tensor:
            return model(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def fn(x: torch.Tensor) -> torch.Tensor:
        h = x.shape[axis]
        if h % multiple != 0:
            raise ValueError(f"axis-{axis} extent {h} must be divisible by "
                             f"{multiple} (pad first)")
        outs = []
        for start in range(0, h, tile_h):
            stop = min(start + tile_h, h)
            lo, hi = max(start - halo, 0), min(stop + halo, h)
            y = apply_fn(x.narrow(axis, lo, hi - lo).contiguous())
            outs.append(y.narrow(axis, (start - lo) * scale,
                                 (stop - start) * scale))
        return torch.cat(outs, dim=axis)

    return fn
