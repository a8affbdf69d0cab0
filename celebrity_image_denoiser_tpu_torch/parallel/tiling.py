"""Big inputs: exact overlap tiling on one device, and the two mesh paths.

Port of ``celebrity_image_denoiser_tpu/parallel/tiling.py``: 
``tiled_apply_single_device`` (:156-221), ``spatial_sharded_apply``
(:115-153) and ``tiled_apply`` with ``_exchange_halos`` (:45-112).
Tensors are NHWC, as in the JAX package: ``axis`` 1 tiles the height, 2
the width.

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

The mesh paths run on a serving mesh (``parallel/mesh.py::Mesh``), shard
``k`` on the device of entry ``k`` along ``axis`` with a replica of its own
(``parallel/dataparallel.py::replicate``); the output is gathered on the
first device.

* ``spatial_sharded_apply`` — the exact path.  JAX jits the forward with
  the image sharded and lets XLA insert a halo exchange at every conv and
  pool; the port does not replay that.  Shard ``k`` runs on its strip
  plus ``halo`` (32) rows of true context on either side, clipped at the
  image border, and is cropped back: the single-device tiler's arithmetic
  spread over devices, so the output equals the untiled forward bit for
  bit.  The strip bounds are multiples of ``multiple``: the JAX server's
  routing only asks that the extent divide by the device count, and 2052
  rows over 4 devices would give 513-row strips off the U-Net's 2×2-pool
  grid, so the strips may differ in height.
* ``tiled_apply`` — the single-exchange path: strips of equal height, each
  device receives its neighbours' ``halo`` boundary rows by one
  device-to-device copy (``_exchange_halos``, JAX's ``ppermute``) and the
  outer edges get zeros, exactly as in JAX.  Interior seams are exact when
  the halo covers the receptive field; the outer band of about 28 rows
  deviates from the untiled forward as JAX's does (the zeros are not the
  per-layer padding after the first bias and ReLU).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from celebrity_image_denoiser_tpu_torch.parallel.dataparallel import (
    nhwc_forward,
    replicate,
)
from celebrity_image_denoiser_tpu_torch.parallel.mesh import Mesh

# the receptive field of every family: the U-Net's about 28 px, esrgan's
# 24, srgan's 18 input px, dncnn's 17 (the server's tiles take the same)
TILE_HALO = 32


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
        bounds = list(range(0, h, tile_h)) + [h]
        return torch.cat(_windows(x, axis, bounds, halo, scale,
                                  lambda k, t: apply_fn(t)), dim=axis)

    return fn


def _windows(x: torch.Tensor, axis: int, bounds: List[int], halo: int,
             scale: int, forward: Callable[[int, torch.Tensor], torch.Tensor]
             ) -> List[torch.Tensor]:
    """Tile ``k`` = ``[bounds[k], bounds[k + 1])`` along ``axis``, run by
    ``forward(k, window)`` over its window ``[lo - halo, hi + halo)``
    clipped to the image (made contiguous) and cropped back to ``[lo, hi)``
    (× ``scale`` on the output side): the crops, in order."""
    e = x.shape[axis]
    outs = []
    for k, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        wlo, whi = max(lo - halo, 0), min(hi + halo, e)
        y = forward(k, x.narrow(axis, wlo, whi - wlo).contiguous())
        outs.append(y.narrow(axis, (lo - wlo) * scale, (hi - lo) * scale))
    return outs


def strip_bounds(extent: int, n: int, multiple: int) -> List[int]:
    """``n + 1`` bounds cutting ``extent`` into ``n`` strips as equal as
    multiples of ``multiple`` allow (the last takes the remainder)."""
    if extent % multiple:
        raise ValueError(f"extent {extent} must be divisible by {multiple} "
                         "(pad first)")
    bounds = [(k * extent // n) // multiple * multiple for k in range(n)]
    bounds.append(extent)
    if any(b >= e for b, e in zip(bounds, bounds[1:])):
        raise ValueError(f"extent {extent} is too small for {n} strips of a "
                         f"multiple of {multiple}")
    return bounds


def spatial_sharded_apply(model, mesh: Mesh, *, axis: str = "data",
                          spatial_dim: int = 1,
                          apply_fn: Optional[Callable] = None,
                          halo: int = TILE_HALO, scale: int = 1,
                          multiple: int = 4, replicas: Optional[list] = None
                          ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``fn(x)``: NHWC ``x`` cut along ``spatial_dim`` (1 the height,
    2 the width) into one strip per device of ``axis``; strip ``k`` runs on
    device ``k``'s replica of ``model`` over ``[lo - halo, hi + halo)``
    clipped to the image, is cropped to ``[lo, hi)`` (× ``scale`` on the
    output side) and gathered on the first device.  Bit-equal to the
    untiled forward when ``halo`` covers the receptive field.

    ``apply_fn(replica, tile) -> y`` is the per-strip forward on NHWC
    tensors (the server passes its int8 forward's; default an NCHW
    module's).  ``multiple``: 4 for a model with the U-Net's two 2×2 pools,
    1 for one without pooling; the extent and ``halo`` must be multiples of
    it.  ``replicas``: the caller's ``replicate(model, mesh, axis)``, built
    once (default: built here)."""
    if spatial_dim not in (1, 2):
        raise ValueError(f"spatial_dim must be 1 (height) or 2 (width), "
                         f"got {spatial_dim}")
    if multiple not in (1, 4) or halo % multiple:
        raise ValueError(f"multiple must be 1 or 4 and divide halo {halo}, "
                         f"got {multiple}")
    devices = mesh.axis_devices(axis)
    if replicas is None:
        replicas = replicate(model, mesh, axis)
    fwd = apply_fn or nhwc_forward

    def fn(x: torch.Tensor) -> torch.Tensor:
        bounds = strip_bounds(x.shape[spatial_dim], len(devices), multiple)
        outs = _windows(x, spatial_dim, bounds, halo, scale,
                        lambda k, t: fwd(replicas[k], t.to(devices[k])))
        return torch.cat([y.to(devices[0]) for y in outs], dim=spatial_dim)

    return fn


def _exchange_halos(strips: List[torch.Tensor], halo: int
                    ) -> List[torch.Tensor]:
    """Per device, its (N, h, W, C) strip with its neighbours' ``halo``
    boundary rows above and below (copied to its device), zeros at the
    outer edges: (N, h + 2·halo, W, C) each (``_exchange_halos:45-61``)."""
    out = []
    for k, s in enumerate(strips):
        above = (strips[k - 1][:, -halo:].to(s.device) if k > 0
                 else torch.zeros_like(s[:, :halo]))
        below = (strips[k + 1][:, :halo].to(s.device)
                 if k + 1 < len(strips) else torch.zeros_like(s[:, -halo:]))
        out.append(torch.cat([above, s, below], dim=1))
    return out


def tiled_apply(model, mesh: Mesh, *, halo: int = TILE_HALO, scale: int = 1,
                axis: str = "data") -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``fn(x)``: NHWC ``x`` of height H (a multiple of n·4, n the
    size of ``axis``) cut into n strips of H/n rows, one per device; each
    takes its neighbours' ``halo`` rows (zeros at the image's top and
    bottom), runs ``model``'s replica on its device and keeps its own rows
    (× ``scale``): the stitched (N, H·scale, W·scale, C') output on the
    first device (``tiled_apply:64-112``); ``model`` is an NCHW module."""
    if halo % 4 != 0:
        raise ValueError(f"halo must be divisible by 4 (pooling alignment), "
                         f"got {halo}")
    devices = mesh.axis_devices(axis)
    n = len(devices)
    replicas = replicate(model, mesh, axis)

    def fn(x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        if h % (n * 4) != 0:
            raise ValueError(f"height {h} must be divisible by "
                             f"n_shards*4={n * 4}")
        if h // n < halo:
            raise ValueError(f"per-shard strip {h // n} < halo {halo}: use "
                             "fewer shards or a smaller halo")
        strips = [c.to(d) for c, d in zip(x.chunk(n, dim=1), devices)]
        outs = []
        for r, ext in zip(replicas, _exchange_halos(strips, halo)):
            y = nhwc_forward(r, ext.contiguous())
            outs.append(y[:, halo * scale:y.shape[1] - halo * scale])
        return torch.cat([y.to(devices[0]) for y in outs], dim=1)

    return fn
