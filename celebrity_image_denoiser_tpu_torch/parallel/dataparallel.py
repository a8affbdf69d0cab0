"""Data parallelism over a serving mesh: a replica per device, dim 0 split
over the ``data`` axis.

Counterpart of ``celebrity_image_denoiser_tpu/parallel/dataparallel.py``
(:19-43).  The JAX functions place arrays with a sharding and let jit run
the per-chip forwards; here one process holds a replica of the module per
entry of the mesh's ``data`` axis and launches each chunk's forward on its
replica's device (on that device's current stream, so the forwards of
distinct cards overlap), then gathers the outputs on the first device.  A
forward is per-sample independent, so the result equals the unsplit
forward's.  Training data parallelism is ``train/gan_trainer.py``'s
``mesh=`` over a process group instead (``parallel/mesh.py``).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional

import torch

from celebrity_image_denoiser_tpu_torch.parallel.mesh import Mesh


def nhwc_forward(module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW module's forward on NHWC ``x``."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data"
                ) -> List[torch.Tensor]:
    """``x`` split along dim 0 into one chunk per device of ``axis``, each
    on its device (dim 0 must divide by the axis size)."""
    devices = mesh.axis_devices(axis)
    if x.shape[0] % len(devices):
        raise ValueError(f"batch {x.shape[0]} is not divisible by the "
                         f"'{axis}' axis size {len(devices)}")
    return [c.to(d) for c, d in zip(x.chunk(len(devices)), devices)]


def replicate(module, mesh: Mesh, axis: Optional[str] = "data", *,
              home: Optional[torch.device] = None) -> list:
    """A copy of ``module`` (anything with ``.to(device)``: an
    ``nn.Module``, an int8 forward) on each device along ``axis`` (None:
    each entry of the mesh, flat); an entry that repeats a device gets a
    copy of its own all the same.  ``home``: the device ``module`` lives
    on; the first entry there takes ``module`` itself (a server's own
    weights are not copied onto their own card).  Built once, kept by the
    caller; made outside inference mode even when called inside it, so that
    the replicas' tensors are ordinary ones, as the original's are."""
    devices = (list(mesh.devices.flat) if axis is None
               else mesh.axis_devices(axis))
    own = devices.index(home) if home in devices else -1
    with torch.inference_mode(False):
        return [module if k == own else copy.deepcopy(module).to(d)
                for k, d in enumerate(devices)]


def data_parallel_apply(model, mesh: Mesh, axis: str = "data",
                        apply_fn: Optional[Callable] = None,
                        replicas: Optional[list] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``fn(x)``: NHWC ``x`` split along dim 0 over ``axis`` (its
    size must divide by the axis size), each chunk run on its device's
    replica of ``model``, the outputs concatenated on the first device.
    ``apply_fn(replica, chunk) -> y`` is the forward (default: an NCHW
    module's, ``nhwc_forward``); the caller sets the mode (``.eval()``,
    ``inference_mode``).  ``replicas``: the caller's ``replicate(model,
    mesh, axis)``, built once (default: built here)."""
    if replicas is None:
        replicas = replicate(model, mesh, axis)
    fwd = apply_fn or nhwc_forward
    first = mesh.axis_devices(axis)[0]

    def fn(x: torch.Tensor) -> torch.Tensor:
        outs = [fwd(r, c) for r, c in zip(replicas, shard_batch(x, mesh,
                                                                  axis))]
        return torch.cat([y.to(first) for y in outs])

    return fn
