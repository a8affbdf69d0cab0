"""Device meshes: one process over several devices for serving, one
process per rank for training.

Counterpart of ``celebrity_image_denoiser_tpu/parallel/mesh.py``.  The JAX
package has one kind of mesh, a ``jax.sharding.Mesh`` that a single
controller jits over.  The port follows PyTorch's two idioms:

* ``Mesh`` (``make_mesh``) — the serving mesh: an n-d array of
  ``torch.device``s of this process with axis names.  The server holds one
  weight replica per entry and runs each shard on its entry's device and
  stream (``parallel/dataparallel.py``, ``parallel/tiling.py``).  A device
  may appear more than once: ``make_mesh(devices=["cuda:0"] * 4)`` runs four
  shards on one card, each on its own replica — the counterpart of the JAX
  tests' 8 virtual CPU devices, which shows the sharding's exactness on a
  machine with fewer cards (not its speed).
* ``process_mesh`` — the training mesh: a ``torch.distributed.device_mesh.
  DeviceMesh`` over the initialised process group, one process per rank
  (DDP's idiom: NCCL between cards, gloo on the CPU; ``torch.distributed.run``
  launches the ranks).  ``("replica", "data")`` makes it 2-D, as in JAX.

JAX's ``replicated(mesh)`` and ``batch_sharding(mesh)`` are shardings that
jit places arrays by; PyTorch has no such object.  Functions take their
place: ``dataparallel.replicate`` (a copy of a module per entry) and
``dataparallel.shard_batch`` (per-entry chunks of dim 0) on the serving
mesh; on the training mesh each rank's pipeline assembles its own share of
the batch (``data/pipeline.py``, ``rank``/``world``), ``shard_index`` and
``shard_count`` say which, and ``axis_groups`` are the groups the
gradients and the BatchNorm statistics are summed over.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """``devices``: an n-d object array of ``torch.device``; ``axis_names``
    one name per dimension.  ``shape`` maps each name to its size, as
    ``jax.sharding.Mesh.shape`` does (``mesh.shape["data"]``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices, axis names "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str = "data") -> list:
        """The devices along ``axis`` (at index 0 of every other axis)."""
        d = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(d.reshape(d.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _default_devices() -> list:
    """Every CUDA device; raises where there is none (name the CPU
    explicitly to run there)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_mesh() found no CUDA device; pass "
                           "devices=['cpu', ...] to build a mesh on the host")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",), devices=None) -> Mesh:
    """A mesh over every CUDA device, or over ``devices`` (names or
    ``torch.device``s, repeats allowed): the first ``prod(shape)`` of them
    in row-major order.  Default shape: all of them along the first axis,
    1 along the others (``mesh.py:19-34``)."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _default_devices())]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)


def process_mesh(shape: Optional[Tuple[int, ...]] = None,
                 axis_names: Sequence[str] = ("data",)):
    """A ``DeviceMesh`` over the initialised default process group: every
    rank along the first axis by default; ranks laid out row-major, so a
    rank's coordinates flatten to its rank.  Each rank's device is
    ``cuda:LOCAL_RANK`` on NCCL (set as the current device by the caller)
    and the CPU on gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("process_mesh() needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover the world of "
                         f"{world} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def axis_groups(mesh) -> tuple:
    """The process groups of every axis of a ``DeviceMesh``: a sum over
    each in turn is the sum over the whole mesh."""
    return tuple(mesh.get_group(name) for name in mesh.mesh_dim_names)


def shard_count(mesh) -> int:
    """How many shares a batch is cut into on a ``DeviceMesh``: one per rank
    (JAX's ``P(("replica", "data"))`` on a 2-D mesh)."""
    return int(mesh.size())


def shard_index(mesh) -> int:
    """This rank's share of the batch: its coordinates flattened row-major."""
    return int(np.ravel_multi_index(tuple(mesh.get_coordinate()),
                                    tuple(mesh.shape)))
