"""Multi-device walkthrough of the port: the three paths of ``parallel/``.
The counterpart of ``examples/multichip.py``.

    python -m celebrity_image_denoiser_tpu_torch.examples.multichip \\
        [--devices 4] [--ranks 2] [--device cpu]

1. data-parallel GAN training: ``--ranks`` processes, each stepping the
   denoise GAN on its share of the global batch over a ``torch.distributed``
   process group (``make_train_step(mesh=process_mesh())``: gradients and
   BatchNorm statistics summed over the ranks) — NCCL with a card per rank
   where the host has that many, else gloo (ranks sharing one card, or the
   CPU); its losses beside one process's over the whole batch;
2. the spatially sharded forward (``spatial_sharded_apply``): a tall image
   cut into one strip per mesh entry, each with 32 rows of true context —
   bit-equal to the forward on one device;
3. ``tiled_apply``: equal strips that take their neighbours' boundary rows
   in one exchange, zeros at the image's edges — bit-equal to one device
   away from the top and bottom bands, which differ as JAX's do.

The serving mesh names ``--devices`` entries: the host's cards when it has
that many, else its one card (or the CPU) that many times, which shows the
exactness of the sharding, not its speed.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from celebrity_image_denoiser_tpu_torch import parallel
from celebrity_image_denoiser_tpu_torch.core.device import resolve_device
from celebrity_image_denoiser_tpu_torch.models.denoise_unet import (
    DenoiseDiscriminator,
    DenoiseGenerator,
)
from celebrity_image_denoiser_tpu_torch.parallel.dataparallel import (
    nhwc_forward,
)
from celebrity_image_denoiser_tpu_torch.parallel.tiling import TILE_HALO
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
    make_train_step,
)

SIZE = 32  # the training images' side
STEPS = 2
LR = 1e-4


def global_batch(n: int) -> torch.Tensor:
    """The global uint8 batch of ``2·n`` images (seed 0)."""
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2 * n, SIZE, SIZE, 3), dtype=np.uint8))


def train_steps(device, clean_u8: torch.Tensor, mesh=None, share: int = 0,
                shares: int = 1):
    """``STEPS`` on-the-fly denoise steps of G and D (seed 0) on this
    share of ``clean_u8`` (all of it without a mesh), the noise of step
    ``i`` seeded ``i``; returns (G, [(g_loss, d_loss) per step])."""
    gen = torch.Generator().manual_seed(0)
    g = DenoiseGenerator(generator=gen).to(device)
    d = DenoiseDiscriminator(generator=gen).to(device)
    init_fn, step_fn = make_train_step(g, d, family="denoise", mesh=mesh,
                                       on_the_fly_noise=True)
    n = clean_u8.shape[0] // shares
    local = clean_u8[share * n:(share + 1) * n].to(device)
    opt = init_fn()
    losses = []
    for i in range(STEPS):
        m = step_fn(opt, None, local,
                    torch.Generator(device=device).manual_seed(i), LR, LR)
        losses.append(torch.stack([m["g_loss"], m["d_loss"]]))
    return g, torch.stack(losses).tolist()


def _tf32() -> tuple:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _rank(rank: int, n: int, init: str, backend: str, device: str,
          out: str, tf32: tuple = None) -> None:
    """One rank of path 1 (spawned, with the caller's TF32 flags, so that
    its arithmetic is the single process's); rank 0 writes the losses."""
    dev = torch.device(device if backend == "gloo" else f"cuda:{rank}")
    if tf32 is not None:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=n)
    try:
        mesh = parallel.process_mesh()
        _, losses = train_steps(dev, global_batch(n), mesh, rank, n)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(losses, f)
    finally:
        dist.destroy_process_group()


def data_parallel(n: int, device: torch.device) -> Dict[str, object]:
    """Path 1: ``n`` ranks against one process on the whole batch."""
    backend = ("nccl" if device.type == "cuda"
               and torch.cuda.device_count() >= n > 1 else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.spawn(_rank, args=(n, f"file://{tmp}/pg", backend, str(device),
                              out, _tf32()), nprocs=n, join=True)
        with open(out) as f:
            ranks = json.load(f)
    g, single = train_steps(device, global_batch(n))
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0], single[0])]
    return {"backend": backend, "ranks": ranks, "single": single,
            "first_step_rel": rel, "generator": g}


def sharded(g, mesh, x: torch.Tensor) -> Dict[str, float]:
    """Path 2: ``x`` over the mesh against one device."""
    with torch.inference_mode():
        y = parallel.spatial_sharded_apply(g, mesh)(x)
        ref = nhwc_forward(g, x)
    return {"max_abs_diff": float((y - ref).abs().max()),
            "shape": list(y.shape)}


def tiled(g, mesh, x: torch.Tensor, halo: int = TILE_HALO
          ) -> Dict[str, float]:
    """Path 3: ``tiled_apply`` against one device, inside the ``halo``-row
    bands at the top and bottom (``interior``, bit-equal when the halo
    covers the receptive field) and in them (``band``)."""
    with torch.inference_mode():
        y = parallel.tiled_apply(g, mesh, halo=halo)(x)
        diff = (y - nhwc_forward(g, x)).abs()
    return {"interior": float(diff[:, halo:-halo].max()),
            "band": float(max(diff[:, :halo].max(), diff[:, -halo:].max())),
            "finite": bool(torch.isfinite(y).all())}


def mesh_devices(n: int, device: torch.device) -> List[torch.device]:
    """``n`` cards where the host has them, else ``device`` ``n`` times."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device(f"cuda:{i}") for i in range(n)]
    return [device] * n


def run(devices: int = 4, ranks: int = 2, device="cuda") -> dict:
    """The three paths; returns what each gave."""
    dev = resolve_device(device)
    print(f"[0/3] ranks {ranks}, a serving mesh of {devices} entries "
          f"({dev.type})")
    dp = data_parallel(ranks, dev)
    g = dp.pop("generator").eval()
    print(f"[1/3] {dp['backend']} data-parallel over {ranks} ranks: g_loss "
          f"{dp['ranks'][-1][0]:.4f}; step 1 against one process, relative: "
          f"g {dp['first_step_rel'][0]:.2e}, d {dp['first_step_rel'][1]:.2e}")
    mesh = parallel.make_mesh(devices=mesh_devices(devices, dev))
    x = torch.rand((1, 64 * devices, SIZE, 3),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    sp = sharded(g, mesh, x)
    print(f"[2/3] spatially sharded forward of a {x.shape[1]}-row image: "
          f"max |sharded - one device| = {sp['max_abs_diff']:.1e}")
    tl = tiled(g, mesh, x)
    print(f"[3/3] halo-exchange tiled forward: interior max |tiled - one "
          f"device| = {tl['interior']:.1e}, edge bands {tl['band']:.1e}")
    return {"train": dp, "sharded": sp, "tiled": tl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4,
                    help="entries of the serving mesh")
    ap.add_argument("--ranks", type=int, default=2,
                    help="data-parallel training processes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when no card is present) or "
                         "cpu")
    args = ap.parse_args(argv)
    run(args.devices, args.ranks, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
