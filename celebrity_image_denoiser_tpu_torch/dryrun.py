"""A dry run of every multi-device path of the port, at a toy size.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` (:99-220) of the
JAX package:

    python -m celebrity_image_denoiser_tpu_torch.dryrun 4 [--device cpu]

``dryrun_multichip(n)`` spawns ``n`` gloo ranks that take one
data-parallel step of the denoise GAN on the fly (``make_train_step(mesh=)``
over ``parallel/mesh.py::process_mesh``, a global batch of ``2n`` at 16²)
and, when ``n ≥ 4`` is even, one step over a ``("replica", "data")`` mesh of
``(2, n/2)``; then, in this process, runs the serving paths over a mesh of
``n`` entries of ``device``: the exact spatial shard, the single-exchange
halo tiling, and the float32 and int8 data-parallel micro-batches through
``ServeState.enhance``.  Random weights; each result must be finite, and
the micro-batches must have run their data-parallel dispatch.  It runs on
the card unless the caller passes ``device="cpu"`` (``--device cpu``), and
raises where CUDA is absent.  On a card the ranks share it (gloo carries
CUDA tensors for the step's all-reduces and broadcasts; NCCL refuses two
ranks on one card).
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import tempfile

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
from celebrity_image_denoiser_tpu_torch.train.gan_trainer import (
    make_train_step,
)

SIZE = 16  # the dry run's image side


def _denoise_step(mesh, device, n_shares, share) -> float:
    """One on-the-fly denoise step over ``mesh`` on this rank's share of a
    global batch of ``2·n_shares``; returns the global g_loss."""
    gen = torch.Generator().manual_seed(0)
    g = DenoiseGenerator(generator=gen).to(device)
    d = DenoiseDiscriminator(generator=gen).to(device)
    init_fn, step_fn = make_train_step(g, d, family="denoise", mesh=mesh,
                                       on_the_fly_noise=True)
    batch = 2 * n_shares
    clean = torch.from_numpy(np.linspace(
        0, 255, batch * SIZE * SIZE * 3).astype(np.uint8).reshape(
            batch, SIZE, SIZE, 3))[2 * share:2 * share + 2].to(device)
    noise_gen = torch.Generator(device=device).manual_seed(1)
    m = step_fn(init_fn(), None, clean, noise_gen, 1e-4, 1e-4)
    loss = float(m["g_loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite g_loss {loss}")
    return loss


def _rank(rank: int, n: int, init: str, device: str, out: str) -> None:
    """One rank of the dry run's training steps (spawned)."""
    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        mesh = parallel.process_mesh()
        res = {"g_loss": _denoise_step(mesh, dev, n, rank)}
        if n >= 4 and n % 2 == 0:
            mesh2 = parallel.process_mesh((2, n // 2), ("replica", "data"))
            res["g2_loss"] = _denoise_step(mesh2, dev, n,
                                           parallel.mesh.shard_index(mesh2))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _png(h: int, w: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _serving(n: int, device: torch.device) -> dict:
    """The serving paths over a mesh of ``n`` entries of ``device``."""
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    mesh = parallel.make_mesh(devices=[device] * n)
    g = DenoiseGenerator(generator=torch.Generator().manual_seed(2))
    g = g.to(device).eval()
    x = torch.zeros((1, SIZE * n, SIZE, 3), device=device)
    res = {}
    with torch.inference_mode():
        y = parallel.spatial_sharded_apply(g, mesh)(x)
        y_halo = parallel.tiled_apply(g, mesh, halo=8)(x)
    for name, t in (("sharded", y), ("halo", y_halo)):
        if tuple(t.shape) != tuple(x.shape) or not bool(torch.isfinite(
                t).all()):
            raise RuntimeError(f"{name}: {tuple(t.shape)}, finite "
                               f"{bool(torch.isfinite(t).all())}")
        res[name] = list(t.shape)
    with tempfile.TemporaryDirectory() as empty:  # random weights
        for quantize in (None, "int8"):
            st = ServeState(weights_dir=empty, seed=0, mesh=mesh,
                            microbatch_window_ms=1.0, microbatch_max=n,
                            quantize=quantize, device=device)
            r = st.enhance("denoise", _png(SIZE, SIZE), "image/png",
                           include_graph=False)
            backend = st.last_compute_backend()
            if not r["denoised_image_base64"]:
                raise RuntimeError(f"{quantize}: an empty response")
            if not st._replicas:
                raise RuntimeError(f"{quantize}: the data-parallel "
                                   "micro-batch dispatch was not built")
            if quantize and not backend.startswith("int8"):
                raise RuntimeError(f"the int8 leg served {backend!r}")
            res[f"backend_{quantize or 'float'}"] = backend
    return res


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run over ``n_devices`` ranks and mesh entries on
    ``device``; returns what each part gave (raises on a failure)."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.spawn(_rank, args=(n_devices, f"file://{tmp}/pg", str(dev), out),
                 nprocs=n_devices, join=True)
        with open(out) as f:
            res = json.load(f)
    res.update(_serving(n_devices, dev))
    print(f"dryrun_multichip({n_devices}): ok — g_loss={res['g_loss']:.4f}, "
          f"2-axis g_loss={res.get('g2_loss', float('nan')):.4f}, sharded "
          f"out {tuple(res['sharded'])}, halo-tiled out "
          f"{tuple(res['halo'])}, int8-dp serving backend="
          f"{res['backend_int8']}", flush=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Dry-run the port's multi-device "
                                            "paths at a toy size")
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
