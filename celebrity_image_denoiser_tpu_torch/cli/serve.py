"""Serving CLI of the port: the /enhance API on the stdlib server, on the
card by default.

    python -m celebrity_image_denoiser_tpu_torch.cli.serve

Port of ``celebrity_image_denoiser_tpu/cli/serve.py``: ``POST
/enhance?model=denoise|cgan|srgan|esrgan|dncnn``.  ``--quantize`` keeps the JAX
CLI's default of int8: each family is served through the first rung of its
ladder that passes the runtime agreement gate (denoise: the s8
skip-storage program; every family: the generic transform; esrgan: then
the trunk-float policy; ``serve/handlers.py``); ``--quantize off`` serves
the float32 forwards.  Inputs taller or wider than
``--tile-threshold-rows`` are tiled exactly (restormer refuses them: its
attention spans the whole image); ``--microbatch-ms`` coalesces
concurrent same-shape requests into one batch; ``--precompile`` runs the
given sizes for every family (and, with micro-batching, every batch size)
before the server listens, as the JAX ``warmup(models=None)`` does.
``--spatial-shard`` serves over a mesh of every card of the machine
(``parallel/mesh.py::make_mesh``): inputs over the threshold whose extent
divides by the card count are cut into one strip per card, and
micro-batches are split over the cards; with one card visible it logs the
JAX CLI's warning and serves with the single-device tiler (:74-88).  Not
ported: ``--framework fastapi`` and ``--compilation-cache`` (XLA's).
"""

from __future__ import annotations

import argparse

import torch

from celebrity_image_denoiser_tpu_torch.utils.logging import get_logger

logger = get_logger("cid_torch.serve")


def build_parser():
    p = argparse.ArgumentParser(description="Serve the unified GAN API "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--weights-dir", default=None,
                   help="default: ./weights if it holds checkpoints, else "
                        "the repo's committed weights/")
    p.add_argument("--precompile", default=None,
                   help="comma-separated HxW sizes to run at start-up for "
                        "every family (e.g. 256x256,512x512): builds the "
                        "kernels and launches every shape those sizes need "
                        "before the first request")
    p.add_argument("--spatial-shard", action="store_true",
                   help="serve over a mesh of every visible card: tall or "
                        "wide inputs cut into one exact strip per card, "
                        "micro-batches split over the cards")
    p.add_argument("--tile-threshold-rows", type=int, default=2048,
                   help="inputs taller or wider than this (after padding) "
                        "are served by exact tiling, in tiles of this many "
                        "rows or columns with a 32-pixel halo (restormer, "
                        "whose attention spans the image, refuses them)")
    p.add_argument("--microbatch-ms", type=float, default=None,
                   help="coalesce concurrent same-shape requests into one "
                        "batch, waiting up to this many ms (off by default)")
    p.add_argument("--microbatch-max", type=int, default=16,
                   help="the largest micro-batch")
    p.add_argument("--quantize", default="int8", choices=["off", "int8"],
                   help="'int8' (default, as in the JAX CLI): each "
                        "family's int8 ladder — the s8 skip-storage program "
                        "(denoise), the generic transform, the trunk-float "
                        "policy (esrgan), then float, behind a 40 dB "
                        "agreement gate; 'off': float32 forwards")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is visible, 'cpu' runs the plain PyTorch versions")
    return p


def _parse_sizes(parser, spec):
    sizes = []
    for tok in spec.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        parts = tok.split("x")
        if len(parts) != 2 or not all(p.isdigit() for p in parts):
            parser.error(f"--precompile expects HxW sizes like 256x256, "
                         f"got {tok!r}")
        sizes.append((int(parts[0]), int(parts[1])))
    return sizes


def build_mesh(args):
    """The serving mesh of ``--spatial-shard``: every card, or None (with
    the JAX CLI's warning) where one device is visible."""
    if not args.spatial_shard:
        return None
    from celebrity_image_denoiser_tpu_torch.parallel import make_mesh

    on_card = torch.device(args.device).type == "cuda"
    if on_card and torch.cuda.device_count() > 1:
        return make_mesh()
    logger.warning("--spatial-shard requested but only 1 device is visible "
                   "— tall inputs will use the sequential single-device "
                   "tiler")
    return None


def build_state(args):
    """The ``ServeState`` of parsed ``args``."""
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    return ServeState(weights_dir=args.weights_dir,
                      tile_threshold_rows=args.tile_threshold_rows,
                      mesh=build_mesh(args),
                      microbatch_window_ms=args.microbatch_ms,
                      microbatch_max=args.microbatch_max,
                      quantize=None if args.quantize == "off"
                      else args.quantize,
                      device=args.device)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    sizes = _parse_sizes(parser, args.precompile) if args.precompile else None
    from celebrity_image_denoiser_tpu_torch.serve.app import run_server

    run_server(args.host, args.port, state=build_state(args),
               precompile=sizes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
