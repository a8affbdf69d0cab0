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
``--tile-threshold-rows`` are tiled exactly; ``--microbatch-ms`` coalesces
concurrent same-shape requests into one batch; ``--precompile`` runs the
given sizes for every family (and, with micro-batching, every batch size)
before the server listens, as the JAX ``warmup(models=None)`` does.  Not ported: ``--spatial-shard`` (needs a mesh), ``--framework
fastapi`` and ``--compilation-cache`` (XLA's).
"""

from __future__ import annotations

import argparse


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
    p.add_argument("--tile-threshold-rows", type=int, default=2048,
                   help="inputs taller or wider than this (after padding) "
                        "are served by exact tiling, in tiles of this many "
                        "rows or columns with a 32-pixel halo")
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


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    sizes = _parse_sizes(parser, args.precompile) if args.precompile else None
    from celebrity_image_denoiser_tpu_torch.serve.app import run_server
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    state = ServeState(weights_dir=args.weights_dir,
                       tile_threshold_rows=args.tile_threshold_rows,
                       microbatch_window_ms=args.microbatch_ms,
                       microbatch_max=args.microbatch_max,
                       quantize=None if args.quantize == "off"
                       else args.quantize,
                       device=args.device)
    run_server(args.host, args.port, state=state, precompile=sizes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
