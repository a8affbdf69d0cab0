"""Serving CLI of the port: the /enhance API on the stdlib server, on the
card by default.

    python -m celebrity_image_denoiser_tpu_torch.cli.serve --quantize off

Port of ``celebrity_image_denoiser_tpu/cli/serve.py``.  ``--quantize``
keeps the JAX CLI's default of int8, which is not ported yet: without
``--quantize off`` the command stops with an error rather than serving
float under an int8 flag.  ``--framework``, ``--precompile``,
``--spatial-shard`` and micro-batching are not ported yet.
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
    p.add_argument("--tile-threshold-rows", type=int, default=2048,
                   help="inputs taller or wider than this are refused (400): "
                        "tiled inference is not ported yet")
    p.add_argument("--quantize", default="int8", choices=["off", "int8"],
                   help="'off': float32 forwards (the ported path).  'int8' "
                        "(the JAX CLI's default) is not ported yet and "
                        "stops with an error")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) raises when no card "
                        "is visible, 'cpu' runs the plain PyTorch versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from celebrity_image_denoiser_tpu_torch.serve.app import run_server
    from celebrity_image_denoiser_tpu_torch.serve.handlers import ServeState

    state = ServeState(weights_dir=args.weights_dir,
                       tile_threshold_rows=args.tile_threshold_rows,
                       quantize=None if args.quantize == "off"
                       else args.quantize,
                       device=args.device)
    run_server(args.host, args.port, state=state)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
