"""Benchmark CLI (counterpart of ``celebrity_image_denoiser_tpu/cli/
bench.py``): runs the port's bench (``celebrity_image_denoiser_tpu_torch/
bench.py::main``), which prints one JSON line; it needs the card and raises
without one.  ``--help`` answers without touching a device."""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from celebrity_image_denoiser_tpu_torch import bench

    argparse.ArgumentParser(
        description="Run the headline bench (128² denoises/sec on the card, "
                    "the bf16 step and the int8 ladder) and print one JSON "
                    "line {metric, value, unit, vs_baseline}."
    ).parse_args(argv)
    bench.main()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
