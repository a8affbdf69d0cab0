"""srgan's stage-2 frontier sweep: the port's counterpart of
``scripts/srgan_frontier.sh``.

    python -m celebrity_image_denoiser_tpu_torch.cli.srgan_frontier \\
        --out runs/sr_sweep [--pretrain-steps 120000] [--device cpu]

One stage-1 pretrain, cached in ``<out>/stage1``, then three adversarial
fine-tunes from it, each through
``cli.train_serving_weights`` into ``<out>/<tag>``, whose ``meta.json``
(held-out gain over bicubic, perceptual distances, fixture and battery
gains) is printed after it:

* A_shipped — ``--steps 1000 --finetune-lr 2e-5``;
* B_ema — A with ``--ema 0.995``;
* C_gentle — ``--steps 400 --finetune-lr 1e-5 --pixel-anchor 2.0``.

A point that fails is reported and the sweep goes on; the exit code is 1
if any failed.
"""

from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import List, Tuple

from celebrity_image_denoiser_tpu_torch.cli import train_serving_weights

POINTS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("A_shipped", ("--steps", "1000", "--finetune-lr", "2e-5")),
    ("B_ema", ("--steps", "1000", "--finetune-lr", "2e-5", "--ema",
               "0.995")),
    ("C_gentle", ("--steps", "400", "--finetune-lr", "1e-5",
                  "--pixel-anchor", "2.0")),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="srgan stage-2 frontier sweep")
    p.add_argument("--pretrain-steps", type=int, default=120000)
    p.add_argument("--out", required=True,
                   help="sweep directory: one <out>/<tag> per point")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when no card is present) or "
                        "cpu")
    return p


def point_argv(args, tag: str, extra) -> List[str]:
    """The ``cli.train_serving_weights`` arguments of one point."""
    return ["--family", "srgan", "--batch", "16", "--size", "128",
            "--pretrain-steps", str(args.pretrain_steps),
            "--pretrain-ckpt", os.path.join(args.out, "stage1"),
            "--out", os.path.join(args.out, tag), *extra,
            "--device", args.device]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    failed = []
    for tag, extra in POINTS:
        print(f"=== frontier point: {tag} ===", flush=True)
        try:
            res = train_serving_weights.run(point_argv(args, tag, extra))
        except Exception:  # the sweep goes on, as the shell script's
            traceback.print_exc()
            failed.append(tag)
            continue
        print(f"--- meta: {os.path.join(args.out, tag, 'srgan')}")
        print(json.dumps(res["meta"], indent=1), flush=True)
    print("frontier sweep complete" + (f"; failed: {failed}" if failed
                                       else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
