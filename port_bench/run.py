"""The port's benchmark: one run of one cell on the card.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` runs the
cell's own loop under the profiler for the traffic's ``trace_seconds`` and
reports its per-layer metrics.  Either way the outputs are then checked
against the plain reference, and the last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last: each
number compared beside its limit, which also end standard error).

Exits with 2 and prints no result where the card is missing; with 3, and
no result, where JAX or the JAX package is loaded once the run is over (its
window, comparison and readers), asked just before the result is printed;
with 1 on any other failure.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this directory: its modules are the package's
sys.path[0] = ROOT
CACHE = os.path.join(ROOT, "_bench_cache")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache of the program's libraries inside the checkout, at fixed
    # paths (the port's own nvcc build is in its package's _build/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    import torch

    from port_bench import harness

    bench = harness.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return measure(args)


def measure(args, device="cuda", overrides=None) -> int:
    """The run once the card is found: ``harness.run``, the look for JAX
    in this process, then the result's lines."""
    from port_bench import harness

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), STARTED, device=device,
                         overrides=overrides)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    numbers = result.pop("_numbers")
    checks = result.pop("_checks")
    print("compared with the plain reference: " + ", ".join(
        f"{k} {v}" for k, v in numbers.items()), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} {c['relation']} limit "
              f"{c['limit']}: {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
