"""The readings that a cell's limits are set from, on the card, each one a
whole run of the harness.

    python3 port_bench/limits.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

In one process, one server handed to every run: for each of ``--seeds``,
``harness.run`` as the benchmark makes it (the cell's inputs from that
seed, its loop for ``--seconds``, the comparison with the plain reference
and the configuration's limits): the lower readings.  For each of
``--control-seeds``, ``harness.run`` with ``harness.control`` as its hook:
the plain reference in the configuration's ``control`` precision (int4 for
int8, TF32 for float32) in the timed program's place, on the cell's own
inputs at its own size, through the same window, comparison and limits:
the upper readings.  Prints one JSON line per run and a summary, and exits
with 1 where a program run came out not correct or a control run came out
correct.  The benchmark's own runs never run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from port_bench import harness

    server = []

    def one_server(cell):
        if not server:
            server.append(cell.make_server())
        cell.make_server = lambda: server[0]

    def reading(kind, seed, hook=None):
        t0 = time.perf_counter()
        r = harness.run(args.workload, seed, args.seconds, False, t0,
                        hook=hook, prepare=one_server)
        line = {"reading": kind, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "failed": r["failed"],
                **r["_numbers"], "metrics": {
                    k: v["value"] for k, v in r["metrics"].items()},
                "run_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        return line

    program = [reading("program", int(s))
               for s in args.seeds.split(",") if s]
    control = [reading("control", int(s), harness.control)
               for s in args.control_seeds.split(",") if s]
    bench = harness.load_benchmark()
    config = harness.Cell(bench, args.workload, 0, "cpu").config
    # the numbers held to a most: the program's highest and the control's
    # lowest
    most = [k for k, v in config["limits"].items() if "max" in v]
    summary = {
        "workload": args.workload, "control": config["control"],
        "limits": config["limits"],
        "lower": {k: max(r[k] for r in program) for k in most}
        if program else None,
        "upper": {k: min(r[k] for r in control) for k in most}
        if control else None,
        "program_correct": sum(r["correct"] for r in program),
        "control_correct": sum(r["correct"] for r in control),
        "kind": torch.cuda.get_device_name(0),
        "seconds": time.perf_counter() - STARTED}
    print(json.dumps(summary), flush=True)
    ok = summary["program_correct"] == len(program) and \
        summary["control_correct"] == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
