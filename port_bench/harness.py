"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json`` (the entry's ``file``): what the program
  runs (for the serving loops the family, its precision, weights and
  serving domain) and ``limits``, each number compared with its limit
  (``compare.judge``); ``reference/<config>.py``: its plain reference,
  ``Reference(config, device, precision=None)``, which the loop calls
  (the serving loops on uint8 NHWC inputs, for the served uint8 output);
* ``traffic/<traffic>.json``: the mix's parameters and ``loop``, the
  general loop that reads them (``loops/<loop>.py``: a ``State(cell)``
  with ``window(seconds)``, ``release()``, ``compare(reference)``, which
  returns the numbers compared, and ``substitute(fn)``, which puts a
  reference in the timed program's place);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns None where it finds nothing to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from port_bench import compare, trace

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
# modules the process that prints a result may not hold once the window has
# closed, compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "celebrity_image_denoiser_tpu")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path):
    """A benchmark file as a module, by its path."""
    name = "port_bench_file_" + "".join(
        c if c.isalnum() else "_" for c in str(path.relative_to(BENCH_DIR)))
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"no benchmark file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """What of ``FORBIDDEN`` this process holds; ``run.py`` asks last,
    just before it prints the result."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def end_to_end_for(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_for(bench: dict, workload: str) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    mine = {m["name"] for m in end_to_end_for(bench, workload)}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in mine)]


class Cell:
    """One workload entry with its configuration and traffic, a seed and a
    device; what a traffic loop needs to build and check the program."""

    def __init__(self, bench: dict, workload: str, seed: int, device,
                 overrides=None):
        entries = {w["name"]: w for w in bench["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(entries)})")
        self.entry = entries[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        centry = configs[self.entry["config"]]
        with open(ROOT / centry["file"]) as f:
            self.config = json.load(f)
        self.config["name"] = centry["name"]
        for key in ("weights", "weights_dir"):
            if key in self.config:
                self.config[key] = str(ROOT / self.config[key])
        with open(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json") \
                as f:
            self.traffic = json.load(f)
        self.traffic.update(overrides or {})
        self.seed = int(seed)
        self.device = torch.device(device)
        self.failures = []

    def loop(self):
        return load_module(BENCH_DIR / "loops" / f"{self.traffic['loop']}.py")

    def reference(self):
        return load_module(BENCH_DIR / "reference"
                           / f"{self.config['name']}.py")

    def make_server(self):
        """The system under test: the port's server, as ``cli.serve`` builds
        it for this configuration."""
        from celebrity_image_denoiser_tpu_torch.serve.handlers import (
            ServeState,
        )

        return ServeState(weights_dir=self.config["weights_dir"],
                          quantize=self.config["quantize"],
                          device=self.device)

    def check_rung(self, server) -> None:
        """The server must serve the configuration's precision: its int8
        rung, or float."""
        rung = server.ladder(self.config["family"])
        if rung != self.config["rung"]:
            raise RuntimeError(f"{self.config['family']} is served on rung "
                               f"{rung!r}, the configuration states "
                               f"{self.config['rung']!r}")

    def note_failure(self, e: Exception) -> None:
        if len(self.failures) < 5:
            self.failures.append(f"{type(e).__name__}: {e}")


def control(state) -> None:
    """A ``hook`` for ``run``: the configuration's control (its plain
    reference in the precision below the stated one) in the timed
    program's place, on the cell's own inputs at its own size."""
    cell = state.cell
    state.substitute(cell.reference().Reference(
        cell.config, cell.device, precision=cell.config["control"]))


def run(workload: str, seed: int, seconds: float, traced: bool,
        started: float, device="cuda", overrides=None, hook=None,
        prepare=None) -> dict:
    """One run; returns the result line's dict (``checks`` last).
    ``prepare(cell)``, where given, may change the cell before its loop
    builds the program (``limits.py`` hands every seed one server);
    ``hook(state)`` may replace the state's timed ``call`` (``control``;
    the tests break the program this way)."""
    bench = load_benchmark()
    cell = Cell(bench, workload, seed, device, overrides)
    if prepare is not None:
        prepare(cell)
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = cell.loop().State(cell)
    if hook is not None:
        hook(state)
    setup_s = time.perf_counter() - started
    summary = None
    if traced:
        if cuda:
            work, summary = trace.traced(
                lambda: state.window(cell.traffic["trace_seconds"]))
        else:
            work = state.window(cell.traffic["trace_seconds"])
    else:
        work = state.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    state.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = cell.reference().Reference(cell.config, cell.device)
    numbers = state.compare(reference)
    checks = compare.judge(numbers, cell.config["limits"])
    correct = work["failed"] == 0 and bool(checks) and all(
        c["ok"] for c in checks.values())

    metrics = {}
    if not traced:
        for m in end_to_end_for(bench, workload):
            value = setup_s if m["name"] == "setup_s" else \
                work["metrics"].get(m["name"])
            if value is None:
                raise RuntimeError(f"{workload} measured no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = {"trace": summary, "work": work, "config": cell.config,
               "traffic": cell.traffic, "workload": workload}
        for m in per_layer_for(bench, workload):
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py")
            value = reader.read(ctx) if summary is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": work["attempted"],
        "failed": work["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else cell.device.type,
            "kind": (torch.cuda.get_device_name(cell.device) if cuda
                     else "cpu"),
            "count": cell.entry["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    if cell.failures:
        result["errors"] = cell.failures
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                        for k, v in checks.items()}
    result["_numbers"] = numbers
    result["_checks"] = checks
    return result
