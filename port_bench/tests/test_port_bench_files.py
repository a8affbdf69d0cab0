"""BENCHMARK.json against the benchmark's contract, every file it names
found by name, no module of JAX or of the JAX package imported anywhere
under ``port_bench/``, and a new traffic mix added by files and entries
alone."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import harness

ROOT = harness.ROOT
BENCH = harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "port_bench/run.py"]
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_entries_keep_to_the_contract(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/")
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for entry in (bench["configs"] + bench["workloads"] + bench["end_to_end"]
                  + bench["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in names
        names.add(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"])
            assert entry["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = {m["name"] for m in harness.end_to_end_for(bench, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        layers = harness.per_layer_for(bench, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in mine and m["moves"] in e2e


def test_every_file_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"], 1, "cpu")
        assert hasattr(cell.loop(), "State")
        assert hasattr(cell.reference(), "Reference")
        assert set(cell.config["limits"]) == {"worst_image_mad",
                                              "images_compared"}
        assert cell.config["control"] in ("int4", "tf32")
    for m in bench["per_layer"]:
        mod = harness.load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert callable(mod.read)


def imported_top_levels(source: str) -> set:
    """Every module's top-level name that ``source`` imports (absolute
    imports; a relative import names this package)."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def forbidden_in(source: str) -> set:
    return imported_top_levels(source) & set(harness.FORBIDDEN)


def test_the_import_walk_finds_jax_and_the_jax_package():
    assert forbidden_in("import jax.numpy as jnp") == {"jax"}
    assert forbidden_in(
        "from celebrity_image_denoiser_tpu.ops import conv") == {
        "celebrity_image_denoiser_tpu"}
    assert forbidden_in("import importlib\n"
                        "importlib.import_module('flax.linen')") == {"flax"}
    # the port's name begins with the JAX package's: compared whole
    assert forbidden_in(
        "from celebrity_image_denoiser_tpu_torch.serve import handlers\n"
        "import jaxtyping") == set()


def test_no_module_under_port_bench_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = forbidden_in(path.read_text())
        assert not found, f"{path} imports {found}"
        assert "benchmarks" not in imported_top_levels(path.read_text())
        assert "scripts" not in imported_top_levels(path.read_text())


def copy_of_the_benchmark(tmp_path) -> dict:
    """The benchmark copied under ``tmp_path`` beside links to the port
    and its weights; returns its ``BENCHMARK.json`` to add entries to."""
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("celebrity_image_denoiser_tpu_torch", "weights"):
        (tmp_path / name).symlink_to(ROOT / name)
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def run_in_copy(tmp_path, bench: dict, script: str, env=None):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (f"import sys\nsys.path.insert(0, {str(tmp_path)!r})\n"
              + script)
    return subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_a_new_mix_needs_only_new_files_and_entries(tmp_path):
    """A throwaway mix in a copy of the benchmark: a data file and a
    workload entry, and the copy runs it."""
    bench = copy_of_the_benchmark(tmp_path)
    (tmp_path / "port_bench" / "traffic" / "tiny_requests.json").write_text(
        json.dumps({"loop": "requests", "rate_per_s": 30, "workers": 2,
                    "size": 24,
                    "pool": 2, "sigma": 0.1, "warm_requests": 1,
                    "trace_seconds": 0.2}))
    bench["workloads"].append({"name": "dncnn.tiny_requests",
                               "config": "dncnn", "traffic": "tiny_requests",
                               "chips": 1, "why": "a throwaway mix"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dncnn.tiny_requests")
    out = run_in_copy(tmp_path, bench, (
        "import json, time\n"
        "from port_bench import harness\n"
        "assert str(harness.BENCH_DIR).startswith(sys.path[0])\n"
        "r = harness.run('dncnn.tiny_requests', 5, 0.3, False,\n"
        "                time.perf_counter(), device='cpu')\n"
        "print(json.dumps({'correct': r['correct'],\n"
        "                  'metrics': sorted(r['metrics'])}))\n"))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True,
                   "metrics": ["images_per_s", "latency_p50_ms",
                               "latency_p95_ms", "setup_s"]}


# a loop whose answers are not images: sums of seeded vectors, compared
# by the gap of each sum to the reference's
SUMS_LOOP = """
import time
import torch


class State:
    def __init__(self, cell):
        self.cell = cell
        g = torch.Generator().manual_seed(cell.seed)
        self.rows = torch.rand(cell.traffic["rows"], 64, generator=g,
                               dtype=torch.float64)
        self.call = lambda row: float(row.sum())
        self.answers = []

    def window(self, seconds):
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds or i == 0:
            k = i % self.rows.shape[0]
            self.answers.append((k, self.call(self.rows[k])))
            i += 1
        wall = time.perf_counter() - t0
        return {"attempted": i, "failed": 0, "wall_s": wall, "images": 0,
                "metrics": {"sums_per_s": i / wall}}

    def release(self):
        self.call = None

    def substitute(self, fn):
        self.call = fn

    def compare(self, reference):
        gaps = [abs(y - reference(self.rows[k])) for k, y in self.answers]
        return {"worst_sum_gap": max(gaps), "sums_compared": len(gaps)}
"""

SUMS_REFERENCE = """
class Reference:
    def __init__(self, config, device, precision=None):
        pass

    def __call__(self, row):
        return sum(float(v) for v in row)
"""

SUMS_READER = """
def read(ctx):
    return None if ctx["trace"] is None else 1.0
"""


@pytest.mark.parametrize("broken", [False, True])
def test_a_new_kind_of_answer_needs_only_new_files_and_entries(tmp_path,
                                                               broken):
    """A configuration, a mix with its loop, a reference, an end-to-end
    metric and a per-layer reader whose numbers are not image statistics,
    added to a copy by files and entries alone.  The run is correct, and
    not correct where its timed call doubles every answer."""
    bench = copy_of_the_benchmark(tmp_path)
    pb = tmp_path / "port_bench"
    (pb / "loops" / "sums.py").write_text(SUMS_LOOP)
    (pb / "reference" / "toy_sums.py").write_text(SUMS_REFERENCE)
    (pb / "metrics" / "sums_share.toy.py").write_text(SUMS_READER)
    (pb / "traffic" / "rows8.json").write_text(json.dumps(
        {"loop": "sums", "rows": 8, "trace_seconds": 0.05}))
    (pb / "configs" / "toy_sums.json").write_text(json.dumps(
        {"limits": {"worst_sum_gap": {"max": 1e-9},
                                    "sums_compared": {"min": 8}}}))
    bench["configs"].append({"name": "toy_sums", "source": "a toy",
                             "file": "port_bench/configs/toy_sums.json",
                             "reduced": [], "why": "a throwaway"})
    bench["workloads"].append({"name": "toy_sums.rows8", "config": "toy_sums",
                               "traffic": "rows8", "chips": 1,
                               "why": "a throwaway mix"})
    bench["end_to_end"].insert(0, {
        "name": "sums_per_s", "unit": "sums/s", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["toy_sums.rows8"]})
    bench["per_layer"].append({
        "name": "sums_share.toy", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "toy", "moves": "sums_per_s",
        "workloads": ["toy_sums.rows8"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    out = run_in_copy(tmp_path, bench, (
        "import json, time\n"
        "from port_bench import harness\n"
        "def double(state):\n"
        "    call = state.call\n"
        "    state.call = lambda row: 2 * call(row)\n"
        "r = harness.run('toy_sums.rows8', 5, 0.05, False,\n"
        "                time.perf_counter(), device='cpu',\n"
        f"                hook={'double' if broken else None})\n"
        "t = harness.run('toy_sums.rows8', 5, 0.05, True,\n"
        "                time.perf_counter(), device='cpu')\n"
        "print(json.dumps({'correct': r['correct'],\n"
        "                  'checks': r['_checks'],\n"
        "                  'metrics': sorted(r['metrics']),\n"
        "                  'traced': sorted(t['metrics'])}))\n"))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["metrics"] == ["setup_s", "sums_per_s"]
    # the reader finds no trace on the CPU and returns nothing
    assert got["traced"] == []
    assert got["checks"]["sums_compared"]["ok"]
    assert got["correct"] is not broken
    assert got["checks"]["worst_sum_gap"]["ok"] is not broken


FAKE_JAX = "loaded = True\n"


@pytest.mark.parametrize("where", [None, "reference", "reader"])
def test_jax_loaded_after_the_window_stops_the_result(tmp_path, where):
    """``run.py`` asks for JAX last: a plain reference or a per-layer
    reader that imports it (a stand-in ``jax`` here) stops the run with
    exit 3 and no result; without it the run prints its result."""
    bench = copy_of_the_benchmark(tmp_path)
    fakes = tmp_path / "fakes"
    (fakes / "jax").mkdir(parents=True)
    (fakes / "jax" / "__init__.py").write_text(FAKE_JAX)
    pb = tmp_path / "port_bench"
    target = {"reference": pb / "reference" / "dncnn.py",
              "reader": pb / "metrics" / "copy_ms.serve.py"}.get(where)
    if target is not None:
        target.write_text(target.read_text() + "\nimport jax  # noqa\n")
    env = dict(os.environ, PYTHONPATH=str(fakes))
    out = run_in_copy(tmp_path, bench, (
        "from port_bench import run\n"
        "args = run.parse(['--workload', 'dncnn.requests1024', '--seed',\n"
        f"                  '7', '--seconds', '0.2', '--trace',\n"
        f"                  {'1' if where == 'reader' else '0'!r}])\n"
        "sys.exit(run.measure(args, device='cpu', overrides={\n"
        "    'size': 16, 'pool': 2, 'workers': 2, 'warm_requests': 1,\n"
        "    'trace_seconds': 0.2}))\n"), env=env)
    lines = out.stdout.strip().splitlines()
    if where is None:
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(lines[-1])["correct"]
    else:
        assert out.returncode == 3, out.stderr[-2000:]
        assert not lines
        assert "'jax'" in out.stderr
