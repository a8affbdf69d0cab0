"""One short run of each cell on the card, through the benchmark's
command: a result line of the contract's shape, correct.  Skipped without
a CUDA device; on the chip:

    python3 -m pytest port_bench/tests -m card
"""

import json
import subprocess
import sys

import pytest

from port_bench import harness

pytestmark = pytest.mark.card


@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.load_benchmark()["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_a_short_run_is_correct(cuda_device, workload, traced):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace",
         str(traced)], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes"] > 0
    bench = harness.load_benchmark()
    if traced:
        want = {m["name"] for m in harness.per_layer_for(bench, workload)}
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert len(r["breakdown"]["device_ops"]) <= 10
    else:
        want = {m["name"] for m in harness.end_to_end_for(bench, workload)}
    assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100
