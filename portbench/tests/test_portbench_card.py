"""Each cell on the card for a short window, the traced run included:
correct, with every metric the cell reports.  Needs a CUDA card; skips
without one."""

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(workload, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", "2147483789", "--seconds", "2",
                        "--trace", str(trace)], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    e2e, per_layer = harness.metrics_of(workload)
    want = {m["name"] for m in (per_layer if trace else e2e)}
    assert out["correct"] and set(out["metrics"]) == want
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
