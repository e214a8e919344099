"""Each cell of ``BENCHMARK.json`` run for a few seconds at its real size on
the card, by its command; the last line of its output is the result line.
Needs the card:

    python -m pytest -q -m gpu perfbench/tests/test_perfbench_cells.py
"""
import json
import subprocess
import sys

import pytest

from perfbench_tiny import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_a_result_line(cuda_device, workload, trace):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cmd = [sys.executable, *bench["command"][1:], "--workload", workload,
           "--seed", str(2**31 + 4242), "--seconds", "4", "--trace", str(trace)]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
