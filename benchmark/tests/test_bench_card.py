"""On the card: one short run of every cell reads correct and prints the
contract's line (run on the chip with ``python -m pytest benchmark/tests
-m cuda``)."""
import json
import subprocess
import sys

import pytest

from benchmark import harness

MAN = harness.load_manifest()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_runs_correct(cuda_device, cell):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", str(MAN["run_seconds"]), "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "gpu"
    want = {m["name"] for m in harness.cell_metrics(MAN, "end_to_end", cell)}
    assert set(out["metrics"]) == want
