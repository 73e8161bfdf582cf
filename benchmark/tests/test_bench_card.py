"""On the card: one short run of each cell gives a result that is correct
and carries its metrics (skips without a card; the full runs are
``python3 benchmark/run.py``)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT
from srtbench import spec


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_runs_correct(cell, card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"mrays_per_s", "frame_ms_p95", "setup_s"}
    assert r["device"]["platform"] == "gpu"
