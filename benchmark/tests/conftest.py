"""The benchmark's own tests, on the CPU at tiny sizes.

``make_cell`` writes a checkout of one cell into a temporary directory: a
BENCHMARK.json naming it, the configuration's file with its mesh cut, a
mix at a tiny frame, the real cell's limits, and copies of the mesh
generators and metric readers; the harness finds them all by name.
Tests that need a CUDA card carry the ``card`` marker and skip here.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_cell(tmp: Path, config: str = "large_mesh", subdivisions: int = 3,
              width: int = 64, height: int = 32, mix: str = "view1080_auto",
              warmup_frames: int = 1):
    """(root, bench_dir, cell name) of a tiny copy of ``config.mix``."""
    tmp = Path(tmp)
    bd = tmp / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (bd / d).mkdir(parents=True, exist_ok=True)
    for d in ("meshes", "metrics"):
        if not (bd / d).exists():
            shutil.copytree(BENCH / d, bd / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cfg["meshes"][0]["args"]["subdivisions"] = subdivisions
    (bd / "configs" / "tiny.json").write_text(json.dumps(cfg))
    t = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    t.update(width=width, height=height, warmup_frames=warmup_frames)
    (bd / "traffic" / "tinymix.json").write_text(json.dumps(t))
    real = f"{config}.{mix}"
    shutil.copy(BENCH / "limits" / f"{real}.json",
                bd / "limits" / "tiny.tinymix.json")
    entry = dict(next(c for c in bench["configs"] if c["name"] == config),
                 name="tiny", file="benchmark/configs/tiny.json")
    bench["configs"] = [entry]
    cell = dict(next(w for w in bench["workloads"] if w["name"] == real),
                name="tiny.tinymix", config="tiny", traffic="tinymix")
    bench["workloads"] = [cell]
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.tinymix"] if real in m["workloads"] else []
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp, bd, "tiny.tinymix"
