"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric; each piece is a file of its own, found by its name:

  benchmark/configs/<config>.json   the scene (the configuration's ``file``)
  benchmark/traffic/<mix>.json      the frame, route, window and check
  benchmark/metrics/<metric>.py     a per-layer metric's reader, ``read``
  benchmark/limits/<cell>.json      the limits of the numbers compared

so a later change adds a cell, a mix or a metric as new files and new
entries, and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration entry's file, with its entry under ``entry``."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                out = json.load(f)
            out["entry"] = c
            return out
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def _load_json(path: Path, what: str) -> dict:
    if not path.exists():
        raise KeyError(f"no {what} file {path}")
    with open(path) as f:
        return json.load(f)


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _load_json(Path(bench_dir) / "traffic" / f"{name}.json",
                      "traffic mix")


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _load_json(Path(bench_dir) / "limits" / f"{cell_name}.json",
                      "limits")


def metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end ones
    without ``--trace``, the per-layer ones with it; an entry with a
    ``workloads`` key only in the cells it lists."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"srtbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
