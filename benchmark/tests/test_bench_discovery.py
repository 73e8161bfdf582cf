"""Every piece is found by its name: the committed cells' files, and a new
configuration, mix, metric and cell added as new files and new entries
with no edit to an existing file."""
import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT
from srtbench import profiling, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_committed_cells_resolve():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and NAME.match(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        spec.config(bench, w["config"])
        spec.traffic(w["traffic"])
        assert spec.limits(w["name"])["gap"]["limit"] > 0
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(bench)) < 64 * 1024


def test_new_pieces_found_without_edits(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns(".cache", "tests",
                                                  "__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a new configuration, mix, metric and cell: new files and entries
    cfg = json.loads((bench_dir / "configs" / "large_mesh.json").read_text())
    cfg["meshes"][0]["args"]["subdivisions"] = 4
    (bench_dir / "configs" / "small_mesh.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "view1080_auto.json"
                      ).read_text())
    mix.update(width=960, height=540, samples_per_pass=4)
    (bench_dir / "traffic" / "view540_4spp.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "frames_traced.py").write_text(
        "def read(run):\n    return float(run.frames)\n")
    (bench_dir / "limits" / "small_mesh.view540_4spp.json").write_text(
        json.dumps({"gap": {"limit": 0.5}, "nonfinite": {"limit": 0}}))
    bench["configs"].append({"name": "small_mesh", "source": "x",
                             "file": "benchmark/configs/small_mesh.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "small_mesh.view540_4spp",
                               "config": "small_mesh",
                               "traffic": "view540_4spp", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "the harness", "moves": "setup_s",
                               "workloads": ["small_mesh.view540_4spp"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    b = spec.load_benchmark(tmp_path)
    w = spec.cell(b, "small_mesh.view540_4spp")
    assert spec.config(b, w["config"], tmp_path)["meshes"][0]["args"] == \
        {"subdivisions": 4}
    assert spec.traffic(w["traffic"], bench_dir)["samples_per_pass"] == 4
    assert spec.limits(w["name"], bench_dir)["gap"]["limit"] == 0.5
    listed = [m["name"] for m in spec.metrics(b, w["name"], trace=True)]
    assert "frames_traced" in listed and "device_idle" not in listed
    assert "frames_traced" not in [
        m["name"] for m in spec.metrics(b, "large_mesh.view1080_auto", True)]
    run = profiling.TraceRun(
        config=cfg, traffic=mix, width=960, height=540, num_samples=4,
        num_bounces=6, frames=7, profile=profiling.Profile([], []),
        window_s=1.0, busy_s=0.5, dispatch_s=[], scene_build_s=0.1,
        launched={})
    assert spec.reader("frames_traced", bench_dir)(run) == 7.0
    # no file that was there changed
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_missing_piece_names_itself(tmp_path):
    with pytest.raises(KeyError, match="no_such_mix"):
        spec.traffic("no_such_mix", tmp_path)
    with pytest.raises(KeyError, match="no_such_metric"):
        spec.reader("no_such_metric", tmp_path)
    with pytest.raises(KeyError, match="no_such_cell"):
        spec.cell(spec.load_benchmark(), "no_such_cell")
