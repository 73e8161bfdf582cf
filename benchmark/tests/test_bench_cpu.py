"""Without a card the benchmark fails and prints no result; so it does in
a directory that holds only BENCHMARK.json and the benchmark's files."""
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT


def run_py(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "large_mesh.view1080_auto", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
