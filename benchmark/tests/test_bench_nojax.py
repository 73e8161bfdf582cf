"""Nothing the benchmark runs loads JAX or the JAX package: names are
compared whole, by their top-level part, so the port passes."""
import subprocess
import sys

from conftest import BENCH, ROOT
from srtbench.nojax import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["simple_raytracer_tpu_torch",
                              "simple_raytracer_tpu_torch.engine",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                              "simple_raytracer_tpu.ops.rng"]) == \
        ["flax", "jax", "jaxlib", "simple_raytracer_tpu"]


REFUSE = r'''
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "simple_raytracer_tpu"}
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} refused")
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, Refuse())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import run, calibrate
from reference import tracer, lbvh, rng
from srtbench import check, kernels, profiling, scenes, spec, stats
from srtbench.nojax import forbidden_modules
import simple_raytracer_tpu_torch.engine
import simple_raytracer_tpu_torch.ops.cuda.bvh_kernel
run.program_counts()
assert forbidden_modules(sys.modules) == [], forbidden_modules(sys.modules)
print("clean")
'''


def test_harness_and_reference_import_without_jax():
    out = subprocess.run([sys.executable, "-c", REFUSE, str(BENCH),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "simple_raytracer_tpu" not in text, path
        assert "import jax" not in text, path
