"""The port runs where JAX does not exist.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``jaxlib`` and ``simple_raytracer_tpu`` (exact top-level names, so
``simple_raytracer_tpu_torch`` still imports), then imports the port and
chip_smoke and renders config 2, the clustered mesh of config 4 (its
BVH built by the port's own builder) and config 6 through the split
per-bounce path at 32x16 on the CPU, and traces config 7 (cut to 5,120
triangles) through the fused per-bounce path (ops/bounce.py) and under
tri_backend="clustered"; then renders with a texture skybox written and
read back as an .hdr (the whole-trace form and the split path), and
under the "pallas" and "jnp" triangle routes; renders config 6 clustered
at Scene.cluster_size=256 in the BVH kernel's Plucker form
(SRT_BVH_MT=plucker) and runs the lowering probes' plain versions; then
runs the port's CLI (--device cpu) on a scene file, on an OBJ mesh with
a depth AOV, and with --save-state; then imports the multi-device modules
(parallel.mesh, .shard, .distributed, .dryrun) and the showcase scenes,
runs the dry run over 2 CPU bands, renders config 2 in 2 bands and the
three showcase scenes, and runs the CLI with --all-devices; then imports
the editor, the gizmo and the viewer, starts the viewer's render loop and
HTTP server on the CPU, fetches one frame and posts one edit.
chip_smoke.py itself must fail, printing no result, without CUDA and
outside the repository.  The port's host library (the BVH builder, the
STL parser) is compiled and loaded with the same imports refused, from
the port's own source into build/, never the JAX package's native/.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r'''
import importlib.abc
import sys

BLOCKED = {"jax", "jaxlib", "simple_raytracer_tpu"}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} refused")
        return None


# an interpreter-startup plugin may have imported jax already
for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[mod]
sys.meta_path.insert(0, Refuse())

import simple_raytracer_tpu_torch
import chip_smoke   # main() stays behind its __name__ guard
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS

renderers = {}
for n in (2, 4, 6):
    scene, camera, opt = CONFIGS[n](width=32, height=16)
    r = Renderer(RenderOptions(width=32, height=16,
                               num_samples=opt.num_samples,
                               num_bounces=opt.num_bounces), scene,
                 device="cpu")
    img = r.render(camera, num_steps=2)
    assert img.shape == (16, 32, 3) and img.std() > 0, img.shape
    renderers[n] = r
assert renderers[4].device_scene.triangles.clusters.slots.shape == (32, 64)
# config 6 takes the split per-bounce path (the BVH kernel's plain version)
assert renderers[6].device_scene.triangles.clusters.slots.shape == (768, 128)
# config 7, cut down: the fused per-bounce path and the "clustered" backend
from simple_raytracer_tpu_torch.ops import bounce
from simple_raytracer_tpu_torch.ops.cuda import bounce_kernel
from simple_raytracer_tpu_torch.ops.camera import (camera_rotation,
                                                   generate_rays)
from simple_raytracer_tpu_torch.ops.trace import trace_rays_fused
scene, camera, opt = CONFIGS[7](width=32, height=16, subdivisions=4)
ts = scene.build("cpu")
cam = camera.state(2.0)
o, d, seed = generate_rays(32, 16, 2, 3, cam.position,
                           camera_rotation(cam.yaw, cam.pitch),
                           cam.aspect_ratio, cam.fov_scale)
col = trace_rays_fused(ts, o, d, seed, opt.num_bounces)
assert float(col.x.std()) > 0
r = Renderer(RenderOptions(width=32, height=16, num_samples=2,
                           num_bounces=opt.num_bounces,
                           tri_backend="clustered"), scene, device="cpu")
assert r.render(camera, num_steps=1).std() > 0
# a texture skybox, from an .hdr the port writes, through the whole-trace
# form (config 3) and the split path (config 4 under "bvh"); the "pallas"
# and "jnp" triangle routes
import os
import tempfile
import numpy as np
from simple_raytracer_tpu_torch.io.image import load_skybox, save_hdr
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "sky.hdr")
    save_hdr(path, np.random.default_rng(0).random((16, 32, 3),
                                                   np.float32) * 2)
    sky = load_skybox(path)
for n, backend in ((3, "auto"), (4, "bvh"), (5, "pallas"), (4, "jnp")):
    scene, camera, opt = CONFIGS[n](width=32, height=16)
    scene.skybox = sky
    r = Renderer(RenderOptions(width=32, height=16, num_samples=1,
                               num_bounces=3, tri_backend=backend), scene,
                 device="cpu")
    assert r.device_scene.skybox.shape == (16, 32, 3)
    assert r.render(camera, num_steps=1).std() > 0
# the Plucker form at K = 256 (the streamed variant's plain version) and
# the probes
from simple_raytracer_tpu_torch.ops import bvh
from simple_raytracer_tpu_torch.scripts import probe_kernel_ops
scene, camera, opt = CONFIGS[6](width=32, height=16)
scene.cluster_size = 256
os.environ["SRT_BVH_MT"] = "plucker"
before = bvh.PLUCKER_CALLS
r = Renderer(RenderOptions(width=32, height=16, num_samples=1,
                           num_bounces=3), scene, device="cpu")
assert r.device_scene.triangles.clusters.k == 256
assert r.render(camera, num_steps=1).std() > 0
assert bvh.PLUCKER_CALLS - before == 3, bvh.PLUCKER_CALLS - before
del os.environ["SRT_BVH_MT"]
probes = probe_kernel_ops.run("cpu")
assert probes["A"]["value"] == 65536.0, probes
assert all(p["equal"] for p in probes.values()), probes
# the CLI: a scene file, a mesh file with an AOV, a checkpoint
from simple_raytracer_tpu_torch import cli
from simple_raytracer_tpu_torch.io.obj import save_obj
from simple_raytracer_tpu_torch.io.scene_json import save_scene
from simple_raytracer_tpu_torch.models.meshgen import organic_blob
with tempfile.TemporaryDirectory() as tmp:
    scene, camera, _ = CONFIGS[5]()
    save_scene(os.path.join(tmp, "s.json"), scene, camera)
    save_obj(os.path.join(tmp, "m.obj"), *organic_blob(subdivisions=2))
    small = ["--width", "32", "--height", "16", "--samples", "1",
             "--bounces", "2", "--steps", "1", "--device", "cpu"]
    for argv in (["--scene", os.path.join(tmp, "s.json")],
                 ["--config", "4", "--mesh-path", os.path.join(tmp, "m.obj"),
                  "--aov", "depth"],
                 ["--config", "2", "--save-state",
                  os.path.join(tmp, "st.npz")]):
        out = os.path.join(tmp, "out.ppm")
        assert cli.main(argv + small + ["--out", out]) == 0, argv
        assert os.path.getsize(out) == len(b"P6 32 16 255\n") + 32 * 16 * 3
    assert int(np.load(os.path.join(tmp, "st.npz"))["num_steps"]) == 1
# the multi-device slice and the showcase scenes
from simple_raytracer_tpu_torch import parallel
from simple_raytracer_tpu_torch.models import showcase
from simple_raytracer_tpu_torch.parallel import distributed, mesh, shard
from simple_raytracer_tpu_torch.parallel.dryrun import dryrun_multichip
dryrun_multichip(2, device="cpu")
scene, camera, opt = CONFIGS[2](width=32, height=16)
r = Renderer(RenderOptions(width=32, height=16, num_samples=1,
                           num_bounces=2, all_devices=True), scene,
             device=["cpu"] * 2)
assert r.num_devices == 2 and r.render(camera, num_steps=1).std() > 0
assert not distributed.is_multiprocess()
for build in showcase.SHOWCASES.values():
    scene, camera, _ = build(subdivisions=1) if build is \
        showcase.showcase_model else build()
    r = Renderer(RenderOptions(width=32, height=16, num_samples=1,
                               num_bounces=2), scene, device="cpu")
    assert r.render(camera, num_steps=1).std() > 0
with tempfile.TemporaryDirectory() as tmp:
    out = os.path.join(tmp, "bands.ppm")
    assert cli.main(["--config", "2", "--all-devices", "--out", out]
                    + small) == 0
    assert os.path.getsize(out) == len(b"P6 32 16 255\n") + 32 * 16 * 3
# the editor, the gizmo and the viewer: a RenderLoop on the CPU behind the
# HTTP server, one frame fetched, one edit and one pick through it
import json
import threading
import time
import urllib.error
import urllib.request
from simple_raytracer_tpu_torch import editor, gizmo, viewer
scene, camera, opt = CONFIGS[2](width=32, height=16)
r = Renderer(RenderOptions(width=32, height=16, num_samples=1,
                           num_bounces=2), scene, device="cpu")
loop = viewer.RenderLoop(r, camera, scene=scene)
loop.start()
srv = viewer.ThreadingHTTPServer(("127.0.0.1", 0),
                                 viewer.make_handler(loop, 32, 16))
threading.Thread(target=srv.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{srv.server_address[1]}"
png, deadline = None, time.time() + 60
while png is None and time.time() < deadline:
    assert loop.error is None, loop.error
    try:
        png = urllib.request.urlopen(url + "/frame.png", timeout=10).read()
    except urllib.error.HTTPError:      # 503 until the first frame
        time.sleep(0.05)
assert png is not None and png[:8] == b"\x89PNG\r\n\x1a\n"
req = urllib.request.Request(url + "/edit", method="POST", data=json.dumps(
    {"op": "add_sphere", "position": [0, 0, -3]}).encode())
assert json.loads(urllib.request.urlopen(req, timeout=10).read())["ok"]
assert editor.repair_selection(None, {}, {}) is None
assert gizmo.handle_scale((0, 0, 0), (0, 0, 5), 1.0) > 0
srv.shutdown()
srv.server_close()
loop.stop()
assert loop.error is None, loop.error
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
try:
    import jax  # noqa: F401
except ImportError:
    pass
else:
    raise AssertionError("the blocker let jax through")
print("NO_JAX_OK")
'''


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=240,
                          env=_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout


HOST_SCRIPT = r'''
import importlib.abc
import shutil
import sys
import tempfile
from pathlib import Path

BLOCKED = {"jax", "jaxlib", "simple_raytracer_tpu"}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} refused")
        return None


for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[mod]
sys.meta_path.insert(0, Refuse())

import numpy as np
from simple_raytracer_tpu_torch import accel
from simple_raytracer_tpu_torch.ops.cuda import build

# a fresh build directory under build/: the library is compiled here
repo_build = build.BUILD_DIR.parent
repo_build.mkdir(exist_ok=True)
build.BUILD_DIR = Path(tempfile.mkdtemp(dir=repo_build))
try:
    lib = accel.host_library()
    path = Path(lib._name).resolve()
    assert path.parent == build.BUILD_DIR.resolve(), path
    assert path.name.startswith("host_accel-"), path
    assert accel.HOST.build_log is not None
    pos = np.random.default_rng(0).normal(size=(500, 3, 3)).astype(np.float32)
    bvh = accel.build_bvh(pos)
    accel.validate_bvh(bvh, pos)
    maps = Path("/proc/self/maps").read_text()
    assert "libsrt_native" not in maps and "/native/" not in maps
    assert str(path) in maps
finally:
    shutil.rmtree(build.BUILD_DIR)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("HOST_OK", path.relative_to(repo_build.resolve()).parts[0])
'''


def test_host_library_builds_without_jax():
    """The port compiles its own host library (csrc/host_accel.cpp) into a
    fresh directory under build/ and loads it, with jax and the JAX
    package unimportable; no file under native/ is mapped."""
    proc = subprocess.run([sys.executable, "-c", HOST_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "HOST_OK" in proc.stdout


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """No card: exit != 0 and no result line.  Alone in a directory: the
    port cannot be imported, so it fails the same way."""
    runs = []
    if not torch.cuda.is_available():
        runs.append(REPO)
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(tmp_path)
    for cwd in runs:
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=240,
                              env=_env())
        assert proc.returncode != 0, cwd
        assert '"ok"' not in proc.stdout, proc.stdout
