"""The port's multi-device rendering (simple_raytracer_tpu_torch.parallel,
RenderOptions.all_devices, the CLI's distributed flags) on the CPU.

Bands run over ``["cpu"] * n`` in place of JAX's virtual CPU devices and
must give the port's single-device canvas bit for bit; config 2 at
tests/test_multichip.py's 64x48, 2 spp, 4 bounces, time 42, is also held
to JAX's make_sharded_render_step on the 8 virtual CPU devices within the
golden bound (RMSE < 2e-3).  Two-process renders run over gloo on
localhost, each process with a timeout."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simple_raytracer_tpu.engine import Renderer as JRenderer
from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.parallel.mesh import make_mesh as jmake_mesh
from simple_raytracer_tpu.parallel.shard import (
    make_sharded_canvas as jmake_sharded_canvas,
    make_sharded_render_step as jmake_sharded_render_step)
from simple_raytracer_tpu_torch.cli import main as cli_main
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.parallel import (band_rows,
                                                 make_sharded_canvas,
                                                 make_sharded_render_step,
                                                 make_mesh, replicate_scene)
from simple_raytracer_tpu_torch.parallel import distributed
from simple_raytracer_tpu_torch.parallel.dryrun import dryrun_multichip

REPO = Path(__file__).resolve().parents[1]
W, H, S, B, T = 64, 48, 2, 4, 42     # tests/test_multichip.py's render
BOUND = 2e-3                          # tests/test_golden.py's RMSE bound
PROC_TIMEOUT = 120                    # seconds a worker process may take


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _renderer(n=2, bands=None, width=W, height=H, samples=S, bounces=B,
              **kw):
    """A port Renderer of config ``n`` on the CPU: one device, or under
    all_devices over ``["cpu"] * bands``."""
    scene, camera, _ = CONFIGS[n](width=width, height=height)
    opts = RenderOptions(width=width, height=height, num_samples=samples,
                         num_bounces=bounces, all_devices=bands is not None,
                         **kw)
    device = "cpu" if bands is None else ["cpu"] * bands
    return Renderer(opts, scene, device=device), camera


@pytest.fixture(scope="module")
def single():
    """The port's single-device canvas of config 2 at time 42."""
    r, camera = _renderer()
    assert r.ray_tile == (8, 64) and r.num_devices == 1
    r.step(camera, time=T)
    return r.canvas.numpy()


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's make_sharded_render_step over its 8 virtual CPU devices."""
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs JAX's 8 virtual CPU devices (tests/conftest.py)")
    scene, camera, _ = JCONFIGS[2](width=W, height=H)
    mesh = jmake_mesh(devices)
    step, mesh, _ = jmake_sharded_render_step(W, H, S, B, mesh=mesh)
    out = step(scene.build(), camera.state(W / H),
               jmake_sharded_canvas(mesh, H, W), jnp.uint32(T))
    return np.asarray(out)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_bands_equal_one_device_and_jax(n, single, jax_sharded):
    """Bands of make_sharded_render_step and of Renderer(all_devices) over
    n CPU "devices" give the single-device canvas bit for bit (48 rows in
    8 bands: 6 rows, no ray tile, where one device tiles 8x64), within
    the golden bound of JAX's sharded step."""
    scene, camera, _ = CONFIGS[2](width=W, height=H)
    mesh = make_mesh(["cpu"] * n)
    step = make_sharded_render_step(W, H, S, B, mesh=mesh)
    bands = step(replicate_scene(scene, mesh), camera.state(W / H),
                 make_sharded_canvas(mesh, H, W), T)
    assert [tuple(b.shape) for b in bands] == [(H // n, W, 3)] * n
    np.testing.assert_array_equal(torch.cat(bands).numpy(), single)

    r, camera = _renderer(bands=n)
    assert r.num_devices == n and r.devices == [torch.device("cpu")] * n
    assert r.ray_tile == ((8, 64) if n == 2 else None)
    r.step(camera, time=T)
    np.testing.assert_array_equal(r.canvas.numpy(), single)
    assert _rmse(r.canvas.numpy(), jax_sharded) < BOUND


def test_same_time_doubles_exactly():
    """Two steps with one time seed give twice the first, exactly."""
    r, camera = _renderer(bands=4, width=32, height=32, samples=1,
                          bounces=2)
    r.step(camera, time=7)
    first = r.canvas.numpy().copy()
    r.step(camera, time=7)
    np.testing.assert_array_equal(r.canvas.numpy(), 2 * first)


def test_height_and_tile_errors():
    """The height must divide by the band count (the JAX Renderer's
    message); an explicit ray tile must divide each band."""
    with pytest.raises(ValueError, match="height 50 must divide"):
        _renderer(bands=4, height=50)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_render_step(W, 50, 1, 2, mesh=["cpu"] * 4)
    with pytest.raises(ValueError, match="ray tile"):
        make_sharded_render_step(W, 32, 1, 2, mesh=["cpu"] * 8,
                                 ray_tile=(8, 64))
    with pytest.raises(ValueError, match="all_devices"):
        Renderer(RenderOptions(width=W, height=H), device=["cpu"] * 2)
    assert band_rows(48, 4) == [(0, 12), (12, 12), (24, 12), (36, 12)]
    with pytest.raises(ValueError, match="outside"):
        make_sharded_render_step(W, H, 1, 2, mesh=["cpu"] * 2, first_band=3,
                                 num_bands=4)


def test_tiled_bands_and_one_band():
    """64 rows in 8 bands tile each 8-row band (8, 64), and the per-band
    tile order composes into the image's; one band under all_devices is
    a single-device renderer; an explicit tile changes no pixel."""
    one, camera = _renderer(width=64, height=64, samples=1, bounces=3)
    one.step(camera, time=9)
    r, _ = _renderer(bands=8, width=64, height=64, samples=1, bounces=3)
    assert r.ray_tile == (8, 64)
    r.step(camera, time=9)
    np.testing.assert_array_equal(r.canvas.numpy(), one.canvas.numpy())
    np.testing.assert_array_equal(r.image(), one.image())
    lone, _ = _renderer(bands=1, width=64, height=64, samples=1, bounces=3)
    assert lone.num_devices == 1 and lone.ray_tile == (8, 64)
    scene, _, _ = CONFIGS[2](width=64, height=32)
    mesh = ["cpu"] * 4
    scenes, cam = replicate_scene(scene, mesh), camera.state(2.0)
    a = make_sharded_render_step(64, 32, 1, 2, mesh=mesh)(
        scenes, cam, make_sharded_canvas(mesh, 32, 64), 3)
    b = make_sharded_render_step(64, 32, 1, 2, mesh=mesh, ray_tile=(4, 32))(
        scenes, cam, make_sharded_canvas(mesh, 32, 64), 3)
    np.testing.assert_array_equal(torch.cat(a).numpy(), torch.cat(b).numpy())


def test_aov_in_bands():
    """The depth AOV in 4 bands equals one device's; sky rows are 0."""
    one, camera = _renderer(aov="depth")
    one.step(camera, time=3)
    r, _ = _renderer(bands=4, aov="depth")
    r.step(camera, time=3)
    np.testing.assert_array_equal(r.canvas.numpy(), one.canvas.numpy())
    assert float(r.canvas[0].max()) == 0.0


@pytest.mark.parametrize("n", [5, 6])
def test_mesh_configs_in_bands(n):
    """Config 5 (the whole-trace clustered plain version) and config 6
    (the split path with the BVH plain version) at 64x32 in 2 bands."""
    one, camera = _renderer(n, width=64, height=32, samples=1, bounces=2)
    one.step(camera, time=13)
    r, _ = _renderer(n, bands=2, width=64, height=32, samples=1, bounces=2)
    assert len(r._scenes) == 1          # replicated: one scene a device
    r.step(camera, time=13)
    np.testing.assert_array_equal(r.canvas.numpy(), one.canvas.numpy())


def test_checkpoints_across_band_counts():
    """A checkpoint saved in 4 bands loads in 1 and goes on equal; one the
    JAX Renderer saved loads in 4 bands; clear_canvas zeroes every band."""
    four, camera = _renderer(bands=4)
    one, _ = _renderer()
    for t in (3, 4):
        four.step(camera, time=t)
        one.step(camera, time=t)
    st = four.state_dict()
    assert st["canvas"].shape == (H, W, 3) and st["num_steps"] == 2
    np.testing.assert_array_equal(st["canvas"], one.state_dict()["canvas"])
    back, _ = _renderer()
    back.load_state_dict(st)
    back.step(camera, time=5)
    four.step(camera, time=5)
    np.testing.assert_array_equal(back.canvas.numpy(), four.canvas.numpy())
    np.testing.assert_array_equal(back.image(), four.image())

    jscene, jcam, _ = JCONFIGS[2](width=W, height=H)
    jr = JRenderer(JOptions(width=W, height=H, num_samples=S, num_bounces=B),
                   scene=jscene)
    canvas = np.random.default_rng(4).random((H, W, 3), np.float32) * 3
    jr.load_state_dict({"canvas": canvas, "num_steps": 5})
    four.load_state_dict(jr.state_dict())
    assert four.num_steps == 5
    np.testing.assert_array_equal(four.state_dict()["canvas"], canvas)
    np.testing.assert_array_equal(four.image(), np.asarray(jr.image()))
    four.clear_canvas()
    assert four.num_steps == 0 and float(four.canvas.abs().sum()) == 0.0


def test_scene_replicas_and_state_checks():
    """set_device_scene takes a scene on the bands' one device;
    benchmark_step times the card only."""
    r, camera = _renderer(bands=2)
    ds = r.device_scene
    r.set_device_scene(ds)
    assert r.device_scene is ds
    scene, _, _ = CONFIGS[2](width=W, height=H)
    with pytest.raises(ValueError, match="scene on meta, renderer on cpu"):
        r.set_device_scene(from_numpy(scene.arrays(), "meta"))
    with pytest.raises(RuntimeError, match="times the card"):
        r.benchmark_step(camera)


def test_distributed_helpers_single_process(monkeypatch):
    """In one process the helpers are a host copy, rank 0 and a writer;
    initialize needs a coordinator, a size and a rank."""
    assert not distributed.is_multiprocess()
    assert distributed.should_write_output()
    assert distributed.all_counts(3) == [3]
    c = torch.ones((4, 8, 3))
    np.testing.assert_array_equal(distributed.fetch_canvas(c),
                                  np.ones((4, 8, 3), np.float32))
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize()


def test_dryrun_multichip():
    dryrun_multichip(4, device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(argvs, timeout=PROC_TIMEOUT):
    """Start every argv at once from the repository root; return their
    (returncode, stdout, stderr), each waited for at most ``timeout``."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv in argvs]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


_WORKER = """
import sys
import numpy as np
import torch
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.parallel import distributed
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
distributed.initialize(f"127.0.0.1:{port}", 2, rank)
distributed.initialize()                      # idempotent
assert distributed.is_multiprocess() and distributed.process_count() == 2
scene, camera, _ = CONFIGS[2](width=64, height=48)
opts = RenderOptions(width=64, height=48, num_samples=1, num_bounces=3,
                     all_devices=True)
r = Renderer(opts, scene, device=["cpu"] * 2)
assert r.num_devices == 4
r.step(camera, time=5)
st = r.state_dict()              # a collective: every process runs it
img = r.image()
if distributed.should_write_output():
    np.savez(out + "/rank0.npz", canvas=st["canvas"], image=img)
else:
    np.savez(out + "/rank1.npz", canvas=st["canvas"], image=img)
distributed.shutdown()
"""


def test_two_process_render(tmp_path):
    """Two processes over gloo, two bands each: both get the whole image,
    equal to the one-process render, through state_dict and image."""
    port = _free_port()
    res = _run_processes([[sys.executable, "-c", _WORKER, str(i), str(port),
                           str(tmp_path)] for i in range(2)])
    for rc, so, se in res:
        assert rc == 0, (so[-1000:], se[-2000:])
    a, b = (np.load(tmp_path / f"rank{i}.npz") for i in range(2))
    np.testing.assert_array_equal(a["canvas"], b["canvas"])
    np.testing.assert_array_equal(a["image"], b["image"])
    one, camera = _renderer(samples=1, bounces=3)
    one.step(camera, time=5)
    np.testing.assert_array_equal(a["canvas"], one.canvas.numpy())
    np.testing.assert_array_equal(a["image"], one.image())


def test_cli_two_processes_against_one(tmp_path):
    """srt-render-torch --all-devices --distributed in two processes: rank
    0's PNG and checkpoint equal the one-process CLI's; rank 1 writes
    nothing."""
    common = ["--config", "2", "--width", "64", "--height", "48",
              "--samples", "1", "--bounces", "3", "--steps", "2",
              "--time-seed", "7", "--device", "cpu"]
    assert cli_main(common + ["--out", str(tmp_path / "one.png"),
                              "--save-state", str(tmp_path / "one.npz")]) == 0
    port = _free_port()
    res = _run_processes([
        [sys.executable, "-m", "simple_raytracer_tpu_torch.cli", *common,
         "--all-devices", "--distributed", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(i),
         "--out", str(tmp_path / f"p{i}.png"), "--save-state",
         str(tmp_path / f"p{i}.npz")] for i in range(2)])
    for rc, so, se in res:
        assert rc == 0, (so[-1000:], se[-2000:])
    assert "2 band(s) over cpu in process 1 of 2" in res[1][2]
    assert not (tmp_path / "p1.png").exists()
    assert not (tmp_path / "p1.npz").exists()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p0.png")),
                                  np.asarray(Image.open(tmp_path / "one.png")))
    with np.load(tmp_path / "p0.npz") as p0, \
            np.load(tmp_path / "one.npz") as one:
        np.testing.assert_array_equal(p0["canvas"], one["canvas"])
        assert int(p0["num_steps"]) == int(one["num_steps"]) == 2


def test_kernel_counts_from_threads():
    """Kernel.count under its lock: 16 threads (more than the cores) with
    a short switch interval lose no launch."""
    import threading
    from simple_raytracer_tpu_torch.ops.cuda.build import Kernel
    kernel = Kernel(REPO / "simple_raytracer_tpu_torch" / "csrc" /
                    "trace_kernel.cu", bind=lambda lib: None)
    n_threads, per_thread = 16, 2000

    def launch(i):
        for _ in range(per_thread):
            kernel.count(f"v{i % 2}")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernel.launches == n_threads * per_thread
    assert kernel.variant_launches == {"v0": n_threads // 2 * per_thread,
                                       "v1": n_threads // 2 * per_thread}
    kernel.reset_counts()
    assert kernel.launches == 0 and not kernel.variant_launches
