"""The port's whole progressive pass against simple_raytracer_tpu.

Configs 1 to 5 render at the golden sizes (tests/test_golden.py) through
the port's Renderer on the CPU, which runs the plain version of the trace
kernel, with the JAX scene carried across through from_numpy.  They are
held to the JAX Renderer and to tests/goldens/config{1..5}.npz at the
golden bound RMSE < 2e-3.  (Measured here: config 1 is bit-identical,
configs 2 to 5 are 3e-7 to 7e-7 off, from XLA:CPU's fused multiply-adds
and its pow, and for meshes from the smooth normal, which the port
interpolates at MT's (u, v) and the JAX scan path at barycentric weights
of the hit position.)  The JAX scene is built with the JAX package's
NumPy BVH builder, the one the port has, so that the port's own build and
the carried one are the same scene.
"""
import os

import numpy as np
import pytest
import torch

from simple_raytracer_tpu.engine import Renderer as JRenderer
from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.trace import render_pass

from torch_port_helpers import jax_scene_arrays

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SIZES = {1: (64, 64), 2: (96, 54), 3: (96, 54), 4: (96, 54), 5: (96, 54)}
# the gradient sky, as tests/test_golden.py pins it
KWARGS = {3: {"skybox": "gradient"}}
STEPS, TIME0 = 2, 1000
BOUND = 2e-3


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _port_renderer(n, scene=None, **kw):
    w, h = SIZES[n]
    tscene, camera, opt = CONFIGS[n](width=w, height=h, **KWARGS.get(n, {}))
    r = Renderer(RenderOptions(width=w, height=h,
                               num_samples=opt.num_samples,
                               num_bounces=opt.num_bounces, **kw),
                 scene=tscene if scene is None else None, device="cpu")
    if scene is not None:
        r.set_device_scene(scene)
    return r, camera


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_renderer_matches_jax_and_golden(n, monkeypatch):
    import simple_raytracer_tpu.accel
    monkeypatch.setattr(simple_raytracer_tpu.accel, "_load_library",
                        lambda: None)
    w, h = SIZES[n]
    jscene, jcamera, jopt = JCONFIGS[n](width=w, height=h,
                                        **KWARGS.get(n, {}))
    jr = JRenderer(JOptions(width=w, height=h, num_samples=jopt.num_samples,
                            num_bounces=jopt.num_bounces), scene=jscene)
    carried = from_numpy(jax_scene_arrays(jscene.build()), "cpu")
    r, camera = _port_renderer(n, scene=carried)
    own, _ = _port_renderer(n)
    for i in range(STEPS):
        jr.step(jcamera, time=TIME0 + i)
        r.step(camera, time=TIME0 + i)
        own.step(camera, time=TIME0 + i)
    canvas = r.canvas.numpy()
    assert canvas.shape == (h, w, 3) and np.isfinite(canvas).all()
    np.testing.assert_array_equal(own.canvas.numpy(), canvas)
    assert _rmse(canvas, jr.canvas) < BOUND
    golden = np.load(os.path.join(GOLDEN_DIR, f"config{n}.npz"))["canvas"]
    assert _rmse(canvas, golden) < BOUND
    np.testing.assert_array_equal(r.image(), np.asarray(jr.image()))


def test_renderer_api():
    r, camera = _port_renderer(1)
    r.step(camera)
    one_pass = r.canvas.clone()
    img = r.render(camera, num_steps=1)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    assert r.num_steps == 2 and img.std() > 0
    # reset restarts the default time counter: the first pass repeats
    r.render(camera, num_steps=1, reset=True)
    assert r.num_steps == 1
    np.testing.assert_array_equal(r.canvas.numpy(), one_pass.numpy())
    r.clear_canvas()
    assert r.num_steps == 0 and float(r.canvas.abs().sum()) == 0.0
    with pytest.raises(RuntimeError, match="times the card"):
        r.benchmark_step(camera)
    with pytest.raises(RuntimeError, match="no scene"):
        Renderer(RenderOptions(width=64, height=8), device="cpu").step(camera)


@pytest.mark.parametrize("ray_tile", [None, (8, 16)])
def test_bands_and_tile_order_compose(ray_tile):
    """Two horizontal bands (row0 > 0) give the full image exactly, and
    the tile order changes no pixel: pixel ids and RNG streams are
    global."""
    scene, camera, opt = CONFIGS[2](width=64, height=32)
    ds = scene.build("cpu")
    kw = dict(width=64, height=32, num_samples=2, num_bounces=4)
    cam = camera.state(2.0)
    full = render_pass(ds, cam, torch.zeros(32, 64, 3), 77, **kw)
    tiled = render_pass(ds, cam, torch.zeros(32, 64, 3), 77, ray_tile=ray_tile,
                        **kw)
    np.testing.assert_array_equal(full.numpy(), tiled.numpy())
    bands = [render_pass(ds, cam, torch.zeros(16, 64, 3), 77, row0=y,
                         tile_height=16, ray_tile=ray_tile, **kw)
             for y in (0, 16)]
    np.testing.assert_array_equal(full.numpy(), torch.cat(bands).numpy())


def test_no_cuda_means_no_default_device():
    """Renderer(options, scene) with no device asks for the card; without
    CUDA it raises instead of moving to the CPU."""
    scene, _, opt = CONFIGS[2](width=32, height=16)
    if torch.cuda.is_available():
        assert Renderer(opt, scene).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Renderer(opt, scene)
    with pytest.raises(ValueError, match="unsupported device"):
        Renderer(opt, scene, device="meta")
