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

from torch_port_helpers import jax_native_accel, jax_scene_arrays

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
def test_renderer_matches_jax_and_golden(n):
    jax_native_accel()
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


def test_config6_split_path_matches_golden():
    """Config 6 (81,920 triangles, 768 clusters of 128) renders through the
    split per-bounce path, the BVH kernel's plain version on the CPU,
    within the golden bound of tests/goldens/config6.npz (64x36; measured
    here: RMSE 2.7e-7)."""
    from simple_raytracer_tpu_torch.ops.trace import takes_whole_trace
    scene, camera, opt = CONFIGS[6](width=64, height=36)
    r = Renderer(RenderOptions(width=64, height=36,
                               num_samples=opt.num_samples,
                               num_bounces=opt.num_bounces), scene=scene,
                 device="cpu")
    assert r.device_scene.triangles.clusters.slots.shape == (768, 128)
    assert not takes_whole_trace(r.device_scene)
    for i in range(STEPS):
        r.step(camera, time=TIME0 + i)
    canvas = r.canvas.numpy()
    assert np.isfinite(canvas).all()
    golden = np.load(os.path.join(GOLDEN_DIR, "config6.npz"))["canvas"]
    assert _rmse(canvas, golden) < BOUND


def test_config4_bvh_backend_matches_jax(monkeypatch):
    """tri_backend="bvh" sends config 4 down the split path in both
    packages (JAX's BVH kernel in interpret mode, as
    tests/test_bvh_kernel.py:426 runs it): the canvases agree within the
    golden bound (measured here: RMSE 2.6e-7), and the port's split path
    agrees with its own whole-trace plain version (RMSE 1.4e-9)."""
    import simple_raytracer_tpu.ops.pallas.bvh_kernel as jbvh
    jax_native_accel()
    orig = jbvh.intersect_triangles_bvh

    def interp(o, d, alive, t_init, aabb, table_t, block_r=1536,
               interpret=False, **kw):
        return orig(o, d, alive, t_init, aabb, table_t, block_r=128,
                    interpret=True, **kw)

    monkeypatch.setattr(jbvh, "intersect_triangles_bvh", interp)
    jscene, jcamera, _ = JCONFIGS[4](width=48, height=32)
    camera = CONFIGS[4](width=48, height=32)[1]
    kw = dict(width=48, height=32, num_samples=1, num_bounces=3)
    jr = JRenderer(JOptions(tri_backend="bvh", **kw), scene=jscene)
    jr.step(jcamera, time=9)
    carried = from_numpy(jax_scene_arrays(jscene.build()), "cpu")
    canvases = []
    for backend in ("bvh", "auto"):
        r = Renderer(RenderOptions(tri_backend=backend, **kw), device="cpu")
        r.set_device_scene(carried)
        r.step(camera, time=9)
        canvases.append(r.canvas.numpy())
    assert np.isfinite(canvases[0]).all()
    assert _rmse(canvases[0], jr.canvas) < BOUND
    assert _rmse(canvases[0], canvases[1]) < BOUND


def test_routing_and_backends():
    """Under "auto" the scenes the whole-trace kernel serves (configs 1 to
    5) take it, configs 6 and 7 (here 20,480 triangles, 256 clusters of
    128) the split path; under "bvh", "clustered", "jnp" and "pallas"
    every scene takes the split path; under "fused" the whole-trace
    kernel serves configs 6 and 7's packed tables too.  A triangle-free
    scene gives the same canvas every way.  Every backend of the JAX
    package is accepted (the last two raised NotImplementedError before
    their port); unknown names raise ValueError."""
    from simple_raytracer_tpu_torch.ops.trace import (TRI_BACKENDS,
                                                      takes_whole_trace)
    kwargs = {**KWARGS, 7: {"subdivisions": 5}}
    scenes = {n: CONFIGS[n](width=32, height=16, **kwargs.get(n, {}))
              for n in CONFIGS}
    built = {n: s.build("cpu") for n, (s, _, _) in scenes.items()}
    assert list(built) == [1, 2, 3, 4, 5, 6, 7]
    assert [n for n in built if takes_whole_trace(built[n])] == [1, 2, 3, 4,
                                                                 5]
    assert [n for n in built if takes_whole_trace(built[n], "fused")] == [
        1, 2, 3, 4, 5, 6, 7]
    for backend in ("bvh", "clustered", "jnp", "pallas"):
        assert not any(takes_whole_trace(b, backend) for b in built.values())
    assert set(TRI_BACKENDS) == {"auto", "bvh", "clustered", "fused", "jnp",
                                 "pallas"}
    _, camera, opt = scenes[2]
    kw = dict(width=32, height=16, num_samples=2, num_bounces=4)
    cam = camera.state(2.0)
    a, *others = (render_pass(built[2], cam, torch.zeros(16, 32, 3), 5,
                              tri_backend=t, **kw)
                  for t in TRI_BACKENDS)
    for b in others:
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for name in ("jnp", "pallas"):
        assert RenderOptions(tri_backend=name).tri_backend == name
    with pytest.raises(ValueError, match="unknown tri_backend"):
        RenderOptions(tri_backend="bogus")
    with pytest.raises(ValueError, match="unknown tri_backend"):
        render_pass(built[2], cam, torch.zeros(16, 32, 3), 5,
                    tri_backend="bogus", **kw)


def test_cuda_split_path_never_takes_the_plain_version(monkeypatch):
    """A device scene on the split path goes to the BVH kernel, which
    raises off the card; no bounce reaches the plain version."""
    import simple_raytracer_tpu_torch.ops.bvh as tbvh
    calls = []
    monkeypatch.setattr(tbvh, "intersect_triangles_bvh_plain",
                        lambda *a, **k: calls.append(a))
    scene, camera, _ = CONFIGS[6](width=16, height=8)
    meta = from_numpy(scene.arrays(), "meta")
    with pytest.raises(ValueError, match="BVH kernel: unsupported device"):
        render_pass(meta, camera.state(2.0), torch.zeros(8, 16, 3,
                                                         device="meta"),
                    5, width=16, height=8, num_samples=1, num_bounces=2)
    assert not calls


def test_benchmark_passes_leave_the_state():
    """benchmark_step's passes run on a scratch canvas: the accumulated
    canvas and step count are what they were (the JAX benchmark_step
    leaves them alone too)."""
    r, camera = _port_renderer(2)
    r.step(camera)
    r.step(camera)
    canvas, steps = r.canvas.clone(), r.num_steps
    ran = []
    orig = r.step
    r.step = lambda cam, time=None: (ran.append(1), orig(cam, time))

    def seconds(run):
        run()
        return 0.25

    assert r._time_passes(camera, 3, 2, seconds) == 0.25
    assert len(ran) == 5
    assert r.num_steps == steps
    np.testing.assert_array_equal(r.canvas.numpy(), canvas.numpy())


class _Route(Exception):
    """Raised where the JAX render_pass commits to a path."""


def _jax_route(monkeypatch, ds, tri_backend):
    """(path, BVH residency) that the JAX render_pass takes on the TPU:
    "whole" (trace_full_fused), "fused" (trace_rays_fused) or "split" (the
    scan path), and "flat", "two_level" or "streamed" for the BVH kernel
    it calls (_kernel, _kernel_packed, _kernel_hbm: intersect_triangles_bvh's
    residency rule), None when it calls none."""
    import jax
    import simple_raytracer_tpu.ops.intersect as jint
    import simple_raytracer_tpu.ops.pallas.bounce_kernel as jbk
    import simple_raytracer_tpu.ops.pallas.bvh_kernel as jbvh
    import simple_raytracer_tpu.ops.trace as jtrace
    from simple_raytracer_tpu.ops.trace import CameraState
    from simple_raytracer_tpu.ops.vec import Vec3 as JVec3
    path = []

    def bvh_call(o, d, alive, t_init, aabb, table_t, hbm_table=None,
                 table_tr=None, **kw):
        packets = table_tr.shape[1] // 24 if table_tr is not None else 1
        packed = (hbm_table is not True
                  and table_t.shape[0] > jbvh.VMEM_TABLE_MAX_SLOTS
                  and table_tr is not None
                  and table_tr.shape[0] * packets
                  <= jbvh.PACKED_VMEM_MAX_CLUSTERS)
        hbm = not packed and (hbm_table if hbm_table is not None
                              else table_t.shape[0]
                              > jbvh.VMEM_TABLE_MAX_SLOTS)
        raise _Route(path[-1], "streamed" if hbm else
                     "two_level" if packed else "flat")

    def whole(*a, **k):
        raise _Route("whole", None)

    fused_orig, hit_orig = jtrace.trace_rays_fused, jtrace.closest_hit

    def fused(*a, **k):
        path.append("fused")
        return fused_orig(*a, **k)

    def split_hit(scene, *a, **k):
        path.append("split")
        hit_orig(scene, *a, **k)
        raise _Route("split", None)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jbk, "trace_full_fused", whole)
    monkeypatch.setattr(jbvh, "intersect_triangles_bvh", bvh_call)
    monkeypatch.setattr(jtrace, "trace_rays_fused", fused)
    monkeypatch.setattr(jtrace, "closest_hit", split_hit)
    cam = CameraState(position=JVec3(0.0, 0.3, 2.5), yaw=0.0,
                      pitch=0.0, aspect_ratio=2.0, fov_scale=0.5)
    try:
        jtrace.render_pass(ds, cam, np.zeros((8, 16, 3), np.float32), 3,
                           width=16, height=8, num_samples=1,
                           num_bounces=2, tri_backend=tri_backend)
    except _Route as r:
        return r.args
    raise AssertionError("the JAX render_pass took no path")


def _port_route(ts, tri_backend):
    from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel as bk
    from simple_raytracer_tpu_torch.ops.trace import (fused_ok,
                                                      takes_whole_trace)
    cl = ts.triangles.clusters
    if takes_whole_trace(ts, tri_backend):
        return "whole", None
    path = "fused" if fused_ok(ts, tri_backend) else "split"
    if cl is None or ts.triangles.material.shape[0] == 0:
        return path, None
    return path, bk.bvh_variant(cl, tri_backend == "clustered")


def test_routing_matches_jax(monkeypatch):
    """render_pass's path and BVH variant for configs 1 to 7 (config 7
    with 20,480 triangles) under "auto", "fused" and "clustered" are the
    JAX render_pass's on the TPU; then again with the packed tables' VMEM
    limits (PACKED_VMEM_MAX_CLUSTERS, MEGA_PACKED_MAX_CLUSTERS) lowered
    in both packages so that config 7 streams, as at full size.  Under
    "auto" the port's routes are those of PR 6: configs 1 to 5 whole,
    6 and 7 split."""
    import simple_raytracer_tpu.ops.pallas.bounce_kernel as jbk
    import simple_raytracer_tpu.ops.pallas.bvh_kernel as jbvh
    import simple_raytracer_tpu_torch.ops.bvh as tbvh
    import simple_raytracer_tpu_torch.ops.scene_types as tst
    jax_native_accel()
    kwargs = {**KWARGS, 7: {"subdivisions": 5}}
    scenes = {}
    for n in range(1, 8):
        ds = JCONFIGS[n](width=16, height=8, **kwargs.get(n, {}))[0].build()
        scenes[n] = (ds, from_numpy(jax_scene_arrays(ds), "cpu"))
    assert scenes[7][1].triangles.clusters.slots.shape == (256, 128)
    auto = {n: _port_route(ts, "auto") for n, (_, ts) in scenes.items()}
    assert auto == {1: ("whole", None), 2: ("whole", None),
                    3: ("whole", None), 4: ("whole", None),
                    5: ("whole", None), 6: ("split", "two_level"),
                    7: ("split", "two_level")}
    for lowered in (False, True):
        with monkeypatch.context() as m:
            if lowered:
                for mod, name in ((jbvh, "PACKED_VMEM_MAX_CLUSTERS"),
                                  (tbvh, "PACKED_VMEM_MAX_CLUSTERS"),
                                  (jbk, "MEGA_PACKED_MAX_CLUSTERS"),
                                  (tst, "MEGA_PACKED_MAX_CLUSTERS")):
                    m.setattr(mod, name, 100)
            for n, (ds, ts) in scenes.items():
                for backend in ("auto", "fused", "clustered"):
                    want = _jax_route(m, ds, backend)
                    assert _port_route(ts, backend) == want, (n, backend,
                                                              lowered)
            if lowered:
                ts = scenes[7][1]
                assert _port_route(ts, "auto") == ("split", "streamed")
                assert _port_route(ts, "fused") == ("fused", "streamed")


def test_config6_fused_matches_golden():
    """Config 6 under tri_backend="fused" is served by the whole-trace
    kernel (768 single-packet clusters, within the TPU's 853), here its
    plain version, a dense loop over the 81,920 triangles: within the
    golden bound of tests/goldens/config6.npz at 64x36 (measured here:
    RMSE 2.674e-7)."""
    from simple_raytracer_tpu_torch.ops.scene_types import whole_trace_variant
    scene, camera, opt = CONFIGS[6](width=64, height=36)
    r = Renderer(RenderOptions(width=64, height=36,
                               num_samples=opt.num_samples,
                               num_bounces=opt.num_bounces,
                               tri_backend="fused"), scene=scene,
                 device="cpu")
    assert whole_trace_variant(r.device_scene, "fused") == "clustered"
    for i in range(STEPS):
        r.step(camera, time=TIME0 + i)
    canvas = r.canvas.numpy()
    assert np.isfinite(canvas).all()
    golden = np.load(os.path.join(GOLDEN_DIR, "config6.npz"))["canvas"]
    assert _rmse(canvas, golden) < BOUND
