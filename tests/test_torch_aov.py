"""The port's first-hit AOVs (RenderOptions.aov, show_normals) against
simple_raytracer_tpu.

Each mode's canvas at tests/test_aov.py's shape (config 2, 96x54, 2 spp,
4 bounces, so XLA's compile cache is shared with it) against the JAX
Renderer's, and config 5's (a clustered mesh, which the port sends
through the split path's BVH plain version) against JAX's render_pass
called eagerly at 48x32: RMSE < 2e-3 (the golden bound), the u8 images
equal on config 2, as tests/test_torch_render.py requires of the
path-traced image.  (Measured here: RMSE 2.9e-7 and below.)  An AOV
pass never takes the whole-trace kernel or the fused per-bounce path,
under any tri_backend.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.engine import Renderer as JRenderer
from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops.trace import make_render_step
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.ops import scene_types as tst
from simple_raytracer_tpu_torch.ops import trace as trace_mod
from simple_raytracer_tpu_torch.ops.cuda import bvh_kernel, trace_kernel
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import jax_native_accel, jax_scene_arrays

MODES = ("normals", "depth", "albedo")
BOUND = 2e-3


def _rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("aov", MODES)
def test_config2_aov_matches_jax(aov):
    jscene, jcamera, _ = JCONFIGS[2](width=96, height=54)
    jr = JRenderer(JOptions(width=96, height=54, num_samples=2,
                            num_bounces=4, aov=aov), scene=jscene)
    scene, camera, _ = CONFIGS[2](width=96, height=54)
    r = Renderer(RenderOptions(width=96, height=54, num_samples=2,
                               num_bounces=4, aov=aov), scene, device="cpu")
    jr.step(jcamera, time=1)
    r.step(camera, time=1)
    canvas = r.canvas.numpy()
    assert np.isfinite(canvas).all() and canvas.std() > 0
    assert _rmse(canvas, jr.canvas) < BOUND
    np.testing.assert_array_equal(r.image(), np.asarray(jr.image()))
    if aov == "depth":
        # grey, a miss exactly 0 (the sky rows), the ground plane above 0
        np.testing.assert_array_equal(canvas[..., 0], canvas[..., 2])
        assert canvas[0, :, 0].max() == 0.0 and canvas[-1, :, 0].min() > 0


def test_show_normals_is_the_normals_aov():
    scene, camera, _ = CONFIGS[2](width=64, height=32)
    canvases = []
    for kw in ({"show_normals": True}, {"aov": "normals"}):
        r = Renderer(RenderOptions(width=64, height=32, num_samples=1,
                                   num_bounces=4, **kw), scene, device="cpu")
        r.step(camera, time=5)
        canvases.append(r.canvas.numpy())
    np.testing.assert_array_equal(*canvases)
    with pytest.raises(ValueError, match="unknown aov"):
        RenderOptions(aov="beauty-pass")


@pytest.mark.parametrize("aov", MODES)
def test_config5_aov_through_bvh_matches_jax(aov, monkeypatch):
    """Config 5's two clustered sculpts: the port's AOV takes the split
    path, whose nearest triangle is the BVH wrapper's (its plain version
    on the CPU, one call a pass), against JAX's render_pass (its dense
    loop on the CPU) on the same scene, carried across."""
    jax_native_accel()
    w, h = 48, 32
    jscene, jcamera, _ = JCONFIGS[5](width=w, height=h)
    ds = jscene.build()
    fn = make_render_step(w, h, 1, 6, show_normals=aov, jit=False)
    want = np.asarray(fn(ds, jcamera.state(w / h),
                         jnp.zeros((h, w, 3), jnp.float32), jnp.uint32(3)))
    _, camera, _ = CONFIGS[5](width=w, height=h)
    calls = []
    orig = bvh_kernel.intersect_triangles_bvh
    monkeypatch.setattr(bvh_kernel, "intersect_triangles_bvh",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    r = Renderer(RenderOptions(width=w, height=h, num_samples=1,
                               num_bounces=6, aov=aov), device="cpu")
    r.set_device_scene(from_numpy(jax_scene_arrays(ds), "cpu"))
    r.step(camera, time=3)
    assert calls == [1]
    canvas = r.canvas.numpy()
    assert np.isfinite(canvas).all() and canvas.std() > 0
    assert _rmse(canvas, want) < BOUND


@pytest.fixture(scope="module")
def route_scenes():
    """Config 2 (no triangle), config 5 (clustered, inside the
    whole-trace envelope) and config 7 cut to 20,480 triangles (256
    clusters of 128: beyond the envelope under "auto"; under "fused" too
    once MEGA_PACKED_MAX_CLUSTERS is lowered)."""
    out = {}
    for n, kw in ((2, {}), (5, {}), (7, {"subdivisions": 5})):
        scene, camera, _ = CONFIGS[n](width=16, height=8, **kw)
        out[n] = (scene.build("cpu"), camera)
    return out


def _pass(ds, camera, backend, aov):
    return trace_mod.render_pass(
        ds, camera.state(2.0), torch.zeros(8, 16, 3), 9, width=16, height=8,
        num_samples=1, num_bounces=3, tri_backend=backend, aov=aov)


@pytest.mark.parametrize("backend", trace_mod.TRI_BACKENDS)
def test_aov_never_takes_whole_trace_or_fused(backend, route_scenes,
                                              monkeypatch):
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} taken")
        return f

    monkeypatch.setattr(tst, "MEGA_PACKED_MAX_CLUSTERS", 100)
    monkeypatch.setattr(trace_kernel, "trace_full", refuse("trace_full"))
    monkeypatch.setattr(trace_mod, "trace_rays_fused",
                        refuse("trace_rays_fused"))
    for n, (ds, camera) in route_scenes.items():
        for aov in MODES:
            assert torch.isfinite(_pass(ds, camera, backend, aov)).all()
    # the same scenes' path-traced passes do take them
    want = {("auto", 5): "trace_full", ("fused", 5): "trace_full",
            ("fused", 7): "trace_rays_fused"}
    for n in (5, 7):
        if (backend, n) in want:
            with pytest.raises(AssertionError, match=want[backend, n]):
                _pass(*route_scenes[n], backend, None)
