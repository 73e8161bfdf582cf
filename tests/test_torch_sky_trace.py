"""A texture skybox through the port's three paths, against
simple_raytracer_tpu.

- The whole-trace form: the plain version (``trace_full_plain``, its nine
  rows then the texture's sample) against the TPU kernel ``_trace_kernel``
  with ``fold_sky=False`` (``trace_full_fused`` on a scene with a skybox,
  in Pallas interpret mode) at 64x16 with 1 sample, for each triangle
  variant: config 2 (none), config 3 (small) and config 4 (clustered),
  each with another of the JAX package's texture forms (rgb8, rgbe, f32).
- The split per-bounce path (``trace_rays(split=True)``, the BVH kernel's
  plain version) and the fused one (``trace_rays_fused``) against the JAX
  ``trace_rays`` with the texture, on config 5 at 48x32.

Interpret mode and ``trace_rays`` run under jit, where XLA:CPU fuses
multiply-adds, so per-ray radiance may drift by float rounding and a
path may flip at a Bernoulli threshold: as tests/test_torch_trace_kernel.py
holds the gradient form, the RMSE is bounded by 2e-3 (the golden bound)
and 99% of rays must agree within 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.io.image import _rgbe_to_float, float_to_rgbe
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import trace as jtrace
from simple_raytracer_tpu.ops.camera import camera_rotation as jrotation
from simple_raytracer_tpu.ops.camera import generate_rays as jgenerate
from simple_raytracer_tpu.ops.pallas import bounce_kernel
from simple_raytracer_tpu.ops.scene_types import SkyboxTex
from simple_raytracer_tpu_torch.ops.camera import camera_rotation
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel as tk
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy
from simple_raytracer_tpu_torch.ops.trace import (add_sky, trace_rays,
                                                  trace_rays_fused)

from torch_port_helpers import (jax_native_accel, jax_scene_arrays, jvec,
                                to_np, tvec)


def _texture(form: str) -> np.ndarray:
    r = np.random.default_rng({"rgb8": 10, "rgbe": 11, "f32": 12}[form])
    if form == "rgb8":
        u8 = r.integers(0, 256, (128, 256, 3), np.uint8)
        return np.power(u8.astype(np.float32) / 255.0, np.float32(2.2),
                        dtype=np.float32)
    if form == "rgbe":
        img = np.exp(r.normal(0.0, 1.0, (64, 128, 3))).astype(np.float32)
        return _rgbe_to_float(float_to_rgbe(img))
    return (r.random((256, 256, 3)) * 2.0 + 0.1).astype(np.float32)


def _scene(n, form, w, h):
    jax_native_accel()
    kw = {"skybox": "gradient"} if n == 3 else {}
    scene, camera, opt = JCONFIGS[n](width=w, height=h, **kw)
    scene.skybox = _texture(form)
    ds = scene.build()
    assert isinstance(ds.skybox, SkyboxTex) == (form != "f32")
    ts = from_numpy(jax_scene_arrays(ds), "cpu")
    assert ts.skybox is not None
    return ds, ts, camera, opt


def _assert_close(a, b):
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    agree = float(np.mean(np.all(np.abs(a - b) < 1e-3, axis=-1)))
    assert rmse < 2e-3, rmse
    assert agree > 0.99, agree


@pytest.mark.parametrize("n, form", [(2, "rgb8"), (3, "rgbe"), (4, "f32")])
def test_whole_trace_with_texture_matches_tpu_kernel(n, form):
    w, h = 64, 16
    ds, ts, camera, opt = _scene(n, form, w, h)
    cam = camera.state(w / h)
    jcol = bounce_kernel.trace_full_fused(
        ds, jrotation(cam.yaw, cam.pitch), cam.position, cam.aspect_ratio,
        cam.fov_scale, jnp.uint32(1000), width=w, height=h, num_samples=1,
        num_bounces=opt.num_bounces, interpret=True)
    args = (ts, camera_rotation(float(cam.yaw), float(cam.pitch)),
            tuple(float(c) for c in cam.position), float(cam.aspect_ratio),
            float(cam.fov_scale), 1000)
    kw = dict(width=w, height=h, num_samples=1, num_bounces=opt.num_bounces)
    tcol = tk.trace_full(*args, **kw)
    rows = tk.trace_full_plain(*args, **kw, rows=True)
    # the nine rows, then the sample: the same radiance, bit for bit
    for a, b in zip(add_sky(ts, *rows), tcol):
        assert torch.equal(a, b)
    sky_mask = torch.stack(list(rows[1]))
    assert float((sky_mask > 0).any(0).float().mean()) > 0.05
    a, b = to_np(jcol), to_np(tcol)
    assert np.isfinite(b).all()
    _assert_close(a, b)


def test_per_bounce_paths_with_texture_match_jax_trace_rays():
    w, h, bounces = 48, 32, 3
    ds, ts, camera, _ = _scene(5, "rgbe", w, h)
    cam = camera.state(w / h)
    o, d, s = jgenerate(w, h, 1, jnp.uint32(7), cam.position,
                        jrotation(cam.yaw, cam.pitch), cam.aspect_ratio,
                        cam.fov_scale)
    want = to_np(jtrace.trace_rays(ds, o, d, s, bounces))
    o, d = tvec(to_np(o)), tvec(to_np(d))
    seed = torch.from_numpy(np.asarray(s).astype(np.int64))
    split = trace_rays(ts, o, d, seed, bounces, split=True)
    fused = trace_rays_fused(ts, o, d, seed, bounces)
    for a, b in zip(split, fused):
        assert torch.equal(a, b)
    got = to_np(split)
    assert np.isfinite(got).all() and got.std() > 0
    _assert_close(want, got)
