"""The port's gradient sky and tonemap against simple_raytracer_tpu.

The sky raises to the powers 0.35 and sun_focus, and XLA:CPU's pow and
PyTorch's differ in the last bit or two, so the sky is held to 4 ulp
relative (rtol 5e-7) plus 1e-7 absolute; every other operation there is
the same f32 arithmetic.  ACES and the u8 tonemap are identical.
"""
import jax.numpy as jnp
import numpy as np
import torch

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import sky as jsky
from simple_raytracer_tpu.ops import tonemap as jtone
from simple_raytracer_tpu_torch.ops import sky as tsky
from simple_raytracer_tpu_torch.ops import tonemap as ttone
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import jax_scene_arrays, jvec, to_np, tvec, unit_vectors


def test_sky_gradient_matches():
    scene, _, _ = JCONFIGS[2](width=64, height=16)
    ds = scene.build()
    ts = from_numpy(jax_scene_arrays(ds), "cpu")
    r = np.random.default_rng(0)
    d = unit_vectors(r, 1 << 16)
    # around the horizon, where both smoothsteps are live, and at the sun
    d[:2000, 1] = r.uniform(-0.02, 0.02, 2000)
    d[:2000] /= np.linalg.norm(d[:2000], axis=1, keepdims=True)
    d[2000:2100] = -np.asarray([float(c) for c in ds.sky.sun_direction])
    j = to_np(jsky.sky_color(jvec(d), ds.sky, None))
    t = to_np(tsky.sky_gradient(tvec(d), ts.sky))
    np.testing.assert_allclose(t, j, rtol=5e-7, atol=1e-7)


def test_aces_and_tonemap_match():
    r = np.random.default_rng(1)
    canvas = (r.random((16, 24, 3)) * 8).astype(np.float32)
    canvas[0, 0] = [0.0, 1e-6, 100.0]
    np.testing.assert_array_equal(
        np.asarray(jtone.aces(jnp.asarray(canvas))),
        ttone.aces(torch.from_numpy(canvas)).numpy())
    for steps in (1, 3, 7):
        j = np.asarray(jtone.tonemap_u8(jnp.asarray(canvas), steps))
        t = ttone.tonemap_u8(torch.from_numpy(canvas), steps).numpy()
        assert t.dtype == np.uint8
        np.testing.assert_array_equal(j, t)
