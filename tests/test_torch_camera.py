"""The port's camera rays and ray-tile order against
simple_raytracer_tpu.ops.camera.

Seeds must match bit for bit.  Directions are held within 1e-6: the two
packages take the rotation's sin and cos from different libraries (numpy
here, XLA there), which may differ in the last bit for a nonzero angle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.ops import camera as jcam
from simple_raytracer_tpu.ops.vec import Vec3 as JVec3
from simple_raytracer_tpu_torch.ops import camera as tcam

from torch_port_helpers import to_np

CASES = [
    # width, height, samples, tile, row0, tile_height, yaw, pitch
    (64, 16, 1, None, 0, None, 0.0, 0.0),
    (128, 32, 2, (8, 64), 0, None, 0.3, -0.2),
    (96, 54, 2, None, 0, None, -1.1, 0.4),
    (64, 48, 2, (8, 16), 16, 24, 0.7, 0.1),     # a band with row0 > 0
    (64, 48, 1, None, 8, 16, 0.0, 0.0),
]


@pytest.mark.parametrize("w,h,s,tile,row0,band,yaw,pitch", CASES)
def test_generate_rays_match(w, h, s, tile, row0, band, yaw, pitch):
    pos, aspect, fov, time = (0.5, -1.0, 5.0), w / h, 0.75, 1234
    jrot = jcam.camera_rotation(jnp.float32(yaw), jnp.float32(pitch))
    trot = tcam.camera_rotation(yaw, pitch)
    np.testing.assert_allclose(np.array([float(c) for c in jrot]),
                               np.array(trot), atol=1e-7)
    jo, jd, js = jcam.generate_rays(
        w, h, s, time, JVec3(*(jnp.float32(c) for c in pos)), jrot,
        jnp.float32(aspect), jnp.float32(fov), row0=row0, tile_height=band,
        tile=tile)
    to, td, ts = tcam.generate_rays(
        w, h, s, time, pos, trot, float(np.float32(aspect)), fov, row0=row0,
        tile_height=band, tile=tile)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64),
                                  ts.numpy())
    np.testing.assert_array_equal(to_np(jo), to_np(to))
    np.testing.assert_allclose(to_np(td), to_np(jd), rtol=0, atol=1e-6)
    if yaw == 0.0 and pitch == 0.0:
        # an exact rotation: the same f32 expressions give the same bits
        np.testing.assert_array_equal(to_np(td), to_np(jd))


@pytest.mark.parametrize("w,h,tile", [(128, 16, (8, 64)), (64, 24, (8, 16)),
                                      (32, 8, (4, 8))])
def test_tile_permutations_match(w, h, tile):
    j = np.asarray(jcam.tiled_pixel_order(w, h, tile))
    t = tcam.tiled_pixel_order(w, h, tile)
    np.testing.assert_array_equal(j.astype(np.int64), t.numpy())
    vals = np.random.default_rng(0).random(w * h).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jcam.untile_pixels(jnp.asarray(vals), w, h, tile)),
        tcam.untile_pixels(torch.from_numpy(vals), w, h, tile).numpy())
    img = np.random.default_rng(1).random((h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        jcam.untile_image(img, tile),
        tcam.untile_image(torch.from_numpy(img), tile).numpy())
    # untiling the tile order gives the row-major identity
    np.testing.assert_array_equal(
        tcam.untile_pixels(t, w, h, tile).numpy(), np.arange(w * h))


def test_tile_must_divide():
    with pytest.raises(ValueError):
        tcam.tiled_pixel_order(60, 16, (8, 64))
