"""The port's sphere/plane intersection and nearest hit against
simple_raytracer_tpu.ops.intersect.

The JAX functions run eagerly, op by op, so both sides evaluate the same
f32 operations in the same order: t, the winner index, the position and
the normal must be identical (tolerance 0).
"""
import numpy as np
import pytest

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import intersect as jint
from simple_raytracer_tpu_torch.ops import intersect as tint
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import jax_scene_arrays, jvec, to_np, tvec, unit_vectors


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    d = unit_vectors(r, n)
    return o, d


def _scenes(n_cfg):
    scene, _, _ = JCONFIGS[n_cfg](width=64, height=16)
    ds = scene.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu")


@pytest.mark.parametrize("n_cfg", [1, 2])
def test_intersect_spheres_and_planes_match(n_cfg):
    ds, ts = _scenes(n_cfg)
    o, d = _rays(20000, n_cfg)
    jt, ji = jint.intersect_spheres(jvec(o), jvec(d), ds.spheres)
    tt, ti = tint.intersect_spheres(tvec(o), tvec(d), ts.spheres)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    jt, ji = jint.intersect_planes(jvec(o), jvec(d), ds.planes)
    tt, ti = tint.intersect_planes(tvec(o), tvec(d), ts.planes)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("n_cfg", [1, 2])
def test_closest_hit_matches(n_cfg):
    ds, ts = _scenes(n_cfg)
    o, d = _rays(20000, 10 + n_cfg)
    jh = jint.closest_hit(ds, jvec(o), jvec(d), tri_backend="jnp")
    th = tint.closest_hit(ts, tvec(o), tvec(d))
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(hit, th.hit.numpy())
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(np.asarray(jh.t), th.t.numpy())
    for a, b in ((jh.position, th.position), (jh.normal, th.normal)):
        np.testing.assert_array_equal(to_np(a)[hit], to_np(b)[hit])
    np.testing.assert_array_equal(np.asarray(jh.front)[hit],
                                  th.front.numpy()[hit])
    np.testing.assert_array_equal(np.asarray(jh.material)[hit],
                                  th.material.numpy()[hit])


def test_tie_goes_to_the_sphere():
    """A ray that meets a sphere and a plane at exactly the same t takes
    the sphere, in both packages; a ray inside a sphere takes the far root
    with the normal flipped toward it."""
    from simple_raytracer_tpu.models.scene import Scene as JScene
    from simple_raytracer_tpu_torch.models.materials import Material
    from simple_raytracer_tpu_torch.models.scene import Scene
    scenes = []
    for cls in (JScene, Scene):
        sc = cls()
        m = sc.add_material(Material(color=(0.2, 0.3, 0.4)), "P")
        sc.add_sphere((0, 0, 0), 1.0, material=0)
        sc.add_plane((0, 0, 0), (0, 1, 0), material=m)   # through the center
        scenes.append(sc)
    ds, ts = scenes[0].build(), scenes[1].build("cpu")
    # grazes the sphere at (0, 0, 1), exactly where it meets the plane
    o = np.array([[0, 3, 1], [0, 0.5, 0]], np.float32)
    d = np.array([[0, -1, 0], [1, 0, 0]], np.float32)
    th = tint.closest_hit(ts, tvec(o), tvec(d))
    jh = jint.closest_hit(ds, jvec(o), jvec(d), tri_backend="jnp")
    assert th.t.numpy()[0] == 3.0
    assert th.material.numpy()[0] == 0 == int(np.asarray(jh.material)[0])
    assert not th.front.numpy()[1]
    np.testing.assert_array_equal(to_np(th.normal), to_np(jh.normal))
