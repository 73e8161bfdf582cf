"""The port's sphere/plane/triangle intersection and nearest hit against
simple_raytracer_tpu.ops.intersect and the TPU kernel's triangle loop.

The JAX functions run eagerly, op by op, so both sides evaluate the same
f32 operations in the same order: t, the winner index, the position and
the normal must be identical (tolerance 0) for spheres and planes, and
the triangle intersection must equal bounce_kernel._tris_small's.  The
JAX scan path's smooth normal comes from barycentric weights of the hit
position, the port's (as the TPU kernel's) from MT's own (u, v), so mesh
normals agree to float rounding only.
"""
import numpy as np
import pytest

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import intersect as jint
from simple_raytracer_tpu.ops.pallas import bounce_kernel
from simple_raytracer_tpu.ops.vec import Vec3 as JVec3
from simple_raytracer_tpu_torch.ops import intersect as tint
from simple_raytracer_tpu_torch.ops import triangle
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import jax_scene_arrays, jvec, to_np, tvec, unit_vectors


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    d = unit_vectors(r, n)
    return o, d


def _scenes(n_cfg):
    kw = {"skybox": "gradient"} if n_cfg == 3 else {}
    scene, _, _ = JCONFIGS[n_cfg](width=64, height=16, **kw)
    ds = scene.build()
    return ds, from_numpy(jax_scene_arrays(ds), "cpu")


def _mesh_rays(ts, n, seed):
    """Rays from around the mesh toward random points of its box."""
    r = np.random.default_rng(seed)
    tr = ts.triangles
    v = tr.v0.numpy()[tr.active.numpy()]
    target = r.uniform(v.min(0), v.max(0), size=(n, 3)).astype(np.float32)
    o = (target + 3.0 * r.normal(size=(n, 3))).astype(np.float32)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


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


def test_small_triangles_match_tpu_kernel():
    """Config 3's 16-slot table: t, the material and the unnormalized
    smooth normal equal bounce_kernel._tris_small's, run eagerly on
    (1, N) rows (tolerance: 1 ulp)."""
    ds, ts = _scenes(3)
    o, d = _mesh_rays(ts, 4000, 3)
    row = lambda a: JVec3(*(c[None, :] for c in jvec(a)))
    jt, jn, jm = bounce_kernel._tris_small(
        bounce_kernel.small_tris_table(ds), row(o), row(d))
    tt, ti, u, v = tint.intersect_triangles(tvec(o), tvec(d), ts.triangles)
    tn = tint.triangle_normal(ts.triangles, ti, u, v)
    jt = np.asarray(jt)[0]
    hit = np.isfinite(jt)
    assert hit.mean() > 0.5
    np.testing.assert_array_max_ulp(tt.numpy(), jt, maxulp=1)
    np.testing.assert_array_max_ulp(to_np(tn)[hit], to_np(jn)[0][hit],
                                    maxulp=1)
    np.testing.assert_array_equal(ts.triangles.material[ti].numpy()[hit],
                                  np.asarray(jm)[0][hit].astype(np.int64))


def test_triangle_chunks_compose(monkeypatch):
    """The dense triangle loop gives the same winners, (u, v) included,
    whatever its chunk size: the first minimum wins across chunks."""
    _, ts = _scenes(4)
    o, d = _mesh_rays(ts, 500, 7)
    whole = tint.intersect_triangles(tvec(o), tvec(d), ts.triangles)
    for chunk in (1, 7, 256):
        monkeypatch.setitem(triangle.TRI_CHUNK_ELEMS, "cpu", 500 * chunk)
        part = tint.intersect_triangles(tvec(o), tvec(d), ts.triangles)
        for a, b in zip(whole, part):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n_cfg", [3, 4, 5])
def test_closest_hit_matches_dense_meshes(n_cfg):
    """Against the JAX dense scan path (tri_backend="jnp", one chunk so it
    runs eagerly): the same hits, t and materials; normals within 1e-4,
    the two interpolations' rounding (measured here: 2.6e-5 at most, the
    hit position's p - v0 cancelling in the JAX form)."""
    ds, ts = _scenes(n_cfg)
    o, d = _mesh_rays(ts, 4000, 20 + n_cfg)
    jh = jint.closest_hit(ds, jvec(o), jvec(d), tri_backend="jnp",
                          tri_chunk=4096)
    th = tint.closest_hit(ts, tvec(o), tvec(d))
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(hit, th.hit.numpy())
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(jh.t), th.t.numpy())
    np.testing.assert_array_equal(np.asarray(jh.material)[hit],
                                  th.material.numpy()[hit])
    np.testing.assert_allclose(to_np(th.normal)[hit],
                               to_np(jh.normal)[hit], rtol=0, atol=1e-4)
    # the triangle flag marks the hits whose t is the nearest triangle's
    tri = th.triangle.numpy()
    t_tri = tint.intersect_triangles(tvec(o), tvec(d), ts.triangles)[0]
    assert tri.any() and not (tri & ~hit).any()
    np.testing.assert_array_equal(th.t.numpy()[tri], t_tri.numpy()[tri])
