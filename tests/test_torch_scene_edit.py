"""The port's Scene editing verbs against simple_raytracer_tpu's.

The verbs of tests/test_scene_edit.py (all_shapes, remove_shape by
identity, duplicate_shape, set_material, remove_material,
set_model_transform, import_model) are applied to a JAX Scene and to the
port's Scene alike.  After the same edits the port's built scene equals
the JAX scene's array by array, padding included, and the JAX scene
carried across with the port's from_numpy gives the same tensors.  The
JAX side builds its BVH with its NumPy builder, the one the port has.
"""
import math

import numpy as np
import pytest

from simple_raytracer_tpu.editor import SceneEditor as JEditor
from simple_raytracer_tpu.models.materials import Material as JMaterial
from simple_raytracer_tpu.models.scene import Scene as JScene
from simple_raytracer_tpu.models.shapes import transform_trs as jtrs
from simple_raytracer_tpu_torch.editor import EditError, SceneEditor
from simple_raytracer_tpu_torch.io.stl import save_stl
from simple_raytracer_tpu_torch.models.materials import Material
from simple_raytracer_tpu_torch.models.meshgen import torus
from simple_raytracer_tpu_torch.models.scene import Scene
from simple_raytracer_tpu_torch.models.shapes import transform_trs
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import (jax_native_accel, jax_scene_arrays,
                                port_scene_arrays)


@pytest.fixture(autouse=True)
def jax_native():
    """The JAX package on its default BVH builder, its native library (the
    port's host library builds the same tree)."""
    jax_native_accel()


def assert_same_scene(jscene, tscene):
    """The port's build equals the JAX build array by array, and the JAX
    build carried across equals the port's."""
    want = jax_scene_arrays(jscene.build())
    got = port_scene_arrays(tscene.build("cpu"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(
            np.asarray(got[k], np.asarray(w).dtype), w, err_msg=k)
    carried = port_scene_arrays(from_numpy(want, "cpu"))
    for k, g in got.items():
        np.testing.assert_array_equal(carried[k], g, err_msg=k)
    assert tscene.materials.names == jscene.materials.names


def both():
    return JScene(), Scene()


def test_remove_and_duplicate_shape():
    scenes = both()
    out = []
    for sc in scenes:
        s = sc.add_sphere((0, 0, 0), 1.0)
        b = sc.add_box((1, 0, 0))
        d = sc.duplicate_shape(s)
        assert len(sc.spheres) == 2
        d.position = (5, 0, 0)
        assert sc.spheres[0].position == (0, 0, 0)     # a deep copy
        sc.remove_shape(s)
        assert sc.spheres == [d]
        dup_box = sc.duplicate_shape(b)
        # instancing: the duplicate shares the triangle span
        assert dup_box.triangle_index == b.triangle_index
        assert len(sc.pool) == 12
        sc.set_model_transform(dup_box, transform_trs((0, 2, -1)))
        assert [id(x) for x in sc.all_shapes] == [
            id(x) for x in (*sc.spheres, *sc.planes, *sc.models)]
        out.append(b)
    assert_same_scene(*scenes)
    for sc, b in zip(scenes, out):
        sc.remove_shape(b)
        with pytest.raises(ValueError, match="not in scene"):
            sc.remove_shape(b)
    assert_same_scene(*scenes)
    with pytest.raises(TypeError):
        scenes[1].duplicate_shape("not a shape")


def test_set_material_bounds():
    scenes = both()
    for sc, mat in zip(scenes, (JMaterial, Material)):
        s = sc.add_sphere((0, 0, 0), 1.0)
        m = sc.add_material(mat(color=(1, 0, 0)), "Red")
        sc.set_material(s, m)
        assert s.material == m
        with pytest.raises(IndexError):
            sc.set_material(s, 99)
        with pytest.raises(IndexError):
            sc.set_material(s, -1)
    assert_same_scene(*scenes)


def test_remove_material_reindexes():
    scenes = both()
    for sc, mat in zip(scenes, (JMaterial, Material)):
        a = sc.add_material(mat(smoothness=0.5), "A")
        b = sc.add_material(mat(color=(0, 1, 0)), "B")
        s1 = sc.add_sphere((0, 0, 0), 1, material=a)
        s2 = sc.add_plane((0, -1, 0), (0, 1, 0), material=b)
        sc.remove_material(a)
        assert s1.material == 0 and s2.material == 1
        with pytest.raises(IndexError):
            sc.remove_material(-1)
    assert_same_scene(*scenes)
    # deleting the last material refills Material0
    for sc in scenes:
        while len(sc.materials) > 1:
            sc.remove_material(len(sc.materials) - 1)
        sc.remove_material(0)
        assert sc.materials.names == ["Material0"]
    assert_same_scene(*scenes)


def test_set_model_transform_moves_the_built_triangles():
    scenes = both()
    for sc in scenes:
        sc.add_box((0, 0, 0))
    tscene = scenes[1]
    before = tscene.arrays()
    for sc in scenes:
        sc.set_model_transform(sc.models[0], transform_trs((3, 0, 0)))
        assert sc.models[0].transform.dtype == np.float32
    after = tscene.arrays()
    active = after["triangles.active"]
    np.testing.assert_allclose(
        np.sort(after["triangles.v0"][active, 0]),
        np.sort(before["triangles.v0"][active, 0]) + 3.0, rtol=1e-6)
    assert_same_scene(*scenes)


def test_set_model_transform_on_a_clustered_mesh():
    """A torus of 576 triangles is BVH-clustered; moving it, duplicating
    it and removing the original rebuild the same clusters in both
    packages, and a refit keeps the topology the full build made."""
    pos, nrm = torus()
    scenes = both()
    for sc in scenes:
        span = sc.pool.append(pos, nrm)
        m = sc.add_model(span, transform=transform_trs((0, 0, -4)))
        sc.set_model_transform(m, transform_trs((1, 0.5, -4),
                                                (0.3, 0.2, 0.1)))
        dup = sc.duplicate_shape(m)
        sc.set_model_transform(dup, transform_trs((-1, 0, -5)))
        sc.remove_shape(m)
    assert_same_scene(*scenes)
    tscene = scenes[1]
    topo = tscene._cluster_topo
    tscene.set_model_transform(tscene.models[0], transform_trs((-1, 1, -5)))
    refit = tscene.build("cpu", refit=True)
    assert tscene._cluster_topo is topo
    full = Scene.build(tscene, "cpu")
    assert refit.triangles.clusters.slots.shape == \
        full.triangles.clusters.slots.shape


def test_import_model(tmp_path):
    pos = np.zeros((3, 3, 3), np.float32)
    pos[:, 1, 0] = 1.0
    pos[:, 2, 1] = 1.0
    p = tmp_path / "tri.stl"
    save_stl(p, pos)
    scenes = both()
    for sc, trs in zip(scenes, (jtrs, transform_trs)):
        m = sc.import_model(p, transform=trs((0, 0, -5)))
        assert m.num_triangles == 3 and len(sc.pool) == 3
        with pytest.raises(FileNotFoundError):
            sc.import_model(tmp_path / "missing.obj")
    assert_same_scene(*scenes)


def test_shape_order_is_list_order():
    scenes = both()
    for sc in scenes:
        s1 = sc.add_sphere((0, 0, 0), 1.0)
        s2 = sc.add_sphere((1, 0, 0), 1.0)
        sc.spheres.reverse()
        assert sc.spheres == [s2, s1]
    assert float(scenes[1].build("cpu").spheres.center[0, 0]) == 1.0
    assert_same_scene(*scenes)


def test_remove_shape_matches_by_identity():
    """A duplicate equals its source by value, and a Model's ndarray
    transform makes == raise: remove_shape deletes THE object."""
    scenes = both()
    for sc in scenes:
        s0 = sc.add_sphere((0, 0, -3), 1.0)
        dup = sc.duplicate_shape(s0)
        sc.remove_shape(dup)
        assert sc.spheres == [s0] and sc.spheres[0] is s0
        b0 = sc.add_box((0, 0, -5))
        b1 = sc.add_box((2, 0, -5))
        sc.remove_shape(b1)
        assert len(sc.models) == 1 and sc.models[0] is b0
    assert_same_scene(*scenes)


def test_editor_rotate_scale_and_reorder_verbs():
    """The rotate, scale and reorder verbs through both editors (on a
    scene with a duplicate): the same transforms, the same objects in the
    same order, the same built scene."""
    pos, nrm = torus(n_major=8, n_minor=6)
    scenes = both()
    editors = []
    for sc, ed_cls in zip(scenes, (JEditor, SceneEditor)):
        sc.add_sphere((1, 2, 3), 1.5)
        sc.add_plane((0, -1, 0), (0, 1, 0))
        sc.add_model(sc.pool.append(pos, nrm),
                     transform=transform_trs((0, 0, -4)))
        changes = []
        ed = ed_cls(sc, on_change=lambda: changes.append(1))
        ed.apply({"op": "rotate_shape", "kind": "model", "index": 0,
                  "axis": [0, 1, 0], "angle": math.pi / 2})
        np.testing.assert_allclose(sc.models[0].transform[:3, 0],
                                   [0, 0, -1], atol=1e-6)
        ed.apply({"op": "rotate_shape", "kind": "plane", "index": 0,
                  "axis": [1, 0, 0], "angle": math.pi / 2})
        r = ed.apply({"op": "rotate_shape", "kind": "sphere", "index": 0})
        assert r["ok"] and not r["changed"] and len(changes) == 2
        ed.apply({"op": "scale_shape", "kind": "sphere", "index": 0,
                  "factor": 2.0})
        ed.apply({"op": "scale_shape", "kind": "model", "index": 0,
                  "factor": 0.5})
        ed.apply({"op": "scale_shape", "kind": "model", "index": 0,
                  "factor": 2.0, "axis": "x"})
        ed.apply({"op": "duplicate_shape", "kind": "sphere", "index": 0})
        ids = [id(s) for s in sc.spheres]
        r = ed.apply({"op": "reorder_shape", "kind": "sphere", "index": 1,
                      "to": 0})
        assert r["index"] == 0
        assert [id(s) for s in sc.spheres] == [ids[1], ids[0]]
        editors.append(ed)
    np.testing.assert_array_equal(scenes[1].models[0].transform,
                                  scenes[0].models[0].transform)
    assert scenes[1].planes[0].normal == scenes[0].planes[0].normal
    assert editors[1].describe() == editors[0].describe()
    assert_same_scene(*scenes)
    for ed in editors:
        with pytest.raises(Exception) as e:
            ed.apply({"op": "scale_shape", "kind": "plane", "index": 0,
                      "factor": 2.0})
        assert type(e.value).__name__ == "EditError"
    with pytest.raises(EditError, match="nonzero"):
        editors[1].apply({"op": "rotate_shape", "kind": "model", "index": 0,
                          "axis": [0, 0, 0], "angle": 1.0})
