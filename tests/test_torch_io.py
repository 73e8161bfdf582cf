"""The port's file I/O (io/stl.py, io/obj.py, io/scene_json.py,
io/image.save_png, the presets' mesh_path, Scene.import_model) against
simple_raytracer_tpu.

Files written by either package load in the other to equal pool arrays,
scenes, cameras and device-scene arrays; malformed and missing files
fail as the JAX loaders fail, with the same messages.
"""
import json

import numpy as np
import pytest

from simple_raytracer_tpu.io import obj as jobj
from simple_raytracer_tpu.io import scene_json as jscene_json
from simple_raytracer_tpu.io import stl as jstl
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.models.shapes import TrianglePool as JPool
from simple_raytracer_tpu_torch.io import obj as tobj
from simple_raytracer_tpu_torch.io import scene_json as tscene_json
from simple_raytracer_tpu_torch.io import stl as tstl
from simple_raytracer_tpu_torch.io.image import save_png
from simple_raytracer_tpu_torch.models.meshgen import organic_blob
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.models.scene import Scene
from simple_raytracer_tpu_torch.models.shapes import TrianglePool

from torch_port_helpers import jax_native_accel, jax_scene_arrays

# (writer, loader) modules of the two packages, both ways
WAYS = {"jax->port": (jobj, jstl, tobj, tstl, TrianglePool),
        "port->jax": (tobj, tstl, jobj, jstl, JPool)}


def _soup(seed: int, n: int = 13):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return pos, nrm


@pytest.mark.parametrize("way", WAYS)
def test_obj_and_stl_cross_load(way, tmp_path):
    wobj, wstl, lobj, lstl, pool_cls = WAYS[way]
    pos, nrm = _soup(11)
    wobj.save_obj(tmp_path / "m.obj", pos, nrm)
    wstl.save_stl(tmp_path / "m.stl", pos)
    for loader, name in ((lobj.load_obj_model, "m.obj"),
                         (lstl.load_stl_model, "m.stl")):
        pool = pool_cls()
        assert loader(tmp_path / name, pool) == (0, 13)
        np.testing.assert_array_equal(pool.positions, pos)
        # the same arrays as the writer's own package loads
        own = JPool() if pool_cls is TrianglePool else TrianglePool()
        own_loader = {"m.obj": (wobj.load_obj_model if wobj is jobj
                                else tobj.load_obj_model),
                      "m.stl": (wstl.load_stl_model if wstl is jstl
                                else tstl.load_stl_model)}[name]
        own_loader(tmp_path / name, own)
        np.testing.assert_array_equal(pool.positions, own.positions)
        np.testing.assert_array_equal(pool.normals, own.normals)
    assert (tmp_path / "m.obj").read_text().startswith("# 13 triangles")
    # the files themselves are the same bytes but for the OBJ's comment
    other = tmp_path / "other"
    other.mkdir()
    lobj.save_obj(other / "m.obj", pos, nrm)
    lstl.save_stl(other / "m.stl", pos)
    assert (other / "m.stl").read_bytes() == (tmp_path / "m.stl").read_bytes()
    strip = lambda p: p.read_text().split("\n", 1)[1]
    assert strip(other / "m.obj") == strip(tmp_path / "m.obj")


BAD_OBJ = [
    "f 1 2\n",
    "v 0 0\n",
    "v a b c\n",
    "v 0 0 0\nf 1 2 3\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1//9 2//9 3//9\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -7 2 3\n",
    "vn 0 0 1\nf 1//1 2//1 3//1\n",
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3 4\nf 1 2 x\n",
]


@pytest.mark.parametrize("bad", BAD_OBJ)
def test_malformed_obj_fails_as_jax(bad, tmp_path):
    p = tmp_path / "bad.obj"
    p.write_text(bad)
    with pytest.raises(ValueError) as want:
        jobj.load_obj_model(p, JPool())
    with pytest.raises(ValueError) as got:
        tobj.load_obj_model(p, TrianglePool())
    assert str(got.value) == str(want.value)


def test_missing_and_short_files_fail_as_jax(tmp_path):
    short = tmp_path / "short.stl"
    short.write_bytes(b"\0" * 83)
    for path in (tmp_path / "none.stl", short):
        assert jstl.load_stl_model(path, JPool()) is None
        assert tstl.load_stl_model(path, TrianglePool()) is None
    assert jobj.load_obj_model(tmp_path / "x.obj", JPool()) is None
    assert tobj.load_obj_model(tmp_path / "x.obj", TrianglePool()) is None
    with pytest.raises(FileNotFoundError):
        Scene().import_model(tmp_path / "none.obj")
    with pytest.raises(FileNotFoundError):
        CONFIGS[4](width=8, height=8, mesh_path=str(tmp_path / "none.stl"))
    for load in (jscene_json.load_scene, tscene_json.load_scene):
        with pytest.raises(FileNotFoundError):
            load(tmp_path / "none.json")


def _scene_doc(path):
    """A scene file's JSON with the side files' contents beside it."""
    doc = json.loads(path.read_text())
    side = {}
    for key in ("pool_file", "skybox_file"):
        if doc.get(key):
            with np.load(path.parent / doc[key]) as f:
                side[key] = {k: f[k] for k in f.files}
    return doc, side


@pytest.mark.parametrize("n", [3, 5])
def test_scene_files_cross_load(n, tmp_path):
    """Config 3 (a box, a skybox texture) and config 5 (a shared pool,
    two transformed models) saved by either package load in the other:
    the reloaded scene saves to the same document and side files, and
    builds to the same device arrays as the preset."""
    jax_native_accel()
    sky = np.random.default_rng(n).random((8, 16, 3), np.float32)
    jscene, jcamera, _ = JCONFIGS[n](width=16, height=8)
    tscene, tcamera, _ = CONFIGS[n](width=16, height=8)
    if n == 3:
        jscene.skybox = tscene.skybox = sky
    tscene.sky_reachable = jscene.sky_reachable = False
    jscene_json.save_scene(tmp_path / "j.json", jscene, jcamera)
    tscene_json.save_scene(tmp_path / "t.json", tscene, tcamera)
    dj, sj = _scene_doc(tmp_path / "j.json")
    dt, st = _scene_doc(tmp_path / "t.json")
    dj.pop("pool_file"), dt.pop("pool_file")
    dj.pop("skybox_file", None), dt.pop("skybox_file", None)
    assert dt == dj
    for key in sj:
        for k in sj[key]:
            np.testing.assert_array_equal(st[key][k], sj[key][k])

    # the JAX file in the port, the port's file in JAX
    scene, camera = tscene_json.load_scene(tmp_path / "j.json")
    jback, jcam = jscene_json.load_scene(tmp_path / "t.json")
    assert camera == tcamera and vars(jcam) == vars(jcamera)
    assert scene.sky_reachable is False and jback.sky_reachable is False
    tscene_json.save_scene(tmp_path / "again.json", scene, camera)
    da, sa = _scene_doc(tmp_path / "again.json")
    da.pop("pool_file"), da.pop("skybox_file", None)
    assert da == dj
    got = scene.arrays()
    want = tscene.arrays()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    carried = jax_scene_arrays(jback.build())
    for k in carried:
        np.testing.assert_array_equal(carried[k], want[k], err_msg=k)


@pytest.mark.parametrize("ext", ["obj", "stl"])
def test_mesh_path_and_import_model_match_jax(ext, tmp_path):
    """Configs 4 and 5 read a mesh file (written by the port from
    organic_blob) into the same scene arrays as the JAX presets; an
    imported model adds the same span."""
    jax_native_accel()
    pos, nrm = organic_blob(subdivisions=2)
    path = str(tmp_path / f"blob.{ext}")
    if ext == "obj":
        tobj.save_obj(path, pos, nrm)
    else:
        tstl.save_stl(path, pos)
    for n in (4, 5):
        scene = CONFIGS[n](width=16, height=8, mesh_path=path)[0]
        jscene = JCONFIGS[n](width=16, height=8, mesh_path=path)[0]
        assert len(scene.pool) == pos.shape[0]
        want = jax_scene_arrays(jscene.build())
        got = scene.arrays()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    scene = Scene()
    m = scene.import_model(path, material=0)
    assert (m.triangle_index, m.num_triangles) == (0, pos.shape[0])
    np.testing.assert_array_equal(scene.pool.positions, pos)


def test_save_png_roundtrip(tmp_path):
    from PIL import Image
    img = np.random.default_rng(2).integers(0, 256, (9, 14, 3), np.uint8)
    save_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  img)
