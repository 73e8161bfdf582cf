"""The port's host scene build against simple_raytracer_tpu's.

For configs 1 to 5, the port's Scene.build() must equal the JAX
Scene.build() array by array, padding slots included, the triangles in
BVH order and the cluster boxes and slots too, and the JAX scene carried
across with from_numpy must give the same tensors.  Both packages run on
their default BVH builders, the binned SAH of the JAX package's native
library and of the port's host library, and again on the NumPy median
split of both.
"""
import numpy as np
import pytest
import torch

import simple_raytracer_tpu.accel
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu_torch import accel
from simple_raytracer_tpu_torch.models.meshgen import organic_blob
from simple_raytracer_tpu_torch.models.presets import CONFIGS as TCONFIGS
from simple_raytracer_tpu_torch.models.scene import Scene
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import (BUILDERS, jax_scene_arrays, port_scene_arrays,
                                use_builder)

# the gradient sky, as tests/test_golden.py pins it
KWARGS = {3: {"skybox": "gradient"}}


@pytest.fixture(params=BUILDERS)
def builder(request, monkeypatch):
    """Both packages on one BVH builder (``use_builder``): "sah", each
    one's default, or "median", the NumPy median split of both."""
    use_builder(monkeypatch, request.param)
    return request.param


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_scene_build_matches_jax(n, builder):
    jscene, jcam, jopt = JCONFIGS[n](**KWARGS.get(n, {}))
    tscene, tcam, topt = TCONFIGS[n](**KWARGS.get(n, {}))
    want = jax_scene_arrays(jscene.build())
    n_tris = {1: 0, 2: 0, 3: 16, 4: 2048, 5: 4096, 6: 131072}[n]
    assert want["triangles.material"].shape == (n_tris,)
    assert ("clusters.slots" in want) == (n >= 4)
    if n == 6:   # K = 128, 640 clusters padded to a multiple of 128
        assert want["clusters.slots"].shape == (768, 128)
    got = port_scene_arrays(tscene.build("cpu"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray) and w.ndim:
            assert g.shape == w.shape, k
        np.testing.assert_array_equal(np.asarray(g, np.asarray(w).dtype), w,
                                      err_msg=k)
    # the host-side arrays (padding slots included) are the same too
    for k, g in tscene.arrays().items():
        np.testing.assert_array_equal(np.asarray(g, np.asarray(want[k]).dtype),
                                      want[k], err_msg=k)
    assert (topt.width, topt.height, topt.num_samples, topt.num_bounces) == (
        jopt.width, jopt.height, jopt.num_samples, jopt.num_bounces)
    assert tcam.state(1.5) == tuple(
        [tuple(float(c) for c in jcam.state(1.5).position)]
        + [float(getattr(jcam.state(1.5), f)) for f in
           ("yaw", "pitch", "aspect_ratio", "fov_scale")])
    # the JAX scene carried across equals the port's own build
    carried = port_scene_arrays(from_numpy(jax_scene_arrays(jscene.build()), "cpu"))
    for k, g in got.items():
        np.testing.assert_array_equal(carried[k], g, err_msg=k)


def test_padding_buckets():
    s = Scene()
    for i in range(5):
        s.add_sphere((i, 0, 0), 0.5)
    a = s.arrays()
    assert a["spheres.center"].shape == (8, 3)
    assert a["spheres.active"].tolist() == [True] * 5 + [False] * 3
    assert a["spheres.radius"][5:].tolist() == [1.0] * 3
    assert a["planes.position"].shape == (0, 3)
    assert a["materials.smoothness"].shape == (4,)
    assert a["materials.refraction_index"][1:].tolist() == [1.0] * 3
    ts = s.build("cpu")
    assert ts.planes.material.shape == (0,)
    assert ts.spheres.material.dtype == torch.int64


def test_meshes_and_skyboxes_are_a_later_slice():
    """Model files were a later slice until the CLI's (tests/
    test_torch_io.py holds them to JAX): a file that cannot be opened
    raises FileNotFoundError, as in JAX.  A texture skybox builds (it was
    a later slice until the texture's port): the scene's, and config 3's
    explicit array, as an (H, W, 3) f32 tensor."""
    s = Scene()
    with pytest.raises(FileNotFoundError, match="suzanne.obj"):
        s.import_model("suzanne.obj")
    with pytest.raises(FileNotFoundError, match="suzanne.obj"):
        TCONFIGS[4](mesh_path="suzanne.obj")
    tex = np.random.default_rng(2).random((4, 8, 3)).astype(np.float32)
    s.skybox = tex
    built = s.build("cpu").skybox
    assert built.dtype == torch.float32
    np.testing.assert_array_equal(built.numpy(), tex)
    scene, _, _ = TCONFIGS[3](skybox=tex)
    np.testing.assert_array_equal(scene.build("cpu").skybox.numpy(), tex)
    for mode in ("auto", "gradient"):   # both are the gradient sky here
        assert TCONFIGS[3](skybox=mode)[0].skybox is None


def test_clusters_match_jax(builder):
    """The BVH and its cut into clusters equal the JAX package's build on
    the same builder: boxes, slots and the reorder permutation."""
    pos, _ = organic_blob(subdivisions=3)
    for k in (64, 128):
        got = accel.build_clusters(pos, k=k)
        want = simple_raytracer_tpu.accel.build_clusters(pos, k=k)
        assert got.k == want.k == k
        for f in ("aabb", "slots", "order"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
    bvh = accel.build_bvh(pos, leaf_size=8)
    want = simple_raytracer_tpu.accel.build_bvh(pos, leaf_size=8)
    for f in ("nodes", "meta", "order"):
        np.testing.assert_array_equal(getattr(bvh, f), getattr(want, f))
    simple_raytracer_tpu.accel.validate_bvh(bvh, pos)


def test_mesh_instances_and_boxes(builder):
    """Boxes and model instances flatten to world space as in the JAX
    package; at the cluster threshold a mesh is BVH-clustered into
    K = 64 slots, padded with 3e38 boxes to a power of two."""
    from simple_raytracer_tpu.models.scene import Scene as JScene
    pos, nrm = organic_blob(subdivisions=2)              # 320 triangles
    scenes = []
    for cls in (JScene, Scene):
        sc = cls()
        sc.add_box((1, 2, 3), size=(2.0, 0.5, 1.0))
        span = sc.pool.append(pos, nrm)
        sc.add_model(span, transform=np.diag([2, 2, 2, 1]).astype(np.float32))
        sc.add_model(span)
        scenes.append(sc)
    want = jax_scene_arrays(scenes[0].build())
    got = scenes[1].arrays()
    assert got["triangles.active"].sum() == 12 + 2 * 320
    assert got["clusters.slots"].shape[1] == 64
    assert (got["clusters.aabb"][got["clusters.slots"][:, 0] < 0, :6]
            == np.float32(3e38)).all()
    for k, g in got.items():
        if k.startswith(("triangles.", "clusters.")):
            np.testing.assert_array_equal(g, want[k], err_msg=k)


def test_bad_material_index_is_refused():
    s = Scene()
    s.add_sphere((0, 0, 0), 1.0, material=9)   # the table has 4 rows
    with pytest.raises(ValueError, match="material index"):
        s.build("cpu")
    s = Scene()
    s.add_box((0, 0, 0), material=4)
    with pytest.raises(ValueError, match="triangles.material"):
        s.build("cpu")


def test_auto_skybox_raises_when_the_reference_texture_exists(monkeypatch,
                                                              tmp_path):
    """Config 3's "auto" loads the reference skybox texture when it exists
    (SRT_REFERENCE_SKYBOX, else the reference checkout's), as the JAX
    package does; it raised before the texture's port, and now loads it
    through the port's load_skybox.  Without the file it is the gradient
    sky, and "gradient" always is."""
    from simple_raytracer_tpu_torch.io.image import save_hdr
    tex = tmp_path / "skybox.hdr"
    img = np.full((4, 8, 3), 0.5, np.float32)
    img[0] = 2.0
    save_hdr(tex, img)
    monkeypatch.setenv("SRT_REFERENCE_SKYBOX", str(tex))
    np.testing.assert_array_equal(TCONFIGS[3](skybox="auto")[0].skybox,
                                  img[::-1])
    assert TCONFIGS[3](skybox="gradient")[0].skybox is None
    monkeypatch.setenv("SRT_REFERENCE_SKYBOX", str(tmp_path / "missing.png"))
    assert TCONFIGS[3](skybox="auto")[0].skybox is None
