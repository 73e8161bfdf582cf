"""The port's host scene build against simple_raytracer_tpu's.

For configs 1 and 2, the port's Scene.build() must equal the JAX
Scene.build() array by array, padding slots included, and the JAX scene
carried across with from_numpy must give the same tensors.
"""
import numpy as np
import pytest
import torch

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu_torch.models.presets import CONFIGS as TCONFIGS
from simple_raytracer_tpu_torch.models.scene import Scene
from simple_raytracer_tpu_torch.ops.scene_types import (MATERIAL_FIELDS,
                                                        SKY_VECTORS,
                                                        from_numpy)

from torch_port_helpers import jax_scene_arrays


def _flat(ts) -> dict:
    """The port's DeviceScene back to the from_numpy names."""
    out = {}
    for cat, fields in (("spheres", ("center", "radius", "material",
                                     "active")),
                        ("planes", ("position", "normal", "material",
                                    "active")),
                        ("materials", MATERIAL_FIELDS + ("color",
                                                         "emission"))):
        for f in fields:
            out[f"{cat}.{f}"] = getattr(getattr(ts, cat), f).numpy()
    out["sky.sun_focus"] = ts.sky.sun_focus
    out["sky.sun_intensity"] = ts.sky.sun_intensity
    for k in SKY_VECTORS:
        out[f"sky.{k}"] = np.array(getattr(ts.sky, k), np.float32)
    out["sky_reachable"] = ts.sky_reachable
    return out


@pytest.mark.parametrize("n", [1, 2])
def test_scene_build_matches_jax(n):
    jscene, jcam, jopt = JCONFIGS[n]()
    tscene, tcam, topt = TCONFIGS[n]()
    want = jax_scene_arrays(jscene.build())
    assert want.pop("triangles.material").shape == (0,)
    got = _flat(tscene.build("cpu"))
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
    carried = _flat(from_numpy(jax_scene_arrays(jscene.build()), "cpu"))
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
    s = Scene()
    for add in (s.add_model, s.add_box, s.import_model):
        with pytest.raises(NotImplementedError, match="mesh scenes"):
            add((0, 12))
    arrays = s.arrays()
    arrays["triangles.material"] = np.zeros(12, np.int32)
    with pytest.raises(NotImplementedError, match="mesh scenes"):
        from_numpy(arrays, "cpu")
    s.skybox = np.zeros((4, 8, 3), np.float32)
    with pytest.raises(NotImplementedError, match="skybox"):
        s.build("cpu")


def test_bad_material_index_is_refused():
    s = Scene()
    s.add_sphere((0, 0, 0), 1.0, material=9)   # the table has 4 rows
    with pytest.raises(ValueError, match="material index"):
        s.build("cpu")
