"""The port's showcase scenes (simple_raytracer_tpu_torch.models.showcase)
against the JAX package's builders: each scene carried across equals the
port's own build array for array, and a small render is within the golden
bound (RMSE < 2e-3) of the JAX Renderer's.  The reference skybox is not
in the repository, so SRT_REFERENCE_SKYBOX points at an .hdr written here
for the texture case."""
import numpy as np
import pytest

from simple_raytracer_tpu.engine import Renderer as JRenderer
from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models import showcase as jshowcase
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.io.image import save_hdr
from simple_raytracer_tpu_torch.models import showcase
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import (jax_native_accel, jax_scene_arrays,
                                port_scene_arrays)

BOUND = 2e-3                     # tests/test_golden.py's RMSE bound
W, H = 32, 18


@pytest.fixture
def jax_native():
    """The JAX package on its default BVH builder, its native library (the
    port's host library builds the same tree)."""
    jax_native_accel()


@pytest.fixture
def no_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("SRT_REFERENCE_SKYBOX", str(tmp_path / "absent.png"))


@pytest.mark.parametrize("name", sorted(showcase.SHOWCASES))
def test_showcase_matches_jax(name, jax_native, no_reference):
    """The builder's scene, camera and options equal the JAX builder's; its
    render at 32x18, 1 spp, 3 bounces is within the golden bound."""
    tscene, tcam, topt = showcase.SHOWCASES[name]()
    jscene, jcam, jopt = jshowcase.SHOWCASES[name]()
    assert tscene.skybox is None and jscene.skybox is None
    assert (topt.width, topt.height, topt.num_samples, topt.num_bounces) == (
        jopt.width, jopt.height, jopt.num_samples, jopt.num_bounces) == (
        960, 540, 2, 10)
    assert tcam.state(1.5) == tuple(
        [tuple(float(c) for c in jcam.state(1.5).position)]
        + [float(getattr(jcam.state(1.5), f)) for f in
           ("yaw", "pitch", "aspect_ratio", "fov_scale")])
    got = port_scene_arrays(tscene.build("cpu"))
    want = jax_scene_arrays(jscene.build())
    carried = port_scene_arrays(from_numpy(want, "cpu"))
    assert sorted(got) == sorted(carried)
    for k, g in got.items():
        np.testing.assert_array_equal(carried[k], g, err_msg=k)

    r = Renderer(RenderOptions(width=W, height=H, num_samples=1,
                               num_bounces=3), tscene, device="cpu")
    jr = JRenderer(JOptions(width=W, height=H, num_samples=1, num_bounces=3),
                   scene=jscene)
    r.step(tcam, time=3)
    jr.step(jcam, time=3)
    canvas = r.canvas.numpy()
    assert canvas.std() > 0
    rmse = float(np.sqrt(np.mean((canvas - np.asarray(jr.canvas)) ** 2)))
    assert rmse < BOUND, rmse


def test_reference_skybox(monkeypatch, tmp_path):
    """load_reference_skybox reads SRT_REFERENCE_SKYBOX as the JAX one
    does, and is None when the file is absent."""
    path = tmp_path / "sky.hdr"
    img = np.random.default_rng(3).random((8, 16, 3), np.float32) * 2
    save_hdr(path, img)
    monkeypatch.setenv("SRT_REFERENCE_SKYBOX", str(path))
    sky = showcase.load_reference_skybox()
    np.testing.assert_array_equal(sky, jshowcase.load_reference_skybox())
    assert showcase.showcase_spheres()[0].skybox.shape == (8, 16, 3)
    monkeypatch.setenv("SRT_REFERENCE_SKYBOX", str(tmp_path / "none.png"))
    assert showcase.load_reference_skybox() is None
    assert showcase.showcase_model()[0].skybox is None


def test_showcase_model_mesh_path(tmp_path):
    """showcase_model takes an STL or OBJ file; a missing one raises."""
    from simple_raytracer_tpu_torch.io.stl import save_stl
    from simple_raytracer_tpu_torch.models.meshgen import organic_blob
    pos, _ = organic_blob(subdivisions=1)
    save_stl(tmp_path / "m.stl", pos)
    scene, _, _ = showcase.showcase_model(mesh_path=str(tmp_path / "m.stl"))
    assert len(scene.models) == 2 and len(scene.pool) == pos.shape[0]
    with pytest.raises(FileNotFoundError):
        showcase.showcase_model(mesh_path=str(tmp_path / "missing.obj"))
