"""The port's engine state against simple_raytracer_tpu: checkpoints
(Renderer.state_dict / load_state_dict) across the two packages, a resume
equal to an uninterrupted render, tile_image, refit_clusters and the
scene's cluster-topology cache, and RenderOptions.tri_chunk (accepted,
changing nothing)."""
import numpy as np
import pytest
import torch

from simple_raytracer_tpu import accel as jaccel
from simple_raytracer_tpu.engine import Renderer as JRenderer
from simple_raytracer_tpu.engine import RenderOptions as JOptions
from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.models.shapes import transform_trs as jtrs
from simple_raytracer_tpu.ops.camera import tile_image as jtile_image
from simple_raytracer_tpu_torch import accel
from simple_raytracer_tpu_torch.engine import Renderer, RenderOptions
from simple_raytracer_tpu_torch.models.presets import CONFIGS
from simple_raytracer_tpu_torch.models.shapes import transform_trs
from simple_raytracer_tpu_torch.ops.camera import tile_image, untile_image

from torch_port_helpers import BUILDERS, jax_scene_arrays, use_builder

W, H = 64, 32


def _renderer(n=2, **kw):
    scene, camera, opt = CONFIGS[n](width=W, height=H)
    r = Renderer(RenderOptions(width=W, height=H, num_samples=1,
                               num_bounces=opt.num_bounces, **kw), scene,
                 device="cpu")
    return r, camera


def test_checkpoint_round_trip_between_packages():
    """A port checkpoint restores in the JAX Renderer (and the other way)
    to the same canvas, step count and u8 image."""
    r, camera = _renderer()
    for t in (3, 4, 5):
        r.step(camera, time=t)
    st = r.state_dict()
    assert st["canvas"].dtype == np.float32 and st["num_steps"] == 3
    jscene, _, _ = JCONFIGS[2](width=W, height=H)
    jr = JRenderer(JOptions(width=W, height=H, num_samples=1,
                            num_bounces=4), scene=jscene)
    jr.load_state_dict(st)
    jst = jr.state_dict()
    np.testing.assert_array_equal(np.asarray(jst["canvas"]), st["canvas"])
    assert jst["num_steps"] == 3
    np.testing.assert_array_equal(np.asarray(jr.image()), r.image())

    canvas = np.random.default_rng(8).random((H, W, 3), np.float32) * 5
    jr.load_state_dict({"canvas": canvas, "num_steps": 7})
    back, _ = _renderer()
    back.load_state_dict(jr.state_dict())
    np.testing.assert_array_equal(back.state_dict()["canvas"], canvas)
    assert back.num_steps == 7
    np.testing.assert_array_equal(back.image(), np.asarray(jr.image()))
    with pytest.raises(ValueError, match="canvas shape"):
        back.load_state_dict({"canvas": canvas[:8], "num_steps": 1})


@pytest.mark.parametrize("ray_tile", ["auto", None])
def test_resume_equals_uninterrupted(ray_tile):
    """Two passes, a checkpoint restored into a new renderer and two more
    passes give the canvas of four passes, bit for bit."""
    full, camera = _renderer(ray_tile=ray_tile)
    assert (full.ray_tile is None) == (ray_tile is None)
    for t in range(10, 14):
        full.step(camera, time=t)
    first, _ = _renderer(ray_tile=ray_tile)
    for t in (10, 11):
        first.step(camera, time=t)
    resumed, _ = _renderer(ray_tile=ray_tile)
    resumed.load_state_dict(first.state_dict())
    for t in (12, 13):
        resumed.step(camera, time=t)
    assert resumed.num_steps == 4
    np.testing.assert_array_equal(resumed.canvas.numpy(),
                                  full.canvas.numpy())
    np.testing.assert_array_equal(resumed.image(), full.image())


def test_tile_image_inverts_untile_image():
    img = np.random.default_rng(3).random((16, 128, 3), np.float32)
    for tile in ((8, 64), (4, 16), (16, 128)):
        tiled = tile_image(torch.from_numpy(img), tile)
        np.testing.assert_array_equal(tiled.numpy(), jtile_image(img, tile))
        np.testing.assert_array_equal(untile_image(tiled, tile).numpy(), img)


def test_refit_clusters_matches_jax():
    """Seeded moves of a clustered mesh: the port's refit boxes equal
    JAX's, and bound every moved triangle of their cluster."""
    rng = np.random.default_rng(21)
    pos = rng.normal(size=(700, 3, 3)).astype(np.float32)
    cl = accel.build_clusters(pos, k=64)
    jcl = jaccel.Clusters(aabb=cl.aabb, slots=cl.slots, order=cl.order,
                          k=cl.k)
    for i in range(3):
        moved = (pos * rng.uniform(0.5, 2.0)
                 + rng.normal(size=3).astype(np.float32)).astype(np.float32)
        got = accel.refit_clusters(cl, moved)
        want = jaccel.refit_clusters(jcl, moved)
        np.testing.assert_array_equal(got.aabb, want.aabb)
        np.testing.assert_array_equal(got.slots, cl.slots)
        np.testing.assert_array_equal(got.order, cl.order)
        rp = moved[cl.order]
        for c in range(cl.slots.shape[0]):
            v = rp[cl.slots[c][cl.slots[c] >= 0]].reshape(-1, 3)
            assert (v >= got.aabb[c, :3]).all() and (v <= got.aabb[c, 3:6]
                                                     ).all()


@pytest.mark.parametrize("builder", BUILDERS)
def test_scene_refit_keeps_k_and_topology_as_jax(builder, monkeypatch):
    """Config 5 with one model moved, built with refit=True twice: the
    port keeps K and the slots, and its boxes and tables equal the JAX
    scene's refit; a full build then clusters anew.  Both packages on
    either BVH builder (``use_builder``)."""
    use_builder(monkeypatch, builder)
    scene, camera, _ = CONFIGS[5](width=16, height=8)
    jscene, _, _ = JCONFIGS[5](width=16, height=8)
    first = scene.arrays()
    jscene.build()
    for i, offset in enumerate(((0.3, 0.1, 0.0), (0.9, -0.2, 0.4))):
        t = (1.4 + offset[0], offset[1], -2.8 + offset[2])
        scene.models[1].transform = transform_trs(t, (-0.4, 0.2 * i, 0))
        jscene.models[1].transform = jtrs(t, (-0.4, 0.2 * i, 0))
        got = scene.arrays(refit=True)
        want = jax_scene_arrays(jscene.build(refit=True))
        assert got["clusters.slots"].shape == first["clusters.slots"].shape
        np.testing.assert_array_equal(got["clusters.slots"],
                                      first["clusters.slots"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert scene._auto_k[1] == 64
    rebuilt = scene.arrays()
    want = jax_scene_arrays(jscene.build())
    np.testing.assert_array_equal(rebuilt["clusters.aabb"],
                                  want["clusters.aabb"])
    # a refit renders: the moved model in the image
    r = Renderer(RenderOptions(width=16, height=8, num_samples=1,
                               num_bounces=2), device="cpu")
    r.update_scene(scene, refit=True)
    assert r.render(camera).std() > 0


def test_tri_chunk_changes_no_result():
    """RenderOptions takes the JAX option tri_chunk, and no value of it
    changes a bit of the canvas (config 3's whole-trace plain version,
    whose dense loop sizes its own chunks)."""
    canvases = []
    for chunk in (13, 256):
        r, camera = _renderer(3, tri_chunk=chunk)
        r.step(camera, time=2)
        canvases.append(r.canvas.numpy())
    np.testing.assert_array_equal(canvases[1], canvases[0])
