"""The preset scenes of the port: configs 1 to 7.

Copies of ``config1_red_green`` to ``config7_mega_mesh`` from
``simple_raytracer_tpu.models.presets``.  Each builder returns
``(scene, camera, options)``.  The mesh configs use the procedural
``organic_blob``, or the STL or OBJ file ``mesh_path`` (configs 4 to 7).
Config 3 lights with the reference's skybox texture where it is found.
"""
from __future__ import annotations

import math
import os
from typing import Optional

from ..engine import RenderOptions
from ..io.image import load_skybox
from .camera import Camera
from .materials import Material
from .meshgen import organic_blob
from .scene import Scene, load_mesh
from .shapes import transform_trs


def _cornell_base(scene: Scene) -> None:
    """Red/green wall box out of planes, white floor/ceiling/back."""
    white = 0  # default Material0
    red = scene.add_material(Material(color=(0.9, 0.1, 0.1)), "Red")
    green = scene.add_material(Material(color=(0.1, 0.9, 0.1)), "Green")
    scene.add_plane((0, -2, 0), (0, 1, 0), material=white)     # floor
    scene.add_plane((0, 4, 0), (0, -1, 0), material=white)     # ceiling
    scene.add_plane((0, 0, -6), (0, 0, 1), material=white)     # back
    scene.add_plane((-4, 0, 0), (1, 0, 0), material=red)       # left
    scene.add_plane((4, 0, 0), (-1, 0, 0), material=green)     # right


def config1_red_green(width: int = 512, height: int = 512) -> tuple:
    """Red/green walls + one diffuse sphere, direct lighting."""
    scene = Scene()
    _cornell_base(scene)
    # the five infinite planes enclose every ray direction (only the
    # measure-zero exact +z axis escapes): declare the sky unreachable so
    # the megakernel skips its per-block early-exit check (result-neutral
    # perf hint, ops.scene_types.SceneFlags)
    scene.sky_reachable = False
    scene.add_sphere((0, -1, -2), 1.0, material=0)
    light = scene.add_material(
        Material(emission=(1, 1, 1), emission_strength=4.0), "Light")
    scene.add_sphere((0, 3.0, -2), 1.0, material=light)
    camera = Camera(position=(0.0, 0.0, 5.0))
    options = RenderOptions(width=width, height=height, num_samples=2,
                            num_bounces=2)
    return scene, camera, options


def config2_four_spheres(width: int = 960, height: int = 540) -> tuple:
    """Metallic / specular / refractive / emissive spheres, 4-bounce."""
    scene = Scene()
    scene.add_plane((0, -1, 0), (0, 1, 0), material=0)  # ground
    metal = scene.add_material(
        Material(color=(0.9, 0.6, 0.2), smoothness=0.9, metallic=1.0), "Metal")
    mirror = scene.add_material(
        Material(color=(1, 1, 1), smoothness=1.0, specular=1.0), "Mirror")
    glass = scene.add_material(
        Material(color=(1, 1, 1), smoothness=1.0, transmittance=1.0,
                 refraction_index=1.5), "Glass")
    lamp = scene.add_material(
        Material(emission=(1.0, 0.9, 0.7), emission_strength=8.0), "Lamp")
    scene.add_sphere((-3.1, 0, -2), 1.0, material=metal)
    scene.add_sphere((-1.05, 0, -2), 1.0, material=mirror)
    scene.add_sphere((1.05, 0, -2), 1.0, material=glass)
    scene.add_sphere((3.1, 0, -2), 1.0, material=lamp)
    camera = Camera(position=(0.0, 0.5, 5.0))
    options = RenderOptions(width=width, height=height, num_samples=2,
                            num_bounces=4)
    return scene, camera, options


# where the JAX package looks for the reference application's skybox
# texture when SRT_REFERENCE_SKYBOX is unset (models/showcase.py:
# REFERENCE_SKYBOX); it is not part of this repository
REFERENCE_SKYBOX = os.path.join(os.sep, "root", "reference", "assets",
                                "skybox.png")


def reference_skybox_path() -> Optional[str]:
    """The reference skybox texture config 3's "auto" would load, as the
    JAX package finds it (``load_reference_skybox``), or None."""
    path = os.environ.get("SRT_REFERENCE_SKYBOX", REFERENCE_SKYBOX)
    return path if os.path.exists(path) else None


def config3_skybox_emissive(width: int = 960, height: int = 540,
                            skybox="auto") -> tuple:
    """Environment lighting + an emissive area light, 8-bounce.

    With ``skybox="auto"`` the reference's skybox texture is loaded
    (``io/image.load_skybox``) when it is found
    (``reference_skybox_path``), as the JAX package does, else the
    analytic gradient sky stands in.  ``"gradient"`` (or None) always
    gives the gradient sky, the form the golden tests use; an (H, W, 3)
    array is the texture itself."""
    scene = Scene()
    if isinstance(skybox, str):
        if skybox not in ("auto", "gradient"):
            raise ValueError(f"unknown skybox mode {skybox!r}")
        found = reference_skybox_path() if skybox == "auto" else None
        skybox = load_skybox(found) if found is not None else None
    if skybox is not None:
        scene.skybox = skybox
    scene.add_plane((0, -1, 0), (0, 1, 0), material=0)
    area = scene.add_material(
        Material(color=(1, 1, 1), emission=(1.0, 0.95, 0.8),
                 emission_strength=12.0), "Area")
    glossy = scene.add_material(
        Material(color=(0.3, 0.4, 0.9), smoothness=0.7, metallic=0.4),
        "Glossy")
    scene.add_box((0, 2.8, -3), size=(3.0, 0.2, 3.0), material=area)
    scene.add_sphere((0, 0, -3), 1.0, material=glossy)
    scene.add_sphere((-2.4, -0.4, -2.2), 0.6, material=0)
    camera = Camera(position=(0.0, 0.5, 3.0))
    options = RenderOptions(width=width, height=height, num_samples=2,
                            num_bounces=8)
    return scene, camera, options


def _add_mesh(scene: Scene, path: Optional[str], subdivisions: int = 3):
    """The mesh file ``path`` (``scene.load_mesh``: STL or OBJ) into the
    pool, or the procedural stand-in mesh (1280 triangles at subdivision
    3); returns its span."""
    if path is not None:
        return load_mesh(path, scene.pool)
    pos, nrm = organic_blob(subdivisions=subdivisions)
    return scene.pool.append(pos, nrm)


def config4_mesh_glass(width: int = 960, height: int = 540,
                       mesh_path: Optional[str] = None) -> tuple:
    """One glass mesh on a ground plane."""
    scene = Scene()
    scene.add_plane((0, -1.2, 0), (0, 1, 0), material=0)
    glass = scene.add_material(
        Material(color=(0.9, 0.95, 1.0), smoothness=1.0, transmittance=1.0,
                 refraction_index=1.5), "Glass")
    span = _add_mesh(scene, mesh_path)
    scene.add_model(span, material=glass,
                    transform=transform_trs((0, 0, -2.5)))
    camera = Camera(position=(0.0, 0.3, 2.5))
    options = RenderOptions(width=width, height=height, num_samples=2,
                            num_bounces=6)
    return scene, camera, options


def config5_two_meshes(width: int = 960, height: int = 540,
                       mesh_path: Optional[str] = None) -> tuple:
    """Two instances of one mesh (refractive + metallic)."""
    scene = Scene()
    scene.add_plane((0, -1.2, 0), (0, 1, 0), material=0)
    glass = scene.add_material(
        Material(color=(0.9, 0.95, 1.0), smoothness=1.0, transmittance=1.0,
                 refraction_index=1.5), "Glass")
    metal = scene.add_material(
        Material(color=(0.9, 0.7, 0.3), smoothness=0.85, metallic=1.0),
        "Metal")
    span = _add_mesh(scene, mesh_path)
    scene.add_model(span, material=glass,
                    transform=transform_trs((-1.4, 0, -2.8),
                                            (math.pi / 8, 0, 0)))
    scene.add_model(span, material=metal,
                    transform=transform_trs((1.4, 0, -2.8),
                                            (-math.pi / 8, 0, 0)))
    camera = Camera(position=(0.0, 0.3, 2.5))
    options = RenderOptions(width=width, height=height, num_samples=2,
                            num_bounces=6)
    return scene, camera, options


def config6_large_mesh(width: int = 960, height: int = 540,
                       mesh_path: Optional[str] = None,
                       subdivisions: int = 6) -> tuple:
    """Large-mesh stress config: one 81,920-triangle organic sculpt on a
    ground plane, beyond the whole-trace kernel's table: it renders
    through the split per-bounce path and the BVH kernel."""
    scene = Scene()
    scene.add_plane((0, -1.2, 0), (0, 1, 0), material=0)
    m = scene.add_material(
        Material(color=(0.8, 0.7, 0.6), smoothness=0.3), "Clay")
    span = _add_mesh(scene, mesh_path, subdivisions=subdivisions)
    scene.add_model(span, material=m,
                    transform=transform_trs((0, 0, -2.5)))
    camera = Camera(position=(0.0, 0.3, 2.5))
    options = RenderOptions(width=width, height=height, num_samples=2,
                            num_bounces=6)
    return scene, camera, options


def config7_mega_mesh(width: int = 960, height: int = 540,
                      mesh_path: Optional[str] = None,
                      subdivisions: int = 8) -> tuple:
    """Production-asset stress config: one 1,310,720-triangle organic
    sculpt (``organic_blob(subdivisions=8)``) on a ground plane, 11,008
    clusters of 128 slots: a table the TPU streams from HBM
    (``_kernel_hbm``); here the BVH kernel's ``streamed`` variant.
    ``subdivisions`` scales it down for tests."""
    scene = Scene()
    scene.add_plane((0, -1.2, 0), (0, 1, 0), material=0)
    m = scene.add_material(
        Material(color=(0.8, 0.7, 0.6), smoothness=0.3), "Clay")
    span = _add_mesh(scene, mesh_path, subdivisions=subdivisions)
    scene.add_model(span, material=m,
                    transform=transform_trs((0, 0, -2.5)))
    camera = Camera(position=(0.0, 0.3, 2.5))
    options = RenderOptions(width=width, height=height, num_samples=2,
                            num_bounces=6)
    return scene, camera, options


CONFIGS = {
    1: config1_red_green,
    2: config2_four_spheres,
    3: config3_skybox_emissive,
    4: config4_mesh_glass,
    5: config5_two_meshes,
    6: config6_large_mesh,
    7: config7_mega_mesh,
}
