"""The preset scenes of this slice: configs 1 and 2.

Copies of ``config1_red_green`` and ``config2_four_spheres`` from
``simple_raytracer_tpu.models.presets``.  Each builder returns
``(scene, camera, options)``.  The mesh and skybox configs (3 to 7) are
later slices.
"""
from __future__ import annotations

from ..engine import RenderOptions
from .camera import Camera
from .materials import Material
from .scene import Scene


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


CONFIGS = {
    1: config1_red_green,
    2: config2_four_spheres,
}
