"""Reconstructions of the reference's three showcase scenes.

Copies of the builders of ``simple_raytracer_tpu.models.showcase``, with
the port's ``RenderOptions``: the reference README's three renders
(red_green, spheres, model), rebuilt from the images (the reference saves
no scenes).  The spheres and model scenes light with the reference's
skybox texture where it is found (``load_reference_skybox``), else with
the gradient sky.  The model scene's mesh is the procedural organic
sculpt unless ``mesh_path`` names an STL or OBJ file.

Each builder returns (scene, camera, options) at the reference's 960x540,
2 samples, 10 bounces.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..engine import RenderOptions
from ..io.image import load_skybox
from .camera import Camera
from .materials import Material
from .meshgen import organic_blob
from .presets import reference_skybox_path
from .scene import Scene, load_mesh
from .shapes import transform_trs


def load_reference_skybox() -> Optional[np.ndarray]:
    """The reference's skybox (``SRT_REFERENCE_SKYBOX``, else the
    reference checkout's ``assets/skybox.png``) through ``load_skybox``, or
    None when the file is absent: the scene then keeps the gradient sky."""
    path = reference_skybox_path()
    return None if path is None else load_skybox(path)


def _options(**kw) -> RenderOptions:
    defaults = dict(width=960, height=540, num_samples=2, num_bounces=10)
    defaults.update(kw)
    return RenderOptions(**defaults)


def showcase_red_green() -> tuple:
    """readme/red_green.png: a closed white room with a red left wall and
    green right wall, a rectangular ceiling light, two clear spheres (one
    specular, one refractive with its floor caustic) and a large silver
    metallic sphere."""
    sc = Scene()
    white = 0
    red = sc.add_material(Material(color=(0.78, 0.05, 0.04)), "Red")
    green = sc.add_material(Material(color=(0.06, 0.62, 0.04)), "Green")
    light = sc.add_material(
        Material(color=(1, 1, 1), emission=(1.0, 1.0, 1.0),
                 emission_strength=5.0), "Light")
    mirror = sc.add_material(
        Material(color=(1, 1, 1), smoothness=1.0, specular=1.0), "Mirror")
    glass = sc.add_material(
        Material(color=(1, 1, 1), smoothness=1.0, transmittance=1.0,
                 refraction_index=1.5), "Glass")
    silver = sc.add_material(
        Material(color=(0.92, 0.9, 0.85), smoothness=0.92, metallic=1.0),
        "Silver")

    sc.add_plane((0, -2, 0), (0, 1, 0), material=white)    # floor
    sc.add_plane((0, 2.6, 0), (0, -1, 0), material=white)  # ceiling
    sc.add_plane((0, 0, -6), (0, 0, 1), material=white)    # back
    sc.add_plane((0, 0, 5.5), (0, 0, -1), material=white)  # behind camera
    sc.add_plane((-3.6, 0, 0), (1, 0, 0), material=red)    # left
    sc.add_plane((3.6, 0, 0), (-1, 0, 0), material=green)  # right
    # ceiling light panel (an emissive box flush with the ceiling)
    sc.add_box((0, 2.62, -2.6), size=(2.6, 0.15, 2.2), material=light)

    sc.add_sphere((-0.35, 0.35, -3.2), 0.85, material=mirror)
    sc.add_sphere((-0.45, -1.15, -2.7), 0.85, material=glass)
    sc.add_sphere((1.55, -1.0, -3.4), 1.0, material=silver)

    camera = Camera(position=(0.0, 0.2, 5.0))
    return sc, camera, _options()


def showcase_spheres() -> tuple:
    """readme/spheres.png: pastel red/green corner walls on a blue-grey
    floor, lit by the skybox; a large pale diffuse sphere, a glass sphere,
    a blue metallic sphere mirroring the clouds, and a small emissive red
    sphere."""
    sc = Scene()
    sc.skybox = load_reference_skybox()
    floor = sc.add_material(Material(color=(0.55, 0.65, 0.85)), "Floor")
    pinkw = sc.add_material(Material(color=(0.92, 0.55, 0.55)), "PinkWall")
    greenw = sc.add_material(Material(color=(0.6, 0.92, 0.55)), "GreenWall")
    pale = sc.add_material(Material(color=(0.75, 0.85, 0.95)), "Pale")
    glass = sc.add_material(
        Material(color=(1, 1, 1), smoothness=1.0, transmittance=1.0,
                 refraction_index=1.5), "Glass")
    bluemetal = sc.add_material(
        Material(color=(0.15, 0.25, 0.85), smoothness=0.97, metallic=1.0),
        "BlueMetal")
    redglow = sc.add_material(
        Material(color=(1.0, 0.3, 0.3), emission=(1.0, 0.25, 0.2),
                 emission_strength=3.0), "RedGlow")

    sc.add_plane((0, -1, 0), (0, 1, 0), material=floor)
    # two vertical walls meeting in a corner behind the spheres
    sc.add_plane((0, 0, -9), (0.45, 0, 1), material=pinkw)
    sc.add_plane((8, 0, 0), (-1, 0, 0.35), material=greenw)

    sc.add_sphere((-2.7, 0.4, -4.6), 1.7, material=pale)
    sc.add_sphere((0.3, 1.0, -4.9), 1.1, material=glass)
    sc.add_sphere((2.4, 0.45, -5.1), 1.35, material=bluemetal)
    sc.add_sphere((0.55, -0.6, -3.6), 0.42, material=redglow)

    camera = Camera(position=(0.0, 0.9, 0.0))
    return sc, camera, _options()


def showcase_model(mesh_path: Optional[str] = None,
                   subdivisions: int = 3) -> tuple:
    """readme/model.png: a clear specular mesh looking at a green
    refractive mesh on a blue-grey floor under the cloud skybox.  Suzanne
    in the reference; the procedural organic sculpt (meshgen.organic_blob)
    stands in unless mesh_path points at an STL/OBJ."""
    sc = Scene()
    sc.skybox = load_reference_skybox()
    floor = sc.add_material(Material(color=(0.5, 0.62, 0.8)), "Floor")
    clear = sc.add_material(
        Material(color=(0.95, 0.97, 1.0), smoothness=1.0, specular=0.85),
        "Clear")
    greenglass = sc.add_material(
        Material(color=(0.45, 0.95, 0.5), smoothness=1.0,
                 transmittance=1.0, refraction_index=1.45), "GreenGlass")

    if mesh_path is not None:
        span = load_mesh(mesh_path, sc.pool)
    else:
        pos, nrm = organic_blob(subdivisions=subdivisions)
        span = sc.pool.append(pos, nrm)

    sc.add_plane((0, -1.1, 0), (0, 1, 0), material=floor)
    sc.add_model(span, material=clear,
                 transform=transform_trs((-1.3, 0, -3.4), (0.5, 0, 0)))
    sc.add_model(span, material=greenglass,
                 transform=transform_trs((1.3, 0, -3.4), (-0.4, 0, 0)))

    camera = Camera(position=(0.0, 0.4, 0.6))
    return sc, camera, _options()


SHOWCASES = {
    "red_green": showcase_red_green,
    "spheres": showcase_spheres,
    "model": showcase_model,
}
