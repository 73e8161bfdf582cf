"""Editable host scene and its build into the device scene.

The counterpart of ``simple_raytracer_tpu.models.scene``: the same
primitive lists, materials and sky settings, and a ``build`` that pads
each category to the same power-of-two buckets with inactive slots, so
both packages hand their renderers identical arrays.  This port renders
spheres and planes under the gradient sky; meshes and texture skyboxes
are later slices and raise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..ops.scene_types import (MATERIAL_FIELDS, SKY_VECTORS, DeviceScene,
                               from_numpy)
from .materials import Material, MaterialSet, from_hex
from .shapes import Plane, Sphere

_MESHES = "mesh scenes: a later slice"


def _bucket(n: int, minimum: int = 4) -> int:
    """Smallest power of two >= max(n, minimum); 0 stays 0, so an empty
    category has zero-capacity arrays."""
    if n == 0:
        return 0
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


@dataclasses.dataclass
class SkySettings:
    """Defaults mirror the reference application's environment."""
    sun_focus: float = 25.0
    sun_intensity: float = 1.0
    sun_color: Tuple[float, float, float] = from_hex(0xFFFFD3)
    sun_direction: Tuple[float, float, float] = (
        0.7071067811865475, -0.7071067811865475, 0.0)  # normalize(1,-1,0)
    horizon_color: Tuple[float, float, float] = from_hex(0x374F62)
    zenith_color: Tuple[float, float, float] = from_hex(0x11334A)
    ground_color: Tuple[float, float, float] = from_hex(0x777777)


class Scene:
    """Mutable scene: primitive lists, materials and sky settings."""

    def __init__(self, default_material: bool = True):
        self.spheres: List[Sphere] = []
        self.planes: List[Plane] = []
        self.materials = MaterialSet()
        self.sky = SkySettings()
        self.skybox: Optional[np.ndarray] = None
        # a hint: False declares the scene enclosed (no ray reaches the
        # sky); results never depend on it
        self.sky_reachable: bool = True
        if default_material:
            self.materials.push(Material(), "Material0")

    def add_sphere(self, position, radius, material: int = 0) -> Sphere:
        s = Sphere(material=material, position=tuple(position),
                   radius=float(radius))
        self.spheres.append(s)
        return s

    def add_plane(self, position, normal, material: int = 0) -> Plane:
        p = Plane(material=material, position=tuple(position),
                  normal=tuple(normal))
        self.planes.append(p)
        return p

    def add_material(self, material: Material,
                     name: Optional[str] = None) -> int:
        return self.materials.push(material, name)

    def add_model(self, *args, **kwargs):
        raise NotImplementedError(_MESHES)

    def add_box(self, *args, **kwargs):
        raise NotImplementedError(_MESHES)

    def import_model(self, *args, **kwargs):
        raise NotImplementedError(_MESHES)

    def arrays(self) -> dict:
        """The padded scene as flat numpy arrays (``from_numpy`` names)."""
        if self.skybox is not None:
            raise NotImplementedError("texture skybox: a later slice")
        out = {}
        n = len(self.spheres)
        cap = _bucket(n)
        out["spheres.center"] = np.zeros((cap, 3), np.float32)
        out["spheres.radius"] = np.ones((cap,), np.float32)
        out["spheres.material"] = np.zeros((cap,), np.int32)
        out["spheres.active"] = np.arange(cap) < n
        for i, s in enumerate(self.spheres):
            out["spheres.center"][i] = s.position
            out["spheres.radius"][i] = s.radius
            out["spheres.material"][i] = s.material

        n = len(self.planes)
        cap = _bucket(n)
        out["planes.position"] = np.zeros((cap, 3), np.float32)
        out["planes.normal"] = np.zeros((cap, 3), np.float32)
        out["planes.normal"][:, 1] = 1.0
        out["planes.material"] = np.zeros((cap,), np.int32)
        out["planes.active"] = np.arange(cap) < n
        for i, p in enumerate(self.planes):
            out["planes.position"][i] = p.position
            out["planes.normal"][i] = p.normal
            out["planes.material"][i] = p.material

        mats = self.materials.materials or [Material()]
        pad = _bucket(len(mats)) - len(mats)
        fill = {"refraction_index": 1.0}
        for k in MATERIAL_FIELDS:
            out[f"materials.{k}"] = np.array(
                [getattr(m, k) for m in mats] + [fill.get(k, 0.0)] * pad,
                np.float32)
        for k in ("color", "emission"):
            out[f"materials.{k}"] = np.array(
                [getattr(m, k) for m in mats] + [(0, 0, 0)] * pad, np.float32)

        out["sky.sun_focus"] = np.float32(self.sky.sun_focus)
        out["sky.sun_intensity"] = np.float32(self.sky.sun_intensity)
        for k in SKY_VECTORS:
            out[f"sky.{k}"] = np.asarray(getattr(self.sky, k), np.float32)
        out["sky_reachable"] = self.sky_reachable
        return out

    def build(self, device) -> DeviceScene:
        """The device scene on ``device``."""
        return from_numpy(self.arrays(), device)
