"""The scene as the device sees it: padded structure-of-arrays tensors.

The counterpart of ``simple_raytracer_tpu.ops.scene_types.DeviceScene``,
as plain dataclasses of tensors instead of a pytree.  Each primitive
category is padded to a bucket capacity; ``active`` marks the real slots.
Triangles are an empty category in this port for now: ``from_numpy``
refuses a scene that has any.

The sky parameters stay on the host as float32-rounded Python floats: the
CUDA kernel takes them by value, so moving them costs no copy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .vec import Vec3


@dataclasses.dataclass(frozen=True)
class Spheres:
    center: torch.Tensor     # (Ns, 3) f32
    radius: torch.Tensor     # (Ns,) f32
    material: torch.Tensor   # (Ns,) int64
    active: torch.Tensor     # (Ns,) bool


@dataclasses.dataclass(frozen=True)
class Planes:
    position: torch.Tensor   # (Np, 3) f32
    normal: torch.Tensor     # (Np, 3) f32
    material: torch.Tensor   # (Np,) int64
    active: torch.Tensor     # (Np,) bool


@dataclasses.dataclass(frozen=True)
class Materials:
    smoothness: torch.Tensor        # (M,) f32, and so on for each scalar
    metallic: torch.Tensor
    specular: torch.Tensor
    emission_strength: torch.Tensor
    transmittance: torch.Tensor
    refraction_index: torch.Tensor
    color: torch.Tensor             # (M, 3) f32
    emission: torch.Tensor          # (M, 3) f32


@dataclasses.dataclass(frozen=True)
class SkyParams:
    """The gradient environment: float32-rounded host scalars."""
    sun_focus: float
    sun_intensity: float
    sun_color: Vec3
    sun_direction: Vec3
    horizon_color: Vec3
    zenith_color: Vec3
    ground_color: Vec3


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    spheres: Spheres
    planes: Planes
    materials: Materials
    sky: SkyParams
    # a hint only: False declares an enclosed scene (no ray reaches the
    # sky); results never depend on it
    sky_reachable: bool = True

    @property
    def device(self) -> torch.device:
        return self.materials.color.device


MATERIAL_FIELDS = ("smoothness", "metallic", "specular", "emission_strength",
                   "transmittance", "refraction_index")
SKY_VECTORS = ("sun_color", "sun_direction", "horizon_color", "zenith_color",
               "ground_color")


def from_numpy(arrays: dict, device) -> DeviceScene:
    """Build a DeviceScene from flat numpy arrays named as the JAX
    DeviceScene's fields: ``spheres.center`` (Ns, 3), ``spheres.radius``,
    ``spheres.material``, ``spheres.active``, ``planes.position``,
    ``planes.normal``, ``planes.material``, ``planes.active``,
    ``materials.<field>`` (color and emission (M, 3)), ``sky.<field>``
    (vectors (3,)) and ``sky_reachable``.  A ``triangles.material`` array,
    if present, must be empty."""
    tris = arrays.get("triangles.material")
    if tris is not None and np.asarray(tris).shape[0]:
        raise NotImplementedError("mesh scenes: a later slice")

    def f32(name, shape_tail=()):
        a = np.asarray(arrays[name], np.float32)
        if a.shape[1:] != shape_tail:
            raise ValueError(f"{name}: shape {a.shape}, want (N, *{shape_tail})")
        return torch.tensor(a, device=device)

    n_mat = np.asarray(arrays["materials.smoothness"]).shape[0]

    def index(name):
        # the kernel reads materials unchecked, so bad indices stop here
        a = np.asarray(arrays[name], np.int64)
        if a.size and (a.min() < 0 or a.max() >= n_mat):
            raise ValueError(f"{name}: material index outside [0, {n_mat})")
        return torch.tensor(a, device=device)

    def flag(name):
        return torch.tensor(np.asarray(arrays[name], bool), device=device)

    def scalar(name):
        return float(np.float32(arrays[name]))

    def vec(name):
        return Vec3.full(tuple(np.asarray(arrays[name], np.float32).reshape(3)))

    return DeviceScene(
        spheres=Spheres(center=f32("spheres.center", (3,)),
                        radius=f32("spheres.radius"),
                        material=index("spheres.material"),
                        active=flag("spheres.active")),
        planes=Planes(position=f32("planes.position", (3,)),
                      normal=f32("planes.normal", (3,)),
                      material=index("planes.material"),
                      active=flag("planes.active")),
        materials=Materials(
            **{k: f32(f"materials.{k}") for k in MATERIAL_FIELDS},
            color=f32("materials.color", (3,)),
            emission=f32("materials.emission", (3,))),
        sky=SkyParams(sun_focus=scalar("sky.sun_focus"),
                      sun_intensity=scalar("sky.sun_intensity"),
                      **{k: vec(f"sky.{k}") for k in SKY_VECTORS}),
        sky_reachable=bool(arrays.get("sky_reachable", True)),
    )
