"""The scene as the device sees it: padded structure-of-arrays tensors.

The counterpart of ``simple_raytracer_tpu.ops.scene_types.DeviceScene``,
as plain dataclasses of tensors instead of a pytree.  Each primitive
category is padded to a bucket capacity; ``active`` marks the real slots.

Triangles are world-space and, for a clustered mesh, already in BVH
order.  ``from_numpy`` packs the kernels' triangle tables once per scene
(``tri_table``, ``triangle.pack_triangles``), and for a clustered mesh
the BVH kernel's hierarchy of boxes (``ops/bvh.build_hierarchy``), so no
pass packs mesh tables again.  The environment texture, when the scene
has one, is uploaded as an f32 tensor.
``prim_tables`` packs the sphere, plane and material tables that the
whole-trace and per-bounce shade kernels read.

The sky parameters stay on the host as float32-rounded Python floats: the
CUDA kernel takes them by value, so moving them costs no copy.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .bvh import PACKET, VMEM_TABLE_MAX_SLOTS, Hierarchy, build_hierarchy
from .triangle import pack_triangles
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
class Clusters:
    """A BVH-clustered mesh: C clusters of K triangle slots each."""
    aabb: torch.Tensor       # (C, 8) f32 [min.xyz, max.xyz, 0, 0]; the
                             # padding clusters have every plane at 3e38
    slots: torch.Tensor      # (C, K) int64 triangle index, -1 = empty slot
    extent: float            # the largest |coordinate| of a real box: the
                             # whole-trace kernel scales its slab-test
                             # margin by it
    hierarchy: Hierarchy     # the BVH kernel's supers, groups, admission
                             # boxes and int32 slot indices
    # (C * 8, 8) f32 sub-boxes, 8 a cluster: box j bounds the triangles of
    # slots [j * K / 8, (j + 1) * K / 8), [lo, hi, 0, 0], an empty range
    # the sentinel box (3e38 in both corners); built only under
    # SRT_BVH_SUBBOX and for K % 64 == 0 (models/scene.sub_boxes), else
    # None
    sub_aabb: Optional[torch.Tensor] = None
    # the slot table's ops/bvh.plucker_table, built on first use (once per
    # scene) by ops/bvh.plucker_coefficients
    plucker: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    # the warp walks' MT rows of the slot table (ops/bvh.stage_slots),
    # built on the first MT launch of the BVH kernel or clustered launch
    # of the whole-trace kernel (once per scene) by ops/bvh.staged_slots
    staged: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def k(self) -> int:
        return self.slots.shape[1]


@dataclasses.dataclass(frozen=True)
class Triangles:
    v0: torch.Tensor         # (Nt, 3) f32 world-space vertices
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor         # (Nt, 3) f32 vertex normals (not normalized)
    n1: torch.Tensor
    n2: torch.Tensor
    material: torch.Tensor   # (Nt,) int64
    active: torch.Tensor     # (Nt,) bool
    # the kernels' rows of TRI_COLS f32: the Nt triangles in order, or for
    # a clustered mesh the C * K cluster slots (see tri_table)
    table: torch.Tensor
    # the Nt triangles' rows in order, whatever the mesh: ``table`` itself
    # without clusters; the routes that find a triangle's index (not its
    # slot) shade from it
    rows: torch.Tensor
    # the (16, Nt) table of the triangle kernel's plain version
    # (triangle.pack_triangles)
    packed: torch.Tensor
    clusters: Optional[Clusters] = None
    # the kernel's own layout of it, one 48-byte row per active triangle,
    # built on the kernel's first launch (triangle.staged_table)
    staged: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)


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
    triangles: Triangles
    materials: Materials
    sky: SkyParams
    # a hint only: False declares an enclosed scene (no ray reaches the
    # sky); results never depend on it
    sky_reachable: bool = True
    # the equirect environment texture, (H, W, 3) f32 with row 0 at the
    # bottom, or None for the gradient sky (ops/sky.sky_color)
    skybox: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.materials.color.device


MATERIAL_FIELDS = ("smoothness", "metallic", "specular", "emission_strength",
                   "transmittance", "refraction_index")
SKY_VECTORS = ("sun_color", "sun_direction", "horizon_color", "zenith_color",
               "ground_color")
TRI_VECTORS = ("v0", "v1", "v2", "n0", "n1", "n2")
# a kernel triangle row: [v0 (0-2), e1 = v1 - v0 (3-5), e2 = v2 - v0 (6-8),
# n0 n1 n2 (9-17), material (18), active (19)], the first 20 columns of
# the TPU kernel's tables (bounce_kernel.small_tris_table, table_t)
TRI_COLS = 20
# the largest cluster table (C * K slots) the whole-trace kernel serves; it
# also sets the scene build's choice of K (the TPU's VMEM_TABLE_MAX_SLOTS)
TABLE_MAX_SLOTS = VMEM_TABLE_MAX_SLOTS
# meshes of at most this many triangles (padded) and no clusters take the
# whole-trace kernel's dense in-kernel loop (bounce_kernel.SMALL_TRIS_MAX)
SMALL_TRIS_MAX = 64
# under tri_backend="fused" the whole-trace kernel also serves a table of
# at most this many single-packet clusters (K <= PACKET), which the TPU
# keeps resident in its packed form (bounce_kernel.py:119
# MEGA_PACKED_MAX_CLUSTERS, the rule of ops/trace.py:283-293), read from
# SRT_MEGA_PACKED_MAX once, at import, as the JAX module reads it
MEGA_PACKED_MAX_CLUSTERS = int(os.environ.get("SRT_MEGA_PACKED_MAX", "853"))


def whole_trace_variant(scene: DeviceScene,
                        tri_backend: str = "auto") -> Optional[str]:
    """The whole-trace kernel's triangle variant for a scene, as the TPU's
    whole-trace rule (ops/trace.py ``mega_tris``): "none", "small" (at
    most SMALL_TRIS_MAX triangles, no clusters) or "clustered" (at most
    TABLE_MAX_SLOTS cluster slots, or under ``tri_backend="fused"`` at
    most MEGA_PACKED_MAX_CLUSTERS clusters of at most PACKET slots: the
    TPU's packed table, which the card reads from global memory like any
    other); None for any other mesh, which takes the per-bounce path."""
    tris = scene.triangles
    n = tris.material.shape[0]
    cl = tris.clusters
    if cl is None:
        return "none" if n == 0 else "small" if n <= SMALL_TRIS_MAX else None
    if cl.slots.numel() <= TABLE_MAX_SLOTS:
        return "clustered"
    if (tri_backend == "fused" and cl.k <= PACKET
            and cl.slots.shape[0] <= MEGA_PACKED_MAX_CLUSTERS):
        return "clustered"
    return None


def tri_table(tris: dict, slots: Optional[np.ndarray] = None) -> np.ndarray:
    """The kernel's (rows, TRI_COLS) f32 triangle table: one row per
    triangle, or with ``slots`` ((C, K), -1 empty) one row per cluster
    slot, empty slots all zero (inactive).  The edges are the same f32
    subtractions the plain version makes."""
    v0, v1, v2 = tris["v0"], tris["v1"], tris["v2"]
    rows = np.concatenate(
        [v0, v1 - v0, v2 - v0, tris["n0"], tris["n1"], tris["n2"],
         tris["material"].astype(np.float32)[:, None],
         tris["active"].astype(np.float32)[:, None]], axis=1)
    if slots is None:
        return rows
    flat = slots.reshape(-1)
    out = np.zeros((flat.shape[0], TRI_COLS), np.float32)
    out[flat >= 0] = rows[flat[flat >= 0]]
    return out


def prim_tables(scene: DeviceScene):
    """The kernels' f32 tables: spheres (Ns, 8) [center, radius, material,
    active, 0, 0], planes (Np, 8) [position, normal, material, active],
    materials (M, 16) [smoothness, metallic, specular, emission_strength,
    transmittance, ior, color, emission, 0 x4] (bounce_kernel.prim_tables,
    without its padding to 8 rows)."""
    sp, pl, m = scene.spheres, scene.planes, scene.materials
    f = lambda t: t.to(torch.float32)
    sph = torch.cat([sp.center, sp.radius[:, None], f(sp.material)[:, None],
                     f(sp.active)[:, None],
                     torch.zeros_like(sp.center[:, :2])], dim=1)
    pln = torch.cat([pl.position, pl.normal, f(pl.material)[:, None],
                     f(pl.active)[:, None]], dim=1)
    mat = torch.cat([torch.stack([m.smoothness, m.metallic, m.specular,
                                  m.emission_strength, m.transmittance,
                                  m.refraction_index], dim=1),
                     m.color, m.emission,
                     torch.zeros_like(m.color[:, :1]).expand(-1, 4)], dim=1)
    return sph.contiguous(), pln.contiguous(), mat.contiguous()


def from_numpy(arrays: dict, device) -> DeviceScene:
    """Build a DeviceScene from flat numpy arrays named as the JAX
    DeviceScene's fields: ``spheres.center`` (Ns, 3), ``spheres.radius``,
    ``spheres.material``, ``spheres.active``, ``planes.position``,
    ``planes.normal``, ``planes.material``, ``planes.active``,
    ``materials.<field>`` (color and emission (M, 3)), ``sky.<field>``
    (vectors (3,)) and ``sky_reachable``; optionally the triangles
    ``triangles.{v0,v1,v2,n0,n1,n2}`` (Nt, 3), ``triangles.material``,
    ``triangles.active``, and for a clustered mesh ``clusters.aabb``
    (C, 8) and ``clusters.slots`` (C, K) (-1 for an empty slot), and
    optionally ``clusters.sub_aabb`` (C * 8, 8) (absent or None: no
    sub-box table).  A scene
    without ``triangles.v0`` has no triangles.  ``skybox``, when present
    and not None, is the (H, W, 3) environment texture: an array, or a
    tensor already on ``device`` (kept as it is)."""

    def f32(name, shape_tail=()):
        a = np.asarray(arrays[name], np.float32)
        if a.shape[1:] != shape_tail:
            raise ValueError(f"{name}: shape {a.shape}, want (N, *{shape_tail})")
        return torch.tensor(a, device=device)

    n_mat = np.asarray(arrays["materials.smoothness"]).shape[0]

    def t(a):
        return torch.tensor(a, device=device)

    def checked_index(name):
        # the kernel reads materials unchecked, so bad indices stop here
        a = np.asarray(arrays[name], np.int64)
        if a.size and (a.min() < 0 or a.max() >= n_mat):
            raise ValueError(f"{name}: material index outside [0, {n_mat})")
        return a

    def index(name):
        return t(checked_index(name))

    def flag(name):
        return torch.tensor(np.asarray(arrays[name], bool), device=device)

    def scalar(name):
        return float(np.float32(arrays[name]))

    def vec(name):
        return Vec3.full(tuple(np.asarray(arrays[name], np.float32).reshape(3)))

    if "triangles.v0" in arrays:
        tris = {k: np.asarray(arrays[f"triangles.{k}"], np.float32)
                for k in TRI_VECTORS}
        for k, a in tris.items():
            if a.shape[1:] != (3,):
                raise ValueError(f"triangles.{k}: shape {a.shape}")
        tris["material"] = checked_index("triangles.material")
        tris["active"] = np.asarray(arrays["triangles.active"], bool)
    else:
        tris = {k: np.zeros((0, 3), np.float32) for k in TRI_VECTORS}
        tris["material"] = np.zeros((0,), np.int64)
        tris["active"] = np.zeros((0,), bool)
    n_tris = tris["v0"].shape[0]
    clusters, slots = None, None
    if "clusters.aabb" in arrays:
        aabb = np.asarray(arrays["clusters.aabb"], np.float32)
        slots = np.asarray(arrays["clusters.slots"], np.int64)
        if (slots.ndim != 2 or aabb.shape != (slots.shape[0], 8)
                or slots.min() < -1 or slots.max() >= n_tris):
            raise ValueError(f"clusters: aabb {aabb.shape}, slots "
                             f"{slots.shape} over {n_tris} triangles")
        real = aabb[:, 0] < 1.0e38
        extent = float(np.abs(aabb[real, 0:6]).max()) if real.any() else 0.0
        aabb_t, slots_t = t(aabb), t(slots)
        sub = arrays.get("clusters.sub_aabb")
        if sub is not None:
            sub = np.asarray(sub, np.float32)
            if sub.shape != (slots.shape[0] * 8, 8):
                raise ValueError(f"clusters.sub_aabb: shape {sub.shape} for "
                                 f"{slots.shape[0]} clusters")
            sub = t(sub)
        clusters = Clusters(aabb=aabb_t, slots=slots_t,
                            extent=extent,
                            hierarchy=build_hierarchy(aabb_t, slots_t),
                            sub_aabb=sub)
    table = t(tri_table(tris, slots))
    triangles = Triangles(
        **{k: t(tris[k]) for k in TRI_VECTORS + ("material", "active")},
        table=table, rows=table if slots is None else t(tri_table(tris)),
        packed=t(pack_triangles(tris["v0"], tris["v1"], tris["v2"],
                                tris["active"])),
        clusters=clusters)

    return DeviceScene(
        spheres=Spheres(center=f32("spheres.center", (3,)),
                        radius=f32("spheres.radius"),
                        material=index("spheres.material"),
                        active=flag("spheres.active")),
        planes=Planes(position=f32("planes.position", (3,)),
                      normal=f32("planes.normal", (3,)),
                      material=index("planes.material"),
                      active=flag("planes.active")),
        triangles=triangles,
        materials=Materials(
            **{k: f32(f"materials.{k}") for k in MATERIAL_FIELDS},
            color=f32("materials.color", (3,)),
            emission=f32("materials.emission", (3,))),
        sky=SkyParams(sun_focus=scalar("sky.sun_focus"),
                      sun_intensity=scalar("sky.sun_intensity"),
                      **{k: vec(f"sky.{k}") for k in SKY_VECTORS}),
        sky_reachable=bool(arrays.get("sky_reachable", True)),
        skybox=_skybox(arrays.get("skybox"), device),
    )


def _skybox(image, device) -> Optional[torch.Tensor]:
    """The texture as an (H, W, 3) f32 tensor on ``device``, or None; an
    array is copied, a tensor moved only where it is elsewhere."""
    if image is None:
        return None
    if not isinstance(image, torch.Tensor):
        image = torch.tensor(np.asarray(image, np.float32))
    tex = image.to(device=device, dtype=torch.float32).contiguous()
    if tex.ndim != 3 or tex.shape[2] != 3 or tex.shape[0] * tex.shape[1] == 0:
        raise ValueError(f"skybox: shape {tuple(tex.shape)}, want (H, W, 3)")
    return tex
