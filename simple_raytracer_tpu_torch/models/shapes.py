"""Host-side shape model: primitives, shared triangle pool, mesh instancing.

Mirrors the reference scene model (include/shape.hpp, src/shape.cpp):
  - ``Shape`` tagged union -> separate typed dataclasses here (the device
    layout is per-type SoA anyway, so the union disappears)
  - ``Triangle`` = 3 x {normal, pos} vertices (shape.hpp:29-44)
  - ``Model`` = [triangle_index, triangle_index + num_triangles) span into a
    SHARED triangle pool + 4x4 transform + world AABB (shape.hpp:47-68);
    multiple instances may point at the same span with different transforms
  - ``Box`` appends its 12 canonical triangles to the pool once and every
    box instance shares them via a translation transform (shape.cpp:74-119)

Triangles are stored in OBJECT space in the pool, exactly like the
reference; world-space flattening happens at scene build (see scene.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

Vec = Tuple[float, float, float]


@dataclasses.dataclass
class Sphere:
    material: int
    position: Vec
    radius: float


@dataclasses.dataclass
class Plane:
    material: int
    position: Vec
    normal: Vec


class TrianglePool:
    """The shared triangle pool (std::vector<Triangle>, main.cpp:96).

    Stored as growing numpy arrays: positions (N, 3, 3) and per-vertex
    normals (N, 3, 3), float32."""

    def __init__(self):
        self.positions = np.zeros((0, 3, 3), np.float32)
        self.normals = np.zeros((0, 3, 3), np.float32)

    def __len__(self) -> int:
        return self.positions.shape[0]

    def append(self, positions: np.ndarray, normals: np.ndarray) -> Tuple[int, int]:
        """Append (M, 3, 3) triangles; returns the (start, count) span."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3, 3)
        normals = np.asarray(normals, np.float32).reshape(-1, 3, 3)
        start = len(self)
        self.positions = np.concatenate([self.positions, positions])
        self.normals = np.concatenate([self.normals, normals])
        return start, positions.shape[0]

    def append_flat(self, normal_and_verts) -> Tuple[int, int]:
        """Append flat-shaded triangles given (normal, v0, v1, v2) tuples
        (Triangle's flat constructor, shape.cpp:20-27)."""
        pos = np.array([[v0, v1, v2] for _, v0, v1, v2 in normal_and_verts],
                       np.float32)
        nrm = np.array([[n, n, n] for n, _, _, _ in normal_and_verts],
                       np.float32)
        return self.append(pos, nrm)


@dataclasses.dataclass
class Model:
    """A mesh instance: span into the pool + transform.

    ``transform`` is a 4x4 row-major matrix applied to column vectors
    (world = T @ object), matching glm/render.cl:327."""
    material: int
    triangle_index: int
    num_triangles: int
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))

    def world_triangles(self, pool: TrianglePool):
        """Flatten this instance to world space: positions with the full
        transform, normals with the rotation-scale block only (render.cl:327,
        342) — normalization happens after interpolation on-device."""
        sl = slice(self.triangle_index, self.triangle_index + self.num_triangles)
        pos = pool.positions[sl]
        nrm = pool.normals[sl]
        m = np.asarray(self.transform, np.float32)
        wpos = pos @ m[:3, :3].T + m[:3, 3]
        wnrm = nrm @ m[:3, :3].T
        return wpos, wnrm

    def bounding_box(self, pool: TrianglePool):
        """World AABB over transformed vertices (shape.cpp:45-58)."""
        wpos, _ = self.world_triangles(pool)
        flat = wpos.reshape(-1, 3)
        if flat.shape[0] == 0:
            return np.full(3, np.inf, np.float32), np.full(3, -np.inf, np.float32)
        return flat.min(axis=0), flat.max(axis=0)


# -- Box factory ----------------------------------------------------------

_BOX_VERTICES = np.array(
    [[-1.0, -1.0, 1.0], [-1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
     [-1.0, 1.0, -1.0], [1.0, -1.0, 1.0], [1.0, 1.0, 1.0],
     [1.0, -1.0, -1.0], [1.0, 1.0, -1.0]], np.float32)

_BOX_TABLE = [
    (1, 2, 0), (3, 6, 2), (7, 4, 6), (5, 0, 4), (6, 0, 2), (3, 5, 7),
    (1, 3, 2), (3, 7, 6), (7, 5, 4), (5, 1, 0), (6, 4, 0), (3, 1, 5),
]


class Box:
    """Canonical 2x2x2 box mesh shared by all box instances.

    Mirrors Box::create_triangle / Box::model (shape.cpp:74-119): 12
    triangles appended once, each instance is a Model with a translation
    (and here also scale, folded into the transform) pointing at that span.
    """

    @staticmethod
    def create_triangles(pool: TrianglePool) -> Tuple[int, int]:
        tris = []
        for i0, i1, i2 in _BOX_TABLE:
            v1, v2, v3 = _BOX_VERTICES[i0], _BOX_VERTICES[i1], _BOX_VERTICES[i2]
            normal = np.cross(v2 - v1, v3 - v1)
            if np.dot(v1, normal) <= 0.0:
                normal = -normal  # flip if pointing toward the center
            normal = normal / np.linalg.norm(normal)
            tris.append((normal, v1, v2, v3))
        return pool.append_flat(tris)

    @staticmethod
    def model(material: int, span: Tuple[int, int], position: Vec,
              size: Vec = (2.0, 2.0, 2.0)) -> Model:
        """Box instance at `position` with full extents `size`.

        The reference's Box::model uses a pure translation (the canonical box
        is 2 units wide); non-default sizes fold a scale into the transform,
        which the reference edits via gizmos (interface.cpp:69-104)."""
        start, count = span
        t = np.eye(4, dtype=np.float32)
        t[0, 0] = size[0] / 2.0
        t[1, 1] = size[1] / 2.0
        t[2, 2] = size[2] / 2.0
        t[:3, 3] = position
        return Model(material=material, triangle_index=start,
                     num_triangles=count, transform=t)


def transform_trs(translation: Vec = (0, 0, 0),
                  rotation_ypr: Vec = (0, 0, 0),
                  scale: Vec = (1, 1, 1)) -> np.ndarray:
    """Build a TRS matrix T @ RotY(yaw) @ RotX(pitch) @ RotZ(roll) @ S,
    the same composition the editor recomposes for models
    (helper.hpp:76-89, interface.cpp:98-101)."""
    yaw, pitch, roll = rotation_ypr
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (ry @ rx @ rz) * np.asarray(scale, np.float32)[None, :]
    m[:3, 3] = translation
    return m
