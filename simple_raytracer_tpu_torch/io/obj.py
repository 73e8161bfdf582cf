"""Wavefront OBJ: load into the triangle pool (the reference's subset),
and save.

The port's copy of ``simple_raytracer_tpu.io.obj``, with its messages.
The reference's ``load_obj_model`` (src/parser.cpp:55-135) reads ``v``,
``vn`` and ``f`` statements with ``v``, ``v/vt``, ``v//vn`` and
``v/vt/vn`` index forms; ``s``, comments, materials and textures are
ignored; normals are normalized on load; indices are 1-based, negative
ones counting from the end of the list.  Three fixes over the reference:
a negative index means ``len + index`` (its ``len - index + 1`` lands out
of range), a face without normal indices takes the flat face normal, and
a polygon of more than 3 vertices is fan-triangulated.  A malformed
statement raises ValueError with its line number.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..models.shapes import TrianglePool


def _parse_index_group(token: str) -> Tuple[int, Optional[int]]:
    """'7', '7/2', '7//3', '7/2/3' -> (vertex_index, normal_index|None)."""
    parts = token.split("/")
    v = int(parts[0])
    n = None
    if len(parts) == 3 and parts[2]:
        n = int(parts[2])
    return v, n


def _adjust(index: int, length: int) -> int:
    """1-based -> 0-based; negative indices count from the end.

    Resolution is DEFERRED to after the whole file is read, against the
    FINAL list lengths — exactly like the reference, which collects all
    faces first and adjusts with the final vertices.size()
    (parser.cpp:112-124).  The OBJ spec says negative indices are
    relative to the list length at the face statement; files that
    interleave v/f blocks with relative indices resolve differently
    here, faithfully reproducing the reference's behavior.  (The
    reference's `len - index + 1` negative formula itself lands out of
    range — that arithmetic bug IS fixed here: -1 means the last
    element.)"""
    return length + index if index < 0 else index - 1


def load_obj_model(path: os.PathLike,
                   pool: TrianglePool) -> Optional[Tuple[int, int]]:
    """Append the mesh to `pool`; returns the (start, count) span, or None
    if the file cannot be opened."""
    try:
        with open(path, "r") as f:
            lines = f.readlines()
    except OSError:
        return None

    vertices: List[Tuple[float, float, float]] = []
    normals: List[np.ndarray] = []
    faces: List[List[Tuple[int, Optional[int]]]] = []

    for lineno, line in enumerate(lines, start=1):
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        mode = parts[0]
        try:
            if mode == "v":
                vertices.append(
                    (float(parts[1]), float(parts[2]), float(parts[3])))
            elif mode == "vn":
                n = np.array([float(parts[1]), float(parts[2]),
                              float(parts[3])], np.float32)
                norm = np.linalg.norm(n)
                normals.append(n / norm if norm > 0 else n)
            elif mode == "f":
                groups = [_parse_index_group(t) for t in parts[1:]]
                if len(groups) < 3:
                    raise ValueError("face needs at least 3 vertices")
                # fan-triangulate polygons: (0, i, i+1) for each extra vertex
                for i in range(1, len(groups) - 1):
                    faces.append([groups[0], groups[i], groups[i + 1]])
            # 's', 'vt', 'usemtl', ... ignored (parser.cpp:121-123)
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"{path}: malformed OBJ statement on line {lineno}: "
                f"{line.strip()!r} ({e})") from None

    varr = np.asarray(vertices, np.float32).reshape(-1, 3)
    pos = np.zeros((len(faces), 3, 3), np.float32)
    nrm = np.zeros((len(faces), 3, 3), np.float32)
    for fi, face in enumerate(faces):
        for ci, (vi, ni) in enumerate(face):
            adj = _adjust(vi, len(vertices))
            if not 0 <= adj < len(vertices):
                raise ValueError(f"{path}: face vertex index {vi} out of "
                                 f"range (file has {len(vertices)} vertices)")
            pos[fi, ci] = varr[adj]
            if ni is not None:
                nadj = _adjust(ni, len(normals))
                if not 0 <= nadj < len(normals):
                    raise ValueError(
                        f"{path}: face normal index {ni} out of range "
                        f"(file has {len(normals)} normals)")
                nrm[fi, ci] = normals[nadj]
        if any(ni is None for _, ni in face):
            e1 = pos[fi, 1] - pos[fi, 0]
            e2 = pos[fi, 2] - pos[fi, 0]
            n = np.cross(e1, e2)
            l = np.linalg.norm(n)
            flat = n / l if l > 0 else n
            for ci, (_, ni) in enumerate(face):
                if ni is None:
                    nrm[fi, ci] = flat

    return pool.append(pos, nrm)


def save_obj(path: os.PathLike, positions: np.ndarray,
             normals: np.ndarray) -> None:
    """Write (T, 3, 3) triangle soup as OBJ with per-vertex normals,
    using only statements the reference's loader consumes (``v``, ``vn``,
    ``f v//vn``, parser.cpp:55-135).  Unlike STL (one flat normal per
    facet), this round-trips smooth shading.  Duplicate vertices and
    normals are shared so the file stays compact."""
    positions = np.asarray(positions, np.float32).reshape(-1, 3, 3)
    normals = np.asarray(normals, np.float32).reshape(-1, 3, 3)
    if positions.shape != normals.shape:
        raise ValueError("positions and normals must both be (T, 3, 3)")

    def index_unique(arr):
        flat = arr.reshape(-1, 3)
        uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
        return uniq, inverse.reshape(arr.shape[:2]) + 1  # OBJ is 1-based

    vu, vidx = index_unique(positions)
    nu, nidx = index_unique(normals)
    lines = [f"# {positions.shape[0]} triangles "
             "(simple_raytracer_tpu_torch save_obj)"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in vu]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in nu]
    lines += [f"f {vidx[t, 0]}//{nidx[t, 0]} {vidx[t, 1]}//{nidx[t, 1]} "
              f"{vidx[t, 2]}//{nidx[t, 2]}"
              for t in range(positions.shape[0])]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
