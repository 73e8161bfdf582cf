"""Binary STL: load into the triangle pool, and save.

The port's copy of ``simple_raytracer_tpu.io.stl``.  The reference's
``load_stl_model`` (src/parser.cpp:17-53) reads an 80-byte header, a
uint32 triangle count, then packed 50-byte records {flat normal f32x3, 3
vertices f32x3, uint16 attribute}.  Triangles are appended to the shared
pool flat-shaded (the file normal copied to all three vertices) and the
(start, count) span is returned.  The records are parsed by the host
library (``accel.parse_stl``), as the JAX package parses them by its
native one; ``force_python`` asks for the NumPy reading, the same bytes.
A truncated file loads its whole records on either route.
"""
from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from .. import accel
from ..models.shapes import TrianglePool

_RECORD = np.dtype([
    ("normal", "<f4", 3),
    ("v1", "<f4", 3),
    ("v2", "<f4", 3),
    ("v3", "<f4", 3),
    ("attr", "<u2"),
])


def load_stl_model(path: os.PathLike, pool: TrianglePool,
                   force_python: bool = False) -> Optional[Tuple[int, int]]:
    """Append the mesh to ``pool``; returns the (start, count) span, or
    None if the file cannot be opened or is shorter than its header."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    if len(raw) < 84:
        return None
    if not force_python:
        return pool.append(*accel.parse_stl(raw))
    (count,) = struct.unpack_from("<I", raw, 80)
    # a truncated file: its whole records, as the host library reads it
    count = min(count, (len(raw) - 84) // _RECORD.itemsize)
    data = np.frombuffer(raw, dtype=_RECORD, count=count, offset=84)
    pos = np.stack([data["v1"], data["v2"], data["v3"]], axis=1)
    nrm = np.repeat(data["normal"][:, None, :], 3, axis=1)
    return pool.append(pos.astype(np.float32), nrm.astype(np.float32))


def save_stl(path: os.PathLike, positions: np.ndarray,
             normals: Optional[np.ndarray] = None) -> None:
    """Write (M, 3, 3) triangles as binary STL; without ``normals`` each
    facet's normal is its unit face normal (0 for a degenerate one)."""
    positions = np.asarray(positions, np.float32).reshape(-1, 3, 3)
    m = positions.shape[0]
    if normals is None:
        e1 = positions[:, 1] - positions[:, 0]
        e2 = positions[:, 2] - positions[:, 0]
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        normals = np.where(norm > 0, n / np.maximum(norm, 1e-30), 0.0)
    rec = np.zeros(m, dtype=_RECORD)
    rec["normal"] = normals
    rec["v1"] = positions[:, 0]
    rec["v2"] = positions[:, 1]
    rec["v3"] = positions[:, 2]
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", m))
        f.write(rec.tobytes())
