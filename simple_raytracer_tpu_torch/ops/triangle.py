"""Brute-force nearest triangle: the host side of
``simple_raytracer_tpu/ops/pallas/triangle_kernel.py`` and the plain
version of the Hopper kernel that replaces its ``_kernel``
(``csrc/triangle_kernel.cu``, wrapped by ``ops/cuda/triangle_kernel.py``).

``pack_triangles`` is the kernel's (16, T) f32 table, one column per
triangle: rows v0 (0-2), e1 = v1 - v0 (3-5), e2 = v2 - v0 (6-8), active
(9) and six rows of zeros, the TPU's layout.  ``ops/scene_types.from_numpy``
packs it once per scene.

``nearest_triangle`` is the dense Moller-Trumbore loop every dense route
shares (``intersect.intersect_triangles`` and the plain version here):
every ray against every triangle under the reference's rules (a == 0
rejected, u in [0, 1], v >= 0, u + v <= 1, t > 0 strictly, inactive
triangles skipped), in chunks of at most ``TRI_CHUNK_ELEMS`` ray-triangle
pairs; the first index wins an exact tie (``torch.min`` within a chunk, a
strict ``<`` across chunks), and a miss gives (+inf, 0).
``intersect_packed_plain`` runs it over the packed table.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .vec import Vec3, dot

# rays x triangles per chunk of the dense triangle loop, by device type:
# on the CPU a chunk's f32 intermediates (16 MB each) stay near the
# caches, on a card (256 MB each) there are fewer, larger launches
TRI_CHUNK_ELEMS = {"cpu": 2 ** 22, "cuda": 2 ** 26}
PACKED_ROWS = 16


def pack_triangles(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                   active: np.ndarray) -> np.ndarray:
    """(T, 3) f32 vertices and (T,) active flags -> the (16, T) table; the
    edges are the same f32 subtractions the dense loop makes."""
    v0 = np.asarray(v0, np.float32)
    out = np.zeros((PACKED_ROWS, v0.shape[0]), np.float32)
    out[0:3] = v0.T
    out[3:6] = (np.asarray(v1, np.float32) - v0).T
    out[6:9] = (np.asarray(v2, np.float32) - v0).T
    out[9] = np.asarray(active, bool)
    return out


def nearest_triangle(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3,
                     active: torch.Tensor):
    """(R,) rays x (T,) triangles given as v0, e1, e2 ((T,) components)
    and bool ``active`` -> (t_best, idx_best int64, u, v): the nearest
    valid hit, (+inf, 0) on a miss, and MT's (u, v) at the winner."""
    max_elems = TRI_CHUNK_ELEMS.get(o.x.device.type, 2 ** 22)
    n = active.shape[0]
    col = lambda v: Vec3(v.x[:, None], v.y[:, None], v.z[:, None])
    ro, rd = col(o), col(d)
    t_best = torch.full_like(o.x, math.inf)
    i_best = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    u_best = torch.zeros_like(o.x)
    v_best = torch.zeros_like(o.x)
    chunk = max(1, max_elems // max(o.x.shape[0], 1))
    for c0 in range(0, n, chunk):
        sl = slice(c0, c0 + chunk)
        row = lambda v: Vec3(v.x[None, sl], v.y[None, sl], v.z[None, sl])
        a1, a2 = row(e1), row(e2)
        h = Vec3(rd.y * a2.z - rd.z * a2.y, rd.z * a2.x - rd.x * a2.z,
                 rd.x * a2.y - rd.y * a2.x)
        a = dot(a1, h)
        f = 1.0 / a
        s = ro - row(v0)
        u = f * dot(s, h)
        q = Vec3(s.y * a1.z - s.z * a1.y, s.z * a1.x - s.x * a1.z,
                 s.x * a1.y - s.y * a1.x)
        v = f * dot(rd, q)
        t = f * dot(a2, q)
        valid = ((a != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                 & (u + v <= 1.0) & (t > 0.0) & active[None, sl])
        t_c, i_c = torch.min(torch.where(valid, t, math.inf), dim=1)
        better = t_c < t_best
        pick = lambda x: torch.gather(x, 1, i_c[:, None])[:, 0]
        t_best = torch.where(better, t_c, t_best)
        i_best = torch.where(better, i_c + c0, i_best)
        u_best = torch.where(better, pick(u), u_best)
        v_best = torch.where(better, pick(v), v_best)
    return t_best, i_best, u_best, v_best


def intersect_packed_plain(o: Vec3, d: Vec3, packed: torch.Tensor):
    """The plain version of the triangle kernel: (R,) rays x the (16, T)
    packed table -> (t f32, idx int32), the kernel's contract
    (``intersect_triangles_pallas``)."""
    rows = lambda i: Vec3(packed[i], packed[i + 1], packed[i + 2])
    t, idx, _, _ = nearest_triangle(o, d, rows(0), rows(3), rows(6),
                                    packed[9] > 0.0)
    return t, idx.to(torch.int32)
