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
``intersect_packed_plain`` runs it over the packed table, on the live rays
only when given an ``alive`` mask (a dead ray gets (+inf, 0)).

``stage_triangles`` is the kernel's own layout of the same table: one
48-byte row per active triangle, built on the kernel's first launch and
kept on the scene (``staged_table``).
``pretest_rejects`` is the kernel's division-free early-out, repeated in
its operation order; only the tests call it.
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
# the staged table's row: v0 and the column index (int32 bits), e1 and 0,
# e2 and 0 (three float4s)
STAGED_COLS = 12
# the kernel's early-out (pretest_rejects): u is certainly above 1 when
# x * sign(a) > |a| * PRETEST_UPPER, certainly below 0 when
# x * sign(a) <= -PRETEST_X_MIN while |a| <= PRETEST_A_MAX
PRETEST_UPPER = 1.0 + 2.0 ** -20
PRETEST_X_MIN = 2.0 ** -64
PRETEST_A_MAX = 2.0 ** 64


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


def stage_triangles(packed: torch.Tensor) -> torch.Tensor:
    """The kernel's staged table from the packed (16, T) one, on its
    device: the active columns in order, one (STAGED_COLS,) f32 row each:
    v0 and the column index (its int32 bits), e1 and 0, e2 and 0.  A tile
    of rows is one contiguous copy."""
    act = torch.nonzero(packed[9] > 0.0)[:, 0]
    out = packed.new_zeros((act.numel(), STAGED_COLS))
    out[:, 0:3] = packed[0:3, act].T
    out[:, 3] = act.to(torch.int32).view(torch.float32)
    out[:, 4:7] = packed[3:6, act].T
    out[:, 8:11] = packed[6:9, act].T
    return out


def staged_table(triangles) -> torch.Tensor:
    """``stage_triangles`` of a scene's ``Triangles.packed``, built on
    first use and kept on the Triangles (once per scene): only the
    triangle kernel reads it."""
    if triangles.staged is None:
        # the dataclass is frozen; the field is a cache of its table
        object.__setattr__(triangles, "staged",
                           stage_triangles(triangles.packed))
    return triangles.staged


def moller_trumbore(o: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore's terms, elementwise (broadcasting), in the kernels'
    operation order: (a = e1.h, x = s.h, u, v, t) with h = d x e2,
    s = o - v0, q = s x e1 and f = 1 / a."""
    h = Vec3(d.y * e2.z - d.z * e2.y, d.z * e2.x - d.x * e2.z,
             d.x * e2.y - d.y * e2.x)
    a = dot(e1, h)
    f = 1.0 / a
    s = o - v0
    x = dot(s, h)
    q = Vec3(s.y * e1.z - s.z * e1.y, s.z * e1.x - s.x * e1.z,
             s.x * e1.y - s.y * e1.x)
    return a, x, f * x, f * dot(d, q), f * dot(e2, q)


def pretest_rejects(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's early-out on MT's a = e1.h and x = s.h (f32), in its
    operation order: True where Moller-Trumbore certainly rejects the
    pair, from u = RN(RN(1 / a) * x) certainly outside [0, 1].  With
    xs = x * sign(a) (a sign flip, exact):

    - xs > RN(|a| * (1 + 2^-20)): u > 1, or u = inf;
    - xs <= -2^-64 with |a| <= 2^64: RN(1 / a) is at least 2^-64 in
      magnitude, so |RN(1 / a) * x| >= 2^-128 does not round to -0.0,
      and u < 0 (or -inf).

    A NaN never rejects.  a == 0 is left to MT: u is then +-inf or NaN,
    outside [0, 1].  tests/test_torch_triangle_live.py proves the margins
    on adversarial floats."""
    sign = a.view(torch.int32) & -2 ** 31
    xs = (x.view(torch.int32) ^ sign).view(torch.float32)
    aa = a.abs()
    upper = torch.tensor(PRETEST_UPPER, dtype=torch.float32, device=a.device)
    return (xs > aa * upper) | ((xs <= -PRETEST_X_MIN)
                                & (aa <= PRETEST_A_MAX))


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
        a, _, u, v, t = moller_trumbore(ro, rd, row(v0), row(e1), row(e2))
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


def intersect_packed_plain(o: Vec3, d: Vec3, packed: torch.Tensor,
                           alive=None):
    """The plain version of the triangle kernel: (R,) rays x the (16, T)
    packed table -> (t f32, idx int32), the kernel's contract
    (``intersect_triangles_pallas``) on every ray whose (R,) bool
    ``alive`` is set (None: every ray); a dead ray gets (+inf, 0)."""
    if alive is not None:
        live = torch.nonzero(alive)[:, 0]
        sub = lambda v: Vec3(v.x[live], v.y[live], v.z[live])
        t_live, i_live = intersect_packed_plain(sub(o), sub(d), packed)
        t = torch.full_like(o.x, math.inf)
        idx = torch.zeros(o.x.shape, dtype=torch.int32, device=o.x.device)
        t[live] = t_live
        idx[live] = i_live
        return t, idx
    rows = lambda i: Vec3(packed[i], packed[i + 1], packed[i + 2])
    t, idx, _, _ = nearest_triangle(o, d, rows(0), rows(3), rows(6),
                                    packed[9] > 0.0)
    return t, idx.to(torch.int32)
