"""Sphere, plane and triangle intersection and the nearest hit, as dense
batches.

The counterpart of ``simple_raytracer_tpu.ops.intersect``: every ray
meets every primitive of a category as an (R, N) batch, reduced to the
first minimum t per ray.  The nearest hit comes in two forms:

- ``closest_hit``, the whole-trace kernel's form and its plain version
  (``bounce_kernel._tris_small``): Moller-Trumbore dense over every
  triangle, with the smooth normal interpolated from MT's own (u, v).
- ``closest_hit_split``, the split per-bounce path's form (the JAX
  ``closest_hit`` with ``tri_backend`` "bvh", "clustered", "jnp" or
  "pallas"): a clustered mesh goes through the BVH kernel
  (``ops/cuda/bvh_kernel.py``), seeded with the nearest sphere or plane
  hit, a mesh without clusters through the dense loop; under "pallas"
  every mesh goes through the brute-force triangle kernel
  (``ops/cuda/triangle_kernel.py``), under "jnp" through the dense loop.
  The winner's table row is gathered (at the BVH kernel's slot, or the
  triangle's index) and the smooth normal interpolated at the barycentric
  weights of the hit position (``barycentric_weights_from_edges``).

The two normals differ by float rounding only.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cuda import bvh_kernel, triangle_kernel
from .scene_types import DeviceScene, Planes, Spheres, Triangles
from .triangle import nearest_triangle, staged_table
from .vec import Vec3, dot, normalize, sqrt, where as vwhere
from ..utils.metrics import span


class Hit(NamedTuple):
    """The nearest intersection of each ray (all (R,) tensors)."""
    hit: torch.Tensor        # bool: any intersection
    t: torch.Tensor          # f32 distance, inf on a miss
    position: Vec3
    normal: Vec3             # unit, flipped toward the ray
    front: torch.Tensor      # bool: the outside was hit (before the flip)
    material: torch.Tensor   # int64 material index (meaningless on a miss)
    triangle: torch.Tensor   # bool: the nearest hit is a triangle


def _rays(v: Vec3) -> Vec3:
    return Vec3(v.x[:, None], v.y[:, None], v.z[:, None])


def _table(t: torch.Tensor) -> Vec3:
    return Vec3(t[None, :, 0], t[None, :, 1], t[None, :, 2])


def intersect_spheres(o: Vec3, d: Vec3, s: Spheres):
    """(R,) rays x (Ns,) spheres -> (t_best, idx_best): b = dot(c - o, d),
    disc = b^2 - (|c - o|^2 - r^2); the near root, else the far one; a miss
    when disc < 0 or both roots lie behind (t == 0 is a hit)."""
    rc = _table(s.center) - _rays(o)
    b = dot(rc, _rays(d))
    c = dot(rc, rc) - (s.radius * s.radius)[None, :]
    disc = b * b - c
    sq = sqrt(torch.clamp_min(disc, 0.0))
    t0 = b - sq
    t1 = b + sq
    t = torch.where(t0 < 0.0, t1, t0)
    valid = (disc >= 0.0) & (t >= 0.0) & s.active[None, :]
    # torch.min returns the first minimum's index (0 for an all-inf row),
    # as jnp.argmin does
    return torch.min(torch.where(valid, t, math.inf), dim=1)


def intersect_planes(o: Vec3, d: Vec3, p: Planes):
    """t = dot(n, p - o) / dot(n, d); a miss when the denominator is
    exactly 0 or t < 0."""
    n = _table(p.normal)
    denom = dot(n, _rays(d))
    t = dot(n, _table(p.position) - _rays(o)) / denom
    valid = (denom != 0.0) & (t >= 0.0) & p.active[None, :]
    return torch.min(torch.where(valid, t, math.inf), dim=1)


def intersect_triangles(o: Vec3, d: Vec3, tr: Triangles):
    """(R,) rays x (Nt,) triangles -> (t_best, idx_best, u, v): the dense
    loop ``triangle.nearest_triangle`` (MT under the reference's rules,
    the first index winning an exact tie, in chunks of at most
    TRI_CHUNK_ELEMS ray-triangle pairs), with MT's (u, v) at the
    winner."""
    cols = lambda t: Vec3(t[:, 0], t[:, 1], t[:, 2])
    return nearest_triangle(o, d, cols(tr.v0), cols(tr.v1 - tr.v0),
                            cols(tr.v2 - tr.v0), tr.active)


def triangle_normal(tr: Triangles, idx: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> Vec3:
    """The unnormalized smooth normal n0 w0 + n1 u + n2 v, w0 = 1 - u - v,
    at MT's (u, v) (p = v0 + u e1 + v e2)."""
    w0 = 1.0 - u - v
    return (Vec3.from_array(tr.n0[idx]) * w0 + Vec3.from_array(tr.n1[idx]) * u
            + Vec3.from_array(tr.n2[idx]) * v)


def barycentric_weights(v0: Vec3, v1: Vec3, v2: Vec3, p: Vec3):
    """The weights (w2, w0, w1) of p, to pair with the vertex normals
    (n0, n1, n2) (simple_raytracer_tpu.ops.intersect.barycentric_weights,
    with the reference's result rotation)."""
    return barycentric_weights_from_edges(v1 - v0, v2 - v0, p - v0)


def barycentric_weights_from_edges(a: Vec3, b: Vec3, c: Vec3):
    """barycentric_weights from the edges a = v1 - v0, b = v2 - v0 and
    c = p - v0, in the JAX function's operation order."""
    d00 = dot(a, a)
    d01 = dot(a, b)
    d11 = dot(b, b)
    d20 = dot(c, a)
    d21 = dot(c, b)
    denom = d00 * d11 - d01 * d01
    w0 = (d11 * d20 - d01 * d21) / denom
    w1 = (d00 * d21 - d01 * d20) / denom
    w2 = 1.0 - w0 - w1
    return w2, w0, w1


def _resolve(scene: DeviceScene, o: Vec3, d: Vec3, t_s, i_s, t_p, i_p, t_t,
             tri_shade) -> Hit:
    """The nearest hit across categories, ties going to the sphere, then
    the plane, then the triangle; ``tri_shade(position)`` gives the
    triangle winner's (unit normal, material).  The normal is flipped to
    face the ray."""
    inf = torch.full_like(o.x, math.inf)
    zero_i = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    t = torch.minimum(torch.minimum(t_s, t_p), t_t)
    hit = torch.isfinite(t)
    is_s = t_s == t
    is_p = ~is_s & (t_p == t)
    position = o + d * t

    if scene.spheres.radius.shape[0] > 0:
        n_sph = (position - Vec3.from_array(scene.spheres.center[i_s])
                 ) / scene.spheres.radius[i_s]
        m_sph = scene.spheres.material[i_s]
    else:
        n_sph, m_sph = Vec3(inf, inf, inf), zero_i
    if scene.planes.material.shape[0] > 0:
        n_pln = Vec3.from_array(scene.planes.normal[i_p])
        m_pln = scene.planes.material[i_p]
    else:
        n_pln, m_pln = Vec3(inf, inf, inf), zero_i
    if scene.triangles.material.shape[0] > 0:
        n_tri, m_tri = tri_shade(position)
    else:
        n_tri, m_tri = Vec3(inf, inf, inf), zero_i

    normal = vwhere(is_s, n_sph, vwhere(is_p, n_pln, n_tri))
    material = torch.where(is_s, m_sph, torch.where(is_p, m_pln, m_tri))
    triangle = hit & ~is_s & ~is_p
    front = dot(normal, d) < 0.0
    normal = normal * torch.where(front, 1.0, -1.0)
    return Hit(hit=hit, t=t, position=position, normal=normal, front=front,
               material=material, triangle=triangle)


def _spheres_planes(scene: DeviceScene, o: Vec3, d: Vec3):
    inf = torch.full_like(o.x, math.inf)
    zero_i = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    t_s, i_s = (intersect_spheres(o, d, scene.spheres)
                if scene.spheres.radius.shape[0] > 0 else (inf, zero_i))
    t_p, i_p = (intersect_planes(o, d, scene.planes)
                if scene.planes.material.shape[0] > 0 else (inf, zero_i))
    return t_s, i_s, t_p, i_p


def closest_hit(scene: DeviceScene, o: Vec3, d: Vec3) -> Hit:
    """The whole-trace kernel's nearest hit: every triangle densely, the
    smooth normal at MT's (u, v)."""
    t_s, i_s, t_p, i_p = _spheres_planes(scene, o, d)
    tr = scene.triangles
    t_t = torch.full_like(o.x, math.inf)
    i_t = u_t = v_t = None
    if tr.material.shape[0] > 0:
        t_t, i_t, u_t, v_t = intersect_triangles(o, d, tr)
    return _resolve(scene, o, d, t_s, i_s, t_p, i_p, t_t,
                    lambda position: (normalize(triangle_normal(
                        tr, i_t, u_t, v_t)), tr.material[i_t]))


def shade_from_position(rows: torch.Tensor, position: Vec3):
    """A triangle winner's unit smooth normal and material from its
    (R, TRI_COLS) table rows: the normals interpolated at the barycentric
    weights of the hit position, from the edges in the row (columns 3-8),
    as the JAX BVH route does with the kernel's winner attributes."""
    col = lambda j: Vec3(rows[:, j], rows[:, j + 1], rows[:, j + 2])
    wx, wy, wz = barycentric_weights_from_edges(col(3), col(6),
                                                position - col(0))
    n = col(9) * wx + col(12) * wy + col(15) * wz
    return normalize(n), rows[:, 18].to(torch.int64)


def closest_hit_split(scene: DeviceScene, o: Vec3, d: Vec3,
                      alive: torch.Tensor, compact: bool = False,
                      tri_backend: str = "auto") -> Hit:
    """The split path's nearest hit for the (R,) rays whose ``alive`` is
    set (the other rays' results are not used).

    Under ``tri_backend`` "pallas" every mesh goes through the triangle
    kernel over every active triangle of its staged table, for the live
    rays only (on the CPU, its plain version over the packed table), under
    "jnp" through the dense loop over every ray and triangle, clustered
    or not, as the JAX ``closest_hit`` routes them; the winner's row comes
    from the triangle-indexed table ``Triangles.rows``.  Otherwise a
    clustered mesh goes through the BVH kernel with its far bound seeded
    by the nearest sphere or plane hit (on the CPU, its plain version),
    behind the ray compaction when ``compact``; ``tri_backend="clustered"``
    forces its streamed variant, as the JAX ``closest_hit`` forces
    ``hbm_table``.  Its winner's row is the slot table's, at the slot it
    reports.  A mesh without clusters goes through the dense loop.  The
    winner is shaded at the hit position.

    Its stages are the spans ``srt.nearest_prims`` (the spheres and the
    planes), ``srt.bvh`` (the triangle route, with the BVH's far bound)
    and ``srt.shade`` (the resolve and the winner's shading)."""
    with span("srt.nearest_prims"):
        t_s, i_s, t_p, i_p = _spheres_planes(scene, o, d)
    tr = scene.triangles
    with span("srt.bvh"):
        t_t = torch.full_like(o.x, math.inf)
        i_t, rows = None, tr.rows
        if tr.material.shape[0] > 0:
            if tri_backend == "pallas":
                staged = (None if o.x.device.type == "cpu"
                          else staged_table(tr))
                t_t, i_t = triangle_kernel.intersect_triangles_packed(
                    o, d, tr.packed, alive, staged)
                i_t = i_t.long()
            elif tri_backend != "jnp" and tr.clusters is not None:
                t_t, i_t = bvh_kernel.intersect_triangles_bvh(
                    o, d, alive, torch.minimum(t_s, t_p), tr.clusters,
                    tr.table, compact=compact,
                    force_streamed=tri_backend == "clustered")
                i_t = i_t.clamp_min(0).long()   # slot -1 (no win): t is +inf
                rows = tr.table
            else:
                t_t, i_t, _, _ = intersect_triangles(o, d, tr)
    with span("srt.shade"):
        return _resolve(scene, o, d, t_s, i_s, t_p, i_p, t_t,
                        lambda position: shade_from_position(rows[i_t],
                                                             position))
