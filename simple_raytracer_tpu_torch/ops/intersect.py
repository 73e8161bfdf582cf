"""Sphere and plane intersection and the nearest hit, as dense batches.

The counterpart of ``simple_raytracer_tpu.ops.intersect`` for scenes
without triangles: every ray meets every primitive of a category as an
(R, N) batch, reduced to the first minimum t per ray.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .scene_types import DeviceScene, Planes, Spheres
from .vec import Vec3, dot, sqrt, where as vwhere


class Hit(NamedTuple):
    """The nearest intersection of each ray (all (R,) tensors)."""
    hit: torch.Tensor        # bool: any intersection
    t: torch.Tensor          # f32 distance, inf on a miss
    position: Vec3
    normal: Vec3             # unit, flipped toward the ray
    front: torch.Tensor      # bool: the outside was hit (before the flip)
    material: torch.Tensor   # int64 material index (meaningless on a miss)


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


def closest_hit(scene: DeviceScene, o: Vec3, d: Vec3) -> Hit:
    """Nearest hit across categories, ties going to the sphere before the
    plane; the normal is flipped to face the ray."""
    inf = torch.full_like(o.x, math.inf)
    zero_i = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    has_spheres = scene.spheres.radius.shape[0] > 0
    has_planes = scene.planes.material.shape[0] > 0
    t_s, i_s = (intersect_spheres(o, d, scene.spheres) if has_spheres
                else (inf, zero_i))
    t_p, i_p = (intersect_planes(o, d, scene.planes) if has_planes
                else (inf, zero_i))

    t = torch.minimum(t_s, t_p)
    hit = torch.isfinite(t)
    is_s = t_s == t
    position = o + d * t

    if has_spheres:
        n_sph = (position - Vec3.from_array(scene.spheres.center[i_s])
                 ) / scene.spheres.radius[i_s]
        m_sph = scene.spheres.material[i_s]
    else:
        n_sph, m_sph = Vec3(inf, inf, inf), zero_i
    if has_planes:
        n_pln = Vec3.from_array(scene.planes.normal[i_p])
        m_pln = scene.planes.material[i_p]
    else:
        n_pln, m_pln = Vec3(inf, inf, inf), zero_i

    normal = vwhere(is_s, n_sph, n_pln)
    material = torch.where(is_s, m_sph, m_pln)
    front = dot(normal, d) < 0.0
    normal = normal * torch.where(front, 1.0, -1.0)
    return Hit(hit=hit, t=t, position=position, normal=normal, front=front,
               material=material)
