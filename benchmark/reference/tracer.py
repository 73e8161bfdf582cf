"""The plain reference path tracer, in PyTorch.

A straightforward implementation of the reference application's kernel
(render.cl:396-523), written for this benchmark and independent of the
program: it imports nothing of it, and works from the spheres, planes,
triangles, materials, sky, camera and pass seeds that the benchmark made.
Its triangles are found through its own tree (``lbvh.py``).

Each path, for pixel p, sample s and a pass seeded with ``time``:

  seed = (s + p * S) * time * 5304; two uniforms jitter the pixel;
  the direction is rot(yaw, pitch) (sx, sy, -1), normalized;
  per bounce: the nearest sphere, plane or triangle (ties in that order);
  a miss adds throughput * sky and ends the path; a hit adds throughput *
  emission; the last bounce adds emission only; otherwise the BSDF draws
  6 uniforms for a hemisphere direction, then metallic, specular and
  transmittance, and Schlick's uniform only for a transparent ray that is
  not totally internally reflected; the new origin is offset 0.001 along
  the normal, on the side of the new direction.

A pass adds each pixel's mean over its S samples to the canvas.  The
arithmetic runs in ``dtype`` (float32, or lower for a control), the
transcendentals of the RNG in float64 rounded once, the box tests of the
tree in float32, and the sum over passes in float64.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import rng
from .lbvh import LBVH

MATERIAL_FIELDS = ("smoothness", "metallic", "specular", "emission_strength",
                   "transmittance", "refraction_index")


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def _reflect(v, n):
    return v - n * (2.0 * _dot(v, n))[..., None]


def _mix(a, b, t):
    return a + (b - a) * t


def _smoothstep(e0: float, e1: float, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@dataclasses.dataclass
class Scene:
    """World-space primitives on one device, in the working dtype."""
    sphere_c: torch.Tensor
    sphere_r: torch.Tensor
    sphere_m: torch.Tensor
    plane_p: torch.Tensor
    plane_n: torch.Tensor
    plane_m: torch.Tensor
    tri_v: torch.Tensor          # (T, 3, 3) vertices
    tri_n: torch.Tensor          # (T, 3, 3) vertex normals
    tri_m: torch.Tensor
    mat: dict
    sky: dict
    bvh: Optional[LBVH]
    dtype: torch.dtype

    @staticmethod
    def from_arrays(a: dict, device, dtype=torch.float32) -> "Scene":
        """``a``: numpy arrays ``spheres.center`` (Ns, 3), ``.radius``,
        ``.material``; ``planes.position``, ``.normal``, ``.material``;
        ``triangles.positions`` and ``.normals`` (T, 3, 3) in world space,
        ``.material``; ``materials.<field>`` and ``.color``, ``.emission``;
        ``sky.<field>``."""
        f = lambda k: torch.tensor(np.asarray(a[k], np.float32),
                                   device=device)
        i = lambda k: torch.tensor(np.asarray(a[k], np.int64), device=device)
        tri_v = f("triangles.positions")
        bvh = (LBVH(tri_v[:, 0], tri_v[:, 1], tri_v[:, 2])
               if tri_v.shape[0] else None)
        mat = {k: f(f"materials.{k}").to(dtype)
               for k in (*MATERIAL_FIELDS, "color", "emission")}
        sky = {k[4:]: f(k).to(dtype) for k in a if k.startswith("sky.")}
        return Scene(f("spheres.center").to(dtype),
                     f("spheres.radius").to(dtype), i("spheres.material"),
                     f("planes.position").to(dtype),
                     f("planes.normal").to(dtype), i("planes.material"),
                     tri_v.to(dtype), f("triangles.normals").to(dtype),
                     i("triangles.material"), mat, sky, bvh, dtype)


def closest(sc: Scene, o, d):
    """(hit, t, position, unit normal facing the ray, front, material) of
    the (R, 3) rays."""
    r = o.shape[0]
    inf = torch.full((r,), math.inf, dtype=sc.dtype, device=o.device)
    t_s, i_s = inf.clone(), torch.zeros(r, dtype=torch.int64, device=o.device)
    for k in range(sc.sphere_r.shape[0]):
        rc = sc.sphere_c[k] - o
        b = _dot(rc, d)
        disc = b * b - (_dot(rc, rc) - sc.sphere_r[k] * sc.sphere_r[k])
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t = torch.where(b - sq < 0.0, b + sq, b - sq)
        upd = (disc >= 0.0) & (t >= 0.0) & (t < t_s)
        t_s = torch.where(upd, t, t_s)
        i_s = torch.where(upd, k, i_s)
    t_p, i_p = inf.clone(), torch.zeros_like(i_s)
    for k in range(sc.plane_m.shape[0]):
        n = sc.plane_n[k]
        denom = _dot(n.expand_as(d), d)
        t = _dot(n.expand_as(o), sc.plane_p[k] - o) / denom
        upd = (denom != 0.0) & (t >= 0.0) & (t < t_p)
        t_p = torch.where(upd, t, t_p)
        i_p = torch.where(upd, k, i_p)
    t_t, i_t = inf.clone(), torch.zeros_like(i_s)
    if sc.bvh is not None:
        t_t, i_t = sc.bvh.nearest(o, d, torch.minimum(t_s, t_p), sc.dtype)
        t_t = t_t.to(sc.dtype)
    t = torch.minimum(torch.minimum(t_s, t_p), t_t)
    hit = torch.isfinite(t)
    is_s = t_s == t
    is_p = ~is_s & (t_p == t)
    tz = torch.where(hit, t, 0.0)
    pos = o + d * tz[:, None]
    normal = torch.zeros_like(o)
    material = torch.zeros_like(i_s)
    if sc.sphere_r.shape[0]:
        n_s = (pos - sc.sphere_c[i_s]) / sc.sphere_r[i_s][:, None]
        normal = torch.where(is_s[:, None], n_s, normal)
        material = torch.where(is_s, sc.sphere_m[i_s], material)
    if sc.plane_m.shape[0]:
        normal = torch.where(is_p[:, None], sc.plane_n[i_p], normal)
        material = torch.where(is_p, sc.plane_m[i_p], material)
    is_t = hit & ~is_s & ~is_p
    if sc.bvh is not None:
        j = i_t.clamp_min(0)
        v = sc.tri_v[j]
        a, b, c = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], pos - v[:, 0]
        d00, d01, d11 = _dot(a, a), _dot(a, b), _dot(b, b)
        d20, d21 = _dot(c, a), _dot(c, b)
        denom = d00 * d11 - d01 * d01
        w0 = (d11 * d20 - d01 * d21) / denom
        w1 = (d00 * d21 - d01 * d20) / denom
        w2 = 1.0 - w0 - w1
        nv = sc.tri_n[j]
        n_t = _normalize(nv[:, 0] * w2[:, None] + nv[:, 1] * w0[:, None]
                         + nv[:, 2] * w1[:, None])
        normal = torch.where(is_t[:, None], n_t, normal)
        material = torch.where(is_t, sc.tri_m[j], material)
    front = _dot(normal, d) < 0.0
    normal = normal * torch.where(front, 1.0, -1.0).to(sc.dtype)[:, None]
    return hit, pos, normal, front, material


def sky_color(sc: Scene, d):
    """The gradient sky with the sun, shown where the ground fade is 1."""
    s = sc.sky
    y = d[:, 1]
    t = torch.pow(_smoothstep(0.0, 0.4, y), 0.35)
    grad = _mix(s["horizon_color"], s["zenith_color"], t[:, None])
    g2s = _smoothstep(-0.01, 0.0, y)
    sun_cos = torch.clamp_min(_dot(d, -s["sun_direction"].expand_as(d)), 0.0)
    sun = (torch.pow(sun_cos, s["sun_focus"]) * s["sun_intensity"]
           * (g2s >= 1.0).to(sc.dtype))
    return (_mix(s["ground_color"], grad, g2s[:, None])
            + s["sun_color"] * sun[:, None])


def sample_bsdf(sc: Scene, pos, n, front, d, mi, seed):
    """(new origin, new direction, throughput factor, seed)."""
    dt = sc.dtype
    m = {k: v[mi] for k, v in sc.mat.items()}
    seed, hemi = rng.next_hemisphere(n, seed, dt)
    random_dir = _normalize(n + hemi)
    reflected = _reflect(d, n)
    seed, u_metal = rng.next_uniform(seed, dt)
    seed, u_spec = rng.next_uniform(seed, dt)
    is_metal = m["metallic"] > u_metal
    is_spec = m["specular"] > u_spec
    rough = _mix(random_dir, reflected, m["smoothness"][:, None])
    seed, u_trans = rng.next_uniform(seed, dt)
    is_trans = m["transmittance"] > u_trans
    seed_opaque = seed
    mirror_like = (is_metal | is_spec).to(dt)[:, None]
    dir_opaque = _mix(random_dir, rough, mirror_like)
    one = torch.ones_like(m["color"])
    mask_opaque = _mix(m["color"], one, is_spec.to(dt)[:, None])
    refl_smooth = _reflect(rough, n)
    mu = torch.where(front, 1.0 / m["refraction_index"],
                     m["refraction_index"])
    cos_t = torch.clamp_max(_dot(refl_smooth, -n), 1.0)
    sin_t = torch.sqrt(1.0 - cos_t * cos_t)
    tir = mu * sin_t > 1.0
    seed_s, u_s = rng.next_uniform(seed, dt)
    seed_trans = torch.where(tir, seed, seed_s)
    r0 = (1.0 - mu) / (1.0 + mu)
    r0 = r0 * r0
    k = 1.0 - cos_t
    schlick = r0 + (1.0 - r0) * (k * k * k * k * k)
    refl_t = tir | (schlick > u_s)
    out_perp = (refl_smooth + n * cos_t[:, None]) * mu[:, None]
    out_par = n * (-torch.sqrt(torch.abs(1.0 - _dot(out_perp, out_perp)))
                   )[:, None]
    refracted = out_perp + out_par
    dir_trans = torch.where(refl_t[:, None], rough, refracted)
    mask_trans = torch.where(refl_t[:, None], one, m["color"])
    new_dir = _normalize(torch.where(is_trans[:, None], dir_trans,
                                     dir_opaque))
    mask_mul = torch.where(is_trans[:, None], mask_trans, mask_opaque)
    seed = torch.where(is_trans, seed_trans, seed_opaque)
    origin = pos + n * (rng.sign(_dot(n, new_dir)) * 0.001)[:, None]
    return origin, new_dir, mask_mul, seed


def trace(sc: Scene, o, d, seed, num_bounces: int):
    """Radiance (R, 3) of the paths from rays (o, d) with RNG ``seed``."""
    r = o.shape[0]
    dt = sc.dtype
    color = torch.zeros((r, 3), dtype=dt, device=o.device)
    mask = torch.ones_like(color)
    sky_mask = torch.zeros_like(color)
    sky_dir = torch.zeros_like(color)
    sky_dir[:, 2] = 1.0
    live = torch.arange(r, device=o.device)
    for i in range(num_bounces):
        ol, dl, sl, ml = o[live], d[live], seed[live], mask[live]
        hit, pos, n, front, mi = closest(sc, ol, dl)
        miss = live[~hit]
        sky_mask[miss] = ml[~hit]
        sky_dir[miss] = dl[~hit]
        live, pos, n, front, mi = (x[hit] for x in (live, pos, n, front, mi))
        dl, sl, ml = dl[hit], sl[hit], ml[hit]
        emission = ml * sc.mat["emission"][mi] \
            * sc.mat["emission_strength"][mi][:, None]
        color[live] = color[live] + emission
        if i == num_bounces - 1 or not live.numel():
            break
        o_new, d_new, mul, s_new = sample_bsdf(sc, pos, n, front, dl, mi, sl)
        o[live], d[live] = o_new, d_new
        mask[live] = ml * mul
        seed[live] = s_new
    return color + sky_mask * sky_color(sc, sky_dir)


@dataclasses.dataclass(frozen=True)
class View:
    """The camera and the frame: position, yaw, pitch, fov (radians),
    width, height, samples a pass, bounces."""
    position: tuple
    yaw: float
    pitch: float
    fov: float
    width: int
    height: int
    num_samples: int
    num_bounces: int


def primary_rays(view: View, pixel_ids, times, dtype):
    """Rays of every (pass, pixel, sample) in that order: (o, d, seed)."""
    dev = pixel_ids.device
    f32 = np.float32
    s_count = view.num_samples
    cy, sy = np.cos(f32(view.yaw)), np.sin(f32(view.yaw))
    cp, sp = np.cos(f32(view.pitch)), np.sin(f32(view.pitch))
    rot = [[cy, sy * sp, sy * cp], [f32(0.0), cp, -sp],
           [-sy, cy * sp, cy * cp]]
    aspect = float(f32(view.width / view.height))
    fov_scale = float(f32(math.tan(view.fov / 2.0)))
    n_pass, n_pix = times.shape[0], pixel_ids.shape[0]
    pid = pixel_ids.repeat_interleave(s_count).repeat(n_pass)
    sample = torch.arange(s_count, device=dev).repeat(n_pass * n_pix)
    time = times.repeat_interleave(n_pix * s_count)
    seed = rng.pixel_seed(sample, pid, s_count, time)
    seed, u1 = rng.next_uniform(seed, dtype)
    seed, u2 = rng.next_uniform(seed, dtype)
    px = (pid % view.width).to(dtype)
    py = (pid // view.width).to(dtype)
    ndc_x = (px + u1) / torch.tensor(float(view.width), dtype=dtype,
                                     device=dev)
    ndc_y = (py + u2) / torch.tensor(float(view.height), dtype=dtype,
                                     device=dev)
    sx = (2.0 * ndc_x - 1.0) * aspect * fov_scale
    syy = (1.0 - 2.0 * ndc_y) * fov_scale
    sz = torch.full_like(sx, -1.0)
    d = torch.stack([float(rot[k][0]) * sx + float(rot[k][1]) * syy
                     + float(rot[k][2]) * sz for k in range(3)], -1)
    d = _normalize(d)
    o = torch.tensor(np.asarray(view.position, f32), device=dev
                     ).to(dtype).expand_as(d).clone()
    return o, d, seed


def render_pixels(sc: Scene, view: View, pixel_ids: torch.Tensor,
                  times: torch.Tensor, max_rays: int = 1 << 22):
    """The canvas (P, 3) float64 of the row-major ``pixel_ids`` after one
    pass for each of ``times`` (int64, in [1, 2^32)), in blocks of whole
    passes of at most ``max_rays`` rays."""
    n_pix, s_count = pixel_ids.shape[0], view.num_samples
    per_block = max(1, max_rays // (n_pix * s_count))
    canvas = torch.zeros((n_pix, 3), dtype=torch.float64,
                         device=pixel_ids.device)
    for b in range(0, times.shape[0], per_block):
        tb = times[b:b + per_block]
        o, d, seed = primary_rays(view, pixel_ids, tb, sc.dtype)
        rad = trace(sc, o, d, seed, view.num_bounces)
        frame = rad.reshape(tb.shape[0], n_pix, s_count, 3).sum(2) \
            * (1.0 / s_count)
        canvas += frame.double().sum(0)
    return canvas
