"""The path-trace core: the masked bounce loop and the progressive pass.

``trace_rays`` is the bounce loop over the whole ray batch with an alive
mask, as ``simple_raytracer_tpu.ops.trace.trace_rays`` runs it:

  - emission is added on every hit;
  - the last bounce adds emission only, with no BSDF sample;
  - a miss records the throughput and direction for the environment,
    which is evaluated once after the loop (``add_sky``: the scene's
    texture, else the gradient sky), and the ray dies.

It comes in two forms.  With ``split=False`` it is the plain version of
the whole-trace kernel (``ops/cuda/trace_kernel.py``), whose nearest hit
(``intersect.closest_hit``) shades triangles at MT's (u, v).  With
``split=True`` it is the split per-bounce path: each bounce's nearest hit
is ``intersect.closest_hit_split``, which sends a clustered mesh through
the BVH kernel (``ops/cuda/bvh_kernel.py``), or under "pallas" every mesh
through the brute-force triangle kernel (``ops/cuda/triangle_kernel.py``)
and under "jnp" through the dense loop, and shades at the barycentric
weights of the hit position.  Its bounce 0 is peeled: dense unless the
TPU would stream the cluster table from HBM, while every later bounce
takes the ray compaction when the batch is large enough
(``bvh.compacts``), the policy of the JAX ``trace_rays``;
``SRT_BVH_COMPACT`` and ``SRT_BVH_COMPACT_CAP`` change it as they change
the JAX package's (``bvh.resolve_compact_cap``).

``trace_rays_fused`` is the fused per-bounce path (the JAX
``trace_rays_fused``): the (20, Rp) ray state of ``ops/bounce.py``, and
per bounce the nearest sphere and plane as the BVH's far bound, the BVH
kernel, and the per-bounce shade kernel (``ops/cuda/bounce_kernel.py``);
the environment once at the end.

A first-hit AOV (``aov`` "normals", "depth" or "albedo", the JAX
``show_normals`` modes) traces one segment: the hit's normal as
n * 0.5 + 0.5, its depth as 1 / (1 + t) in grey (a miss exactly 0, its
sky suppressed) or its material's colour; a miss keeps the sky, but for
depth.

``render_pass`` traces one progressive pass and adds its per-pixel sample
mean to the canvas, routed as the JAX ``render_pass`` routes on the TPU:

  - an AOV pass always takes the split ``trace_rays``, as JAX's
    ``use_mega`` and ``_fused_ok`` decline it: a clustered mesh launches
    the BVH kernel;
  - a scene inside the whole-trace kernel's envelope (under "auto" or
    "fused"; "fused" widens it to config 6's packed table) takes that
    kernel, its plain version on the CPU;
  - else ``trace_per_bounce``: under "fused" a clustered mesh
    (``fused_ok``) takes ``trace_rays_fused``: config 7;
  - every other scene takes the split ``trace_rays``: configs 6 and 7
    under "auto", every scene under "bvh", "clustered" (which forces the
    BVH kernel's streamed variant), "jnp" and "pallas".
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from . import bvh
from .bounce import bounce_step, make_state, unpack_state
from .bsdf import gather_materials, sample_material
from .camera import camera_rotation, generate_rays, untile_pixels
from .cuda import bvh_kernel
from .intersect import _spheres_planes, closest_hit, closest_hit_split
from .scene_types import DeviceScene, prim_tables, whole_trace_variant
from .sky import sky_color
from .vec import Vec3, where as vwhere
from ..utils import metrics
from ..utils.metrics import span


class CameraState(NamedTuple):
    """Camera parameters of one pass, float32-rounded host scalars."""
    position: tuple
    yaw: float
    pitch: float
    aspect_ratio: float
    fov_scale: float


# the triangle backends of the JAX RenderOptions
TRI_BACKENDS = ("auto", "bvh", "clustered", "fused", "jnp", "pallas")
# the first-hit AOV modes (None: the path-traced image)
AOVS = ("normals", "depth", "albedo")


def check_tri_backend(tri_backend: str) -> None:
    if tri_backend not in TRI_BACKENDS:
        raise ValueError(f"unknown tri_backend {tri_backend!r}")


def check_aov(aov) -> None:
    if aov is not None and aov not in AOVS:
        raise ValueError(f"unknown aov {aov!r} "
                         "(None | 'normals' | 'depth' | 'albedo')")


def add_sky(scene: DeviceScene, color: Vec3, sky_mask: Vec3,
            sky_dir: Vec3) -> Vec3:
    """The per-ray radiance from a trace's rows: the emission gathered,
    plus the throughput at the miss times the environment along the miss
    direction (``sky.sky_color``: the scene's texture, else the gradient
    sky), evaluated once for every ray."""
    with span("srt.sky"):
        return color + sky_mask * sky_color(sky_dir, scene.sky, scene.skybox)


def trace_rays(scene: DeviceScene, o: Vec3, d: Vec3, seed: torch.Tensor,
               num_bounces: int, segments: Optional[list] = None,
               split: bool = False, tri_backend: str = "auto",
               aov: Optional[str] = None) -> Vec3:
    """Trace the (R,) ray batch to completion; returns per-ray radiance
    (``trace_rays_rows``, then ``add_sky``)."""
    return add_sky(scene, *trace_rays_rows(scene, o, d, seed, num_bounces,
                                           segments, split, tri_backend,
                                           aov))


def first_hit_aov(scene: DeviceScene, aov: str, hit, h_alive: torch.Tensor,
                  m_alive: torch.Tensor, color: Vec3, sky_mask: Vec3):
    """(color, sky_mask) of a first-hit AOV segment: the hit rays' value
    (the normal as n * 0.5 + 0.5, the depth as 1 / (1 + t) in grey, the
    material's colour); "depth" also zeroes the misses' sky mask, so a
    miss is exactly 0."""
    if aov == "normals":
        val = hit.normal * 0.5 + 0.5
    elif aov == "depth":
        g = torch.ones_like(hit.t) / (1.0 + hit.t)
        val = Vec3(g, g, g)
        z = torch.zeros_like(hit.t)
        sky_mask = vwhere(m_alive, Vec3(z, z, z), sky_mask)
    else:
        val = gather_materials(scene.materials, hit.material).color
    return vwhere(h_alive, val, color), sky_mask


def trace_rays_rows(scene: DeviceScene, o: Vec3, d: Vec3,
                    seed: torch.Tensor, num_bounces: int,
                    segments: Optional[list] = None, split: bool = False,
                    tri_backend: str = "auto", aov: Optional[str] = None):
    """Trace the (R,) ray batch to completion, without the environment:
    (color, sky_mask, sky_dir), the emission gathered and the throughput
    and direction at each ray's miss ((0, 0, 0) and (0, 0, 1) for a ray
    that never misses), the whole-trace kernel's nine rows.

    ``segments``, when given, receives one (live rays, rays that hit,
    rays whose nearest hit is a triangle) triple per bounce: the work the
    kernel does, which depends on the data.  ``split`` selects the split
    per-bounce path's nearest hit and its compaction policy, where
    ``tri_backend`` picks the triangle route (``closest_hit_split``); the
    split path feeds the counters ``trace.rays`` (R rays a bounce) and
    ``trace.live`` while they are on.  Without ``split`` this is the
    whole-trace kernel's plain version, which counts nothing, as the
    kernel does not.
    ``aov`` traces the first segment only and records that AOV
    (``first_hit_aov``)."""
    zeros = torch.zeros_like(o.x)
    ones = torch.ones_like(o.x)
    color = Vec3(zeros, zeros, zeros)
    mask = Vec3(ones, ones, ones)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    sky_mask = Vec3(zeros, zeros, zeros)
    sky_dir = Vec3(zeros, zeros, ones)

    n = o.x.shape[0]
    bounces = 1 if aov is not None else num_bounces
    if split:
        metrics.count("trace.rays", n * bounces)
    counted = split and metrics.counting()
    compact_first, compact_later = split_compacts(n, scene.triangles.clusters)
    for i in range(bounces):
        with span("srt.bounce", i):
            if split:
                # srt.nearest_prims, srt.bvh and the resolve's srt.shade
                hit = closest_hit_split(
                    scene, o, d, alive,
                    compact=compact_first if i == 0 else compact_later,
                    tri_backend=tri_backend)
            else:
                hit = closest_hit(scene, o, d)
            with span("srt.shade"):
                h_alive = alive & hit.hit
                if segments is not None:
                    segments.append((int(alive.sum()), int(h_alive.sum()),
                                     int((h_alive & hit.triangle).sum())))
                if counted:
                    metrics.count("trace.live", alive.sum())
                m_alive = alive & ~hit.hit
                sky_mask = vwhere(m_alive, mask, sky_mask)
                sky_dir = vwhere(m_alive, d, sky_dir)
                if aov is not None:
                    color, sky_mask = first_hit_aov(scene, aov, hit, h_alive,
                                                    m_alive, color, sky_mask)
                    break

                mat = gather_materials(scene.materials, hit.material)
                emission = mask * mat.emission * mat.emission_strength
                color = vwhere(h_alive, color + emission, color)
                if i == num_bounces - 1:
                    break
                alive = h_alive
                ms = sample_material(hit.position, hit.normal, hit.front, d,
                                     mat, seed)
                o = vwhere(alive, ms.origin, o)
                d = vwhere(alive, ms.direction, d)
                mask = vwhere(alive, mask * ms.mask_mul, mask)
                seed = torch.where(alive, ms.seed, seed)

    return color, sky_mask, sky_dir


def split_compacts(n_rays: int, clusters) -> tuple:
    """(bounce 0, every later bounce): does the split path compact a bounce
    of ``n_rays`` rays?  The JAX ``trace_rays``' policy: bounce 0 is peeled
    dense unless the TPU streams the table from HBM, every later bounce
    asks "auto"; SRT_BVH_COMPACT overrides both and SRT_BVH_COMPACT_CAP
    sizes "auto" (``bvh.resolve_compact_cap``)."""
    first = "auto" if bvh.table_streams_hbm(clusters) else None
    return bvh.compacts(n_rays, first), bvh.compacts(n_rays, "auto")


def fused_compacts(n_rays: int) -> bool:
    """Does the fused path compact its bounces of ``n_rays`` rays?  The JAX
    ``trace_rays_fused`` asks ``resolve_compact_cap(n, None)`` at every
    bounce: no compaction unless SRT_BVH_COMPACT asks for it.  With neither
    SRT_BVH_COMPACT nor SRT_BVH_COMPACT_CAP set the port keeps its own
    default, "auto" on every bounce, bounce 0 included, the form this path
    has taken since it was ported (compaction changes no result); under
    either knob it decides as the JAX package does."""
    knob = ("SRT_BVH_COMPACT" in os.environ
            or bool(os.environ.get("SRT_BVH_COMPACT_CAP")))
    return bvh.compacts(n_rays, None if knob else "auto")


def trace_rays_fused(scene: DeviceScene, o: Vec3, d: Vec3,
                     seed: torch.Tensor, num_bounces: int) -> Vec3:
    """``trace_rays`` with each bounce's body in one launch of the
    per-bounce shade kernel (its plain version on the CPU), over the
    (20, Rp) ray state.  Per bounce: the nearest sphere and plane seed the
    BVH's far bound, the BVH kernel gives each live ray's nearest triangle
    (compacted as ``fused_compacts`` decides, which changes no live ray's
    result), and ``bounce_step`` shades, samples and
    advances every ray; the environment once after the last bounce.  It
    makes the split ``trace_rays``'s float operations in the same order,
    so it gives the same radiance.  While the counters are on it adds Rp
    rays a bounce to ``trace.rays`` and the state's live rays to
    ``trace.live``."""
    n = o.x.shape[0]
    with span("srt.rays"):
        state = make_state(o, d, seed)
    tables = prim_tables(scene)
    tr = scene.triangles
    compact = fused_compacts(n)
    metrics.count("trace.rays", state.shape[1] * num_bounces)
    counted = metrics.counting()
    for i in range(num_bounces):
        with span("srt.bounce", i):
            if counted:
                metrics.count("trace.live", (state[7] > 0.0).sum())
            tri = None
            if tr.material.shape[0] > 0:
                ro = Vec3(state[0], state[1], state[2])
                rd = Vec3(state[3], state[4], state[5])
                with span("srt.nearest_prims"):
                    t_s, _, t_p, _ = _spheres_planes(scene, ro, rd)
                with span("srt.bvh"):
                    tri = bvh_kernel.intersect_triangles_bvh(
                        ro, rd, state[7], torch.minimum(t_s, t_p),
                        tr.clusters, tr.table, compact=compact)
            with span("srt.shade"):
                state = bounce_step(state, i == num_bounces - 1, scene, tri,
                                    tables)
    return add_sky(scene, *unpack_state(state, n))


def takes_whole_trace(scene: DeviceScene, tri_backend: str = "auto") -> bool:
    """Does render_pass trace this scene with the whole-trace kernel (or
    its plain version), rather than a per-bounce path?"""
    check_tri_backend(tri_backend)
    return (tri_backend in ("auto", "fused")
            and whole_trace_variant(scene, tri_backend) is not None)


def fused_ok(scene: DeviceScene, tri_backend: str) -> bool:
    """Does a scene outside the whole-trace envelope take the fused
    per-bounce path?  The JAX ``_fused_ok`` on the TPU, asked only of
    such scenes (``takes_whole_trace`` is false): under "fused" a
    clustered mesh does (a mid-size mesh without clusters takes the split
    path's dense loop; a scene without triangles never gets here).  Under
    "auto" it declines every scene that reaches it."""
    return tri_backend == "fused" and scene.triangles.clusters is not None


def trace_per_bounce(scene: DeviceScene, o: Vec3, d: Vec3,
                     seed: torch.Tensor, num_bounces: int,
                     tri_backend: str = "auto",
                     aov: Optional[str] = None) -> Vec3:
    """The per-ray radiance of a scene outside the whole-trace envelope,
    or of any AOV pass: ``trace_rays_fused`` where ``fused_ok`` allows it
    (never for an AOV), else the split ``trace_rays``."""
    if aov is None and fused_ok(scene, tri_backend):
        return trace_rays_fused(scene, o, d, seed, num_bounces)
    return trace_rays(scene, o, d, seed, num_bounces, split=True,
                      tri_backend=tri_backend, aov=aov)


def render_pass(scene: DeviceScene, camera: CameraState, canvas: torch.Tensor,
                time: int, *, width: int, height: int, num_samples: int,
                num_bounces: int, ray_tile=None, row0: int = 0,
                tile_height: int = None, canvas_tiled: bool = False,
                tri_backend: str = "auto",
                aov: Optional[str] = None) -> torch.Tensor:
    """One progressive pass: trace S jittered samples per pixel and add the
    per-pixel mean to the (tile_height, W, 3) canvas.  A scene inside the
    whole-trace kernel's envelope (under ``tri_backend`` "auto" or
    "fused") is one launch of that kernel on a CUDA device and its plain
    version on the CPU; any other scene, and any ``aov`` pass, takes a
    per-bounce path (the module's docstring gives the rule), whose
    clustered meshes launch the BVH kernel on a CUDA device.

    ``canvas_tiled=True`` keeps the canvas in the ray-tile pixel order (the
    engine's convention: tonemapping is per pixel, so the untile waits
    until an image is fetched)."""
    from .cuda.trace_kernel import trace_full

    if tile_height is None:
        tile_height = height
    rot = camera_rotation(camera.yaw, camera.pitch)
    if aov is None and takes_whole_trace(scene, tri_backend):
        with span("srt.whole_trace"):
            color = trace_full(
                scene, rot, camera.position, camera.aspect_ratio,
                camera.fov_scale, time, width=width, height=height,
                num_samples=num_samples, num_bounces=num_bounces, row0=row0,
                tile_height=tile_height, ray_tile=ray_tile,
                tri_backend=tri_backend)
    else:
        with span("srt.rays"):
            o, d, seed = generate_rays(width, height, num_samples, time,
                                       camera.position, rot,
                                       camera.aspect_ratio, camera.fov_scale,
                                       row0=row0, tile_height=tile_height,
                                       tile=ray_tile, device=scene.device)
        color = trace_per_bounce(scene, o, d, seed, num_bounces,
                                 tri_backend, aov)

    inv_s = 1.0 / num_samples

    def per_pixel(c):
        p = c.reshape(tile_height * width, num_samples).sum(dim=1) * inv_s
        if ray_tile is not None and not canvas_tiled:
            p = untile_pixels(p, width, tile_height, ray_tile)
        return p

    with span("srt.accumulate"):
        frame = torch.stack([per_pixel(color.x), per_pixel(color.y),
                             per_pixel(color.z)], dim=-1)
        return canvas + frame.reshape(tile_height, width, 3)
