"""The path-trace core: the masked bounce loop and the progressive pass.

``trace_rays`` is the bounce loop over the whole ray batch with an alive
mask, as ``simple_raytracer_tpu.ops.trace.trace_rays`` runs it:

  - emission is added on every hit;
  - the last bounce adds emission only, with no BSDF sample;
  - a miss records the throughput and direction for the sky, which is
    evaluated once after the loop, and the ray dies.

It comes in two forms.  With ``split=False`` it is the plain version of
the whole-trace kernel (``ops/cuda/trace_kernel.py``), whose nearest hit
(``intersect.closest_hit``) shades triangles at MT's (u, v).  With
``split=True`` it is the split per-bounce path: each bounce's nearest hit
is ``intersect.closest_hit_split``, which sends a clustered mesh through
the BVH kernel (``ops/cuda/bvh_kernel.py``) and shades at the barycentric
weights of the hit position.  Its bounce 0 is peeled: dense unless the
TPU would stream the cluster table from HBM, while every later bounce
takes the ray compaction when the batch is large enough
(``bvh.compacts``), the policy of the JAX ``trace_rays``.

``render_pass`` traces one progressive pass and adds its per-pixel sample
mean to the canvas.  A scene inside the whole-trace kernel's envelope,
under ``tri_backend="auto"``, takes that kernel (its plain version on the
CPU); every other scene, and every scene under ``tri_backend="bvh"``,
takes ``generate_rays`` and the split ``trace_rays``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import bvh
from .bsdf import gather_materials, sample_material
from .camera import camera_rotation, generate_rays, untile_pixels
from .intersect import closest_hit, closest_hit_split
from .scene_types import DeviceScene, whole_trace_variant
from .sky import sky_gradient
from .vec import Vec3, where as vwhere


class CameraState(NamedTuple):
    """Camera parameters of one pass, float32-rounded host scalars."""
    position: tuple
    yaw: float
    pitch: float
    aspect_ratio: float
    fov_scale: float


# the triangle backends of the JAX RenderOptions; the port runs "auto"
# and "bvh", the others raise naming the ROADMAP item that ports them
TRI_BACKENDS_TO_PORT = {
    "jnp": "ROADMAP Queue A 5 (the dense triangle route for clustered "
           "meshes)",
    "pallas": "ROADMAP Queue B 6 (triangle_kernel._kernel)",
    "clustered": "ROADMAP Queue B 2 (bvh_kernel._kernel_hbm)",
    "fused": "ROADMAP Queue B 4 and 5 (_bounce_kernel, the packed "
             "in-kernel traversal)",
}


def check_tri_backend(tri_backend: str) -> None:
    if tri_backend in ("auto", "bvh"):
        return
    if tri_backend in TRI_BACKENDS_TO_PORT:
        raise NotImplementedError(
            f"tri_backend={tri_backend!r} is not ported yet: "
            + TRI_BACKENDS_TO_PORT[tri_backend])
    raise ValueError(f"unknown tri_backend {tri_backend!r}")


def trace_rays(scene: DeviceScene, o: Vec3, d: Vec3, seed: torch.Tensor,
               num_bounces: int, segments: Optional[list] = None,
               split: bool = False) -> Vec3:
    """Trace the (R,) ray batch to completion; returns per-ray radiance.

    ``segments``, when given, receives one (live rays, rays that hit,
    rays whose nearest hit is a triangle) triple per bounce: the work the
    kernel does, which depends on the data.  ``split`` selects the split
    per-bounce path's nearest hit and its compaction policy."""
    zeros = torch.zeros_like(o.x)
    ones = torch.ones_like(o.x)
    color = Vec3(zeros, zeros, zeros)
    mask = Vec3(ones, ones, ones)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    sky_mask = Vec3(zeros, zeros, zeros)
    sky_dir = Vec3(zeros, zeros, ones)

    # bounce 0 is dense unless the TPU streams the table (trace.py's peel)
    compact_later = bvh.compacts(o.x.shape[0])
    compact_first = compact_later and bvh.table_streams_hbm(
        scene.triangles.clusters)
    for i in range(num_bounces):
        if split:
            hit = closest_hit_split(
                scene, o, d, alive,
                compact=compact_first if i == 0 else compact_later)
        else:
            hit = closest_hit(scene, o, d)
        h_alive = alive & hit.hit
        if segments is not None:
            segments.append((int(alive.sum()), int(h_alive.sum()),
                             int((h_alive & hit.triangle).sum())))
        m_alive = alive & ~hit.hit
        sky_mask = vwhere(m_alive, mask, sky_mask)
        sky_dir = vwhere(m_alive, d, sky_dir)

        mat = gather_materials(scene.materials, hit.material)
        emission = mask * mat.emission * mat.emission_strength
        color = vwhere(h_alive, color + emission, color)
        if i == num_bounces - 1:
            break
        alive = h_alive
        ms = sample_material(hit.position, hit.normal, hit.front, d, mat, seed)
        o = vwhere(alive, ms.origin, o)
        d = vwhere(alive, ms.direction, d)
        mask = vwhere(alive, mask * ms.mask_mul, mask)
        seed = torch.where(alive, ms.seed, seed)

    return color + sky_mask * sky_gradient(sky_dir, scene.sky)


def takes_whole_trace(scene: DeviceScene, tri_backend: str = "auto") -> bool:
    """Does render_pass trace this scene with the whole-trace kernel (or
    its plain version), rather than the split per-bounce path?"""
    check_tri_backend(tri_backend)
    return tri_backend == "auto" and whole_trace_variant(scene) is not None


def render_pass(scene: DeviceScene, camera: CameraState, canvas: torch.Tensor,
                time: int, *, width: int, height: int, num_samples: int,
                num_bounces: int, ray_tile=None, row0: int = 0,
                tile_height: int = None, canvas_tiled: bool = False,
                tri_backend: str = "auto") -> torch.Tensor:
    """One progressive pass: trace S jittered samples per pixel and add the
    per-pixel mean to the (tile_height, W, 3) canvas.  A scene inside the
    whole-trace kernel's envelope (under ``tri_backend="auto"``) is one
    launch of that kernel on a CUDA device and its plain version on the
    CPU; any other scene takes the split per-bounce path, whose clustered
    meshes launch the BVH kernel on a CUDA device.

    ``canvas_tiled=True`` keeps the canvas in the ray-tile pixel order (the
    engine's convention: tonemapping is per pixel, so the untile waits
    until an image is fetched)."""
    from .cuda.trace_kernel import trace_full

    if tile_height is None:
        tile_height = height
    rot = camera_rotation(camera.yaw, camera.pitch)
    if takes_whole_trace(scene, tri_backend):
        color = trace_full(
            scene, rot, camera.position, camera.aspect_ratio,
            camera.fov_scale, time, width=width, height=height,
            num_samples=num_samples, num_bounces=num_bounces, row0=row0,
            tile_height=tile_height, ray_tile=ray_tile)
    else:
        o, d, seed = generate_rays(width, height, num_samples, time,
                                   camera.position, rot,
                                   camera.aspect_ratio, camera.fov_scale,
                                   row0=row0, tile_height=tile_height,
                                   tile=ray_tile, device=scene.device)
        color = trace_rays(scene, o, d, seed, num_bounces, split=True)

    inv_s = 1.0 / num_samples

    def per_pixel(c):
        p = c.reshape(tile_height * width, num_samples).sum(dim=1) * inv_s
        if ray_tile is not None and not canvas_tiled:
            p = untile_pixels(p, width, tile_height, ray_tile)
        return p

    frame = torch.stack([per_pixel(color.x), per_pixel(color.y),
                         per_pixel(color.z)], dim=-1)
    return canvas + frame.reshape(tile_height, width, 3)
