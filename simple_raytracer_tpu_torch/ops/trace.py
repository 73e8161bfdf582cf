"""The path-trace core: the masked bounce loop and the progressive pass.

``trace_rays`` is the plain PyTorch version of the whole-trace kernel
(``ops/cuda/trace_kernel.py``): the same bounce loop over the whole ray
batch with an alive mask, as ``simple_raytracer_tpu.ops.trace.trace_rays``
runs it:

  - emission is added on every hit;
  - the last bounce adds emission only, with no BSDF sample;
  - a miss records the throughput and direction for the sky, which is
    evaluated once after the loop, and the ray dies.

``render_pass`` traces one progressive pass and adds its per-pixel sample
mean to the canvas.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .bsdf import gather_materials, sample_material
from .camera import camera_rotation, untile_pixels
from .intersect import closest_hit
from .scene_types import DeviceScene
from .sky import sky_gradient
from .vec import Vec3, where as vwhere


class CameraState(NamedTuple):
    """Camera parameters of one pass, float32-rounded host scalars."""
    position: tuple
    yaw: float
    pitch: float
    aspect_ratio: float
    fov_scale: float


def trace_rays(scene: DeviceScene, o: Vec3, d: Vec3, seed: torch.Tensor,
               num_bounces: int, segments: Optional[list] = None) -> Vec3:
    """Trace the (R,) ray batch to completion; returns per-ray radiance.

    ``segments``, when given, receives one (live rays, rays that hit,
    rays whose nearest hit is a triangle) triple per bounce: the work the
    kernel does, which depends on the data."""
    zeros = torch.zeros_like(o.x)
    ones = torch.ones_like(o.x)
    color = Vec3(zeros, zeros, zeros)
    mask = Vec3(ones, ones, ones)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    sky_mask = Vec3(zeros, zeros, zeros)
    sky_dir = Vec3(zeros, zeros, ones)

    for i in range(num_bounces):
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


def render_pass(scene: DeviceScene, camera: CameraState, canvas: torch.Tensor,
                time: int, *, width: int, height: int, num_samples: int,
                num_bounces: int, ray_tile=None, row0: int = 0,
                tile_height: int = None,
                canvas_tiled: bool = False) -> torch.Tensor:
    """One progressive pass: trace S jittered samples per pixel and add the
    per-pixel mean to the (tile_height, W, 3) canvas.  On a CUDA device
    the whole trace is one launch of the hand-written kernel; on the CPU
    it is the plain version.

    ``canvas_tiled=True`` keeps the canvas in the ray-tile pixel order (the
    engine's convention: tonemapping is per pixel, so the untile waits
    until an image is fetched)."""
    from .cuda.trace_kernel import trace_full

    if tile_height is None:
        tile_height = height
    color = trace_full(
        scene, camera_rotation(camera.yaw, camera.pitch), camera.position,
        camera.aspect_ratio, camera.fov_scale, time, width=width,
        height=height, num_samples=num_samples, num_bounces=num_bounces,
        row0=row0, tile_height=tile_height, ray_tile=ray_tile)

    inv_s = 1.0 / num_samples

    def per_pixel(c):
        p = c.reshape(tile_height * width, num_samples).sum(dim=1) * inv_s
        if ray_tile is not None and not canvas_tiled:
            p = untile_pixels(p, width, tile_height, ray_tile)
        return p

    frame = torch.stack([per_pixel(color.x), per_pixel(color.y),
                         per_pixel(color.z)], dim=-1)
    return canvas + frame.reshape(tile_height, width, 3)
