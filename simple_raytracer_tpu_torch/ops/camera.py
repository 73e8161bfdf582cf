"""Camera rotation, primary ray generation and the ray-tile pixel order.

The counterpart of ``simple_raytracer_tpu.ops.camera``, with the same f32
expressions in the same order, so seeds match bit for bit and directions
to the last bits of the rotation.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .vec import Vec3, div, normalize


def camera_rotation(yaw: float, pitch: float) -> tuple:
    """RotY(yaw) @ RotX(pitch) as 9 row-major float32-rounded scalars."""
    f32 = np.float32
    cy, sy = np.cos(f32(yaw)), np.sin(f32(yaw))
    cp, sp = np.cos(f32(pitch)), np.sin(f32(pitch))
    rot = (cy, sy * sp, sy * cp,
           f32(0.0), cp, -sp,
           -sy, cy * sp, cy * cp)
    return tuple(float(f32(v)) for v in rot)


def rotate_vec(rot, v: Vec3) -> Vec3:
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = rot
    return Vec3(m00 * v.x + m01 * v.y + m02 * v.z,
                m10 * v.x + m11 * v.y + m12 * v.z,
                m20 * v.x + m21 * v.y + m22 * v.z)


def tiled_pixel_order(width: int, band_height: int, tile, device=None):
    """Row-major pixel indices of a (band_height, width) band enumerated
    tile by tile: all pixels of one (th, tw) tile are contiguous."""
    th, tw = tile
    if band_height % th or width % tw:
        raise ValueError(f"tile {tile} must divide band {band_height}x{width}")
    ids = torch.arange(band_height * width, dtype=torch.int64, device=device)
    ids = ids.reshape(band_height // th, th, width // tw, tw)
    return ids.permute(0, 2, 1, 3).reshape(-1)


def untile_pixels(values: torch.Tensor, width: int, band_height: int, tile):
    """Inverse of tiled_pixel_order for per-pixel (P,) values."""
    th, tw = tile
    v = values.reshape(band_height // th, width // tw, th, tw)
    return v.permute(0, 2, 1, 3).reshape(-1)


def untile_image(img: torch.Tensor, tile) -> torch.Tensor:
    """(H, W, C) image whose flat pixel order is tile-major -> row-major."""
    h, w, c = img.shape
    th, tw = tile
    v = img.reshape(h // th, w // tw, th, tw, c)
    return v.permute(0, 2, 1, 3, 4).reshape(h, w, c)


def tile_image(img: torch.Tensor, tile) -> torch.Tensor:
    """(H, W, C) row-major image -> tile-major flat pixel order: the
    inverse of untile_image."""
    h, w, c = img.shape
    th, tw = tile
    v = img.reshape(h // th, th, w // tw, tw, c)
    return v.permute(0, 2, 1, 3, 4).reshape(h, w, c)


def generate_rays(width: int, height: int, num_samples: int, time: int,
                  camera_pos, rot, aspect_ratio: float, fov_scale: float,
                  row0: int = 0, tile_height: int = None, tile=None,
                  device=None):
    """Jittered primary rays for the (tile_height * W * S,) ray grid.

    Ray i is local_pixel * S + sample; pixel ids (and so the RNG streams)
    are global, offset by ``row0`` rows; the NDC y divisor is the full
    image ``height``.  Returns (origin Vec3, direction Vec3, int64 seeds).
    """
    if tile_height is None:
        tile_height = height
    n_pix = width * tile_height
    if tile is not None:
        local = tiled_pixel_order(width, tile_height, tile, device)
    else:
        local = torch.arange(n_pix, dtype=torch.int64, device=device)
    pixel_id = local + row0 * width
    px = (pixel_id % width).to(torch.float32)
    py = (pixel_id // width).to(torch.float32)

    sample = torch.arange(num_samples, dtype=torch.int64, device=device)
    seed = rng.pixel_seed(sample[None, :], pixel_id[:, None], num_samples,
                          time).reshape(-1)
    px = px.repeat_interleave(num_samples)
    py = py.repeat_interleave(num_samples)

    seed, u1 = rng.next_uniform(seed)
    seed, u2 = rng.next_uniform(seed)
    ndc_x = div(px + u1, width)
    ndc_y = div(py + u2, height)
    sx = (2.0 * ndc_x - 1.0) * aspect_ratio * fov_scale
    sy = (1.0 - 2.0 * ndc_y) * fov_scale

    d = normalize(rotate_vec(rot, Vec3(sx, sy, torch.full_like(sx, -1.0))))
    n_rays = n_pix * num_samples
    o = Vec3(*(torch.full((n_rays,), c, dtype=torch.float32, device=device)
               for c in camera_pos))
    return o, d, seed
