"""The environment: the analytic gradient sky, or an equirect texture.

The counterpart of ``simple_raytracer_tpu.ops.sky``.  ``sky_color`` is
the radiance along a miss direction: ``sky_gradient`` (a three-color
gradient plus a sun masked below the horizon) when the scene has no
skybox, else the texture's bilinear sample plus the unmasked sun (the
reference's ``sky_box``, render.cl:380-394):

  u = atan2(z, x) / pi * 0.5 + 0.5
  v = y * 0.5 + 0.5                 (linear in y, not asin)

The texture is an (H, W, 3) f32 tensor on the scene's device, row 0 the
bottom of the environment, sampled as OpenCL's normalized-coordinate
CL_FILTER_LINEAR / CL_ADDRESS_CLAMP_TO_EDGE sampler: four taps gathered
and mixed in software, in f32, in the operation order of the JAX
``sample_equirect_gather``.  The TPU's other samplers (the two-hot MXU
matmul, the quad-packed rgb8/rgbe layout) are gather work-arounds that
give the same function up to rounding and are not ported.  A texture is
never sampled with a GPU's hardware filter, whose 8-bit fixed-point
weights cannot match these f32 taps.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .scene_types import SkyParams
from .vec import Vec3, atan2, div, dot, mix

_INV_PI = float(np.float32(1.0 / 3.14159274101257324))


def _smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(div(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sky_gradient(d: Vec3, sky: SkyParams) -> Vec3:
    """t = smoothstep(0, 0.4, y)^0.35; sky = mix(horizon, zenith, t);
    g2s = smoothstep(-0.01, 0, y); mix(ground, sky, g2s) + sun, the sun
    shown only where g2s >= 1."""
    t = torch.pow(_smoothstep(0.0, 0.4, d.y), 0.35)
    grad = mix(sky.horizon_color, sky.zenith_color, t)
    g2s = _smoothstep(-0.01, 0.0, d.y)
    sun_cos = torch.clamp_min(dot(d, -sky.sun_direction), 0.0)
    sun_term = (torch.pow(sun_cos, sky.sun_focus) * sky.sun_intensity
                * (g2s >= 1.0).to(torch.float32))
    return mix(sky.ground_color, grad, g2s) + sky.sun_color * sun_term


def equirect_uv(d: Vec3):
    """The texture coordinates of direction d: u from the azimuth (with
    XLA:CPU's atan2, ``vec.atan2``), v linear in y."""
    u = atan2(d.z, d.x) * _INV_PI * 0.5 + 0.5
    v = d.y * 0.5 + 0.5
    return u, v


def _taps(h: int, w: int, u: torch.Tensor, v: torch.Tensor):
    """The sampler's set-up: sample centers at (u W - 0.5, v H - 0.5), the
    integer taps clamped to the edge, and the fractional weights."""
    fx = u * float(w) - 0.5
    fy = v * float(h) - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = fx - x0
    ay = fy - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    return (x0i.clamp(0, w - 1), (x0i + 1).clamp(0, w - 1),
            y0i.clamp(0, h - 1), (y0i + 1).clamp(0, h - 1), ax, ay)


def sample_equirect(skybox: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor) -> Vec3:
    """Bilinear clamp-to-edge sample of the (H, W, 3) texture at (R,)
    normalized (u, v): the top row's taps mixed in x, the bottom row's,
    then the two in y."""
    h, w = skybox.shape[:2]
    x0, x1, y0, y1, ax, ay = _taps(h, w, u, v)
    rows = skybox.reshape(h * w, 3)

    def tap(yi, xi):
        t = rows[yi * w + xi]
        return Vec3(t[:, 0], t[:, 1], t[:, 2])

    top = tap(y0, x0) * (1.0 - ax) + tap(y0, x1) * ax
    bot = tap(y1, x0) * (1.0 - ax) + tap(y1, x1) * ax
    return top * (1.0 - ay) + bot * ay


def sky_color(d: Vec3, sky: SkyParams,
              skybox: Optional[torch.Tensor]) -> Vec3:
    """The environment's radiance along unit miss directions d: the
    gradient sky without a texture, else the texture's sample plus the
    sun, unmasked."""
    if skybox is None:
        return sky_gradient(d, sky)
    sun_cos = torch.clamp_min(dot(d, -sky.sun_direction), 0.0)
    sun = sky.sun_color * (torch.pow(sun_cos, sky.sun_focus)
                           * sky.sun_intensity)
    u, v = equirect_uv(d)
    return sample_equirect(skybox, u, v) + sun
