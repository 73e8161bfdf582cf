"""The analytic gradient environment.

The counterpart of ``simple_raytracer_tpu.ops.sky.sky_gradient`` (the
case of ``sky_color`` without a skybox): a three-color gradient (horizon,
zenith, ground) plus a sun masked below the horizon.  The equirect
texture skybox is a later slice.
"""
from __future__ import annotations

import torch

from .scene_types import SkyParams
from .vec import Vec3, div, dot, mix


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
