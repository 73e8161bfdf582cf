"""Progressive-average tonemap: mean -> ACES -> gamma 2.0 -> u8.

The counterpart of ``simple_raytracer_tpu.ops.tonemap``.
"""
from __future__ import annotations

import torch

from .vec import div, sqrt


def aces(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic curve, clamped to [0, 1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (x * a + b)) / (x * (x * c + d) + e), 0.0, 1.0)


def tonemap_u8(canvas: torch.Tensor, num_steps: int) -> torch.Tensor:
    """(H, W, 3) f32 radiance sum and step count -> (H, W, 3) u8 RGB,
    truncating as a C cast does."""
    color = aces(div(canvas, num_steps))
    return (sqrt(color) * 255.0).to(torch.uint8)
