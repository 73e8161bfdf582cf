"""The reference application's uint32 hash RNG (render.cl:143-163).

Seeds travel as int64 tensors holding a value in [0, 2^32): every
product below stays under 2^63, so plain int64 arithmetic and a mask
after each step give the wrapping uint32 result.

  seed   = seed * 747796405 + 2891336453
  result = ((seed >> ((seed >> 28) + 4)) ^ seed) * 277803737
  result = (result >> 22) ^ result
  value  = f32(result) / f32(0xFFFFFFFF)        (f32(0xFFFFFFFF) == 2^32)

The normals are Box-Muller: sqrt(-2 ln u2) cos(2 pi u1), evaluated in
float64 and rounded once to the working dtype.  A draw of u2 == 0 gives
an infinite normal and so a NaN direction, as in the reference.
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF


def pixel_seed(sample: torch.Tensor, pixel_id: torch.Tensor,
               num_samples: int, time: torch.Tensor) -> torch.Tensor:
    """(sample + pixel_id * num_samples) * time * 5304 in wrapping uint32
    (render.cl:494); ``time`` is a per-ray int64 tensor in [1, 2^32)."""
    s = (sample + pixel_id * num_samples) & MASK
    return (((s * time) & MASK) * 5304) & MASK


def next_uniform(seed: torch.Tensor, dtype=torch.float32):
    """One draw: (seed', value in [0, 1] in ``dtype``)."""
    seed = (seed * 747796405 + 2891336453) & MASK
    result = (((seed >> ((seed >> 28) + 4)) ^ seed) * 277803737) & MASK
    result = (result >> 22) ^ result
    value = result.to(torch.float32) * 2.0 ** -32
    return seed, value.to(dtype)


def next_normal(seed: torch.Tensor, dtype=torch.float32):
    seed, u1 = next_uniform(seed, dtype)
    seed, u2 = next_uniform(seed, dtype)
    u1, u2 = u1.double(), u2.double()
    rho = torch.sqrt(-2.0 * torch.log(u2))
    return seed, (rho * torch.cos(2.0 * math.pi * u1)).to(dtype)


def sign(x: torch.Tensor) -> torch.Tensor:
    """-1 or +1, and x itself for +-0 and NaN (the reference's sign)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x)).to(x.dtype)


def next_direction(seed: torch.Tensor, dtype=torch.float32):
    """A uniform direction on the sphere from three normals, x, y, z."""
    seed, x = next_normal(seed, dtype)
    seed, y = next_normal(seed, dtype)
    seed, z = next_normal(seed, dtype)
    v = torch.stack([x, y, z], dim=-1)
    return seed, v / torch.sqrt((v * v).sum(-1, keepdim=True))


def next_hemisphere(normal: torch.Tensor, seed: torch.Tensor,
                    dtype=torch.float32):
    """A direction of the hemisphere around ``normal``: d * sign(n . d)."""
    seed, d = next_direction(seed, dtype)
    return seed, d * sign((normal * d).sum(-1, keepdim=True))
