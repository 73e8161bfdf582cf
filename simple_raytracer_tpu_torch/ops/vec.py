"""Structure-of-arrays 3-vector math on torch tensors.

A ``Vec3`` is three 1-D float32 tensors, one per component, so every
operation is elementwise over the whole ray batch.  Each helper evaluates
its float operations in the same order as ``simple_raytracer_tpu.ops.vec``
(and as the CUDA kernel in ``csrc/trace_kernel.cu``), so the three agree
operation by operation.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

Scalar = Union[float, torch.Tensor]


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    @staticmethod
    def full(v) -> "Vec3":
        """A scalar or (x, y, z) triple as float32-rounded Python floats."""
        if isinstance(v, (tuple, list)):
            return Vec3(*(float(np.float32(c)) for c in v))
        c = float(np.float32(v))
        return Vec3(c, c, c)

    @staticmethod
    def from_array(a: torch.Tensor) -> "Vec3":
        """(..., 3) tensor -> Vec3 of (...,) components."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])


def dot(a: Vec3, b: Vec3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def length_squared(v: Vec3) -> torch.Tensor:
    return dot(v, v)


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b correctly rounded.  PyTorch's CUDA kernel turns a division by
    a Python scalar into a multiply by its reciprocal, which is an ulp off
    for some inputs; a 0-d tensor divisor keeps the true division."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  PyTorch's AVX-512 CPU kernel
    is off by one ulp on about 0.6% of inputs; the f64 root rounded to f32
    is exact (f64 has more than 2 * 24 + 2 bits), as XLA's and CUDA's are."""
    return torch.sqrt(x.double()).float()


def normalize(v: Vec3) -> Vec3:
    """v * (1 / |v|); the zero vector gives NaN, as in the reference."""
    return v * (1.0 / sqrt(dot(v, v)))


def where(mask: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                torch.where(mask, a.z, b.z))


def mix(a: Vec3, b: Vec3, t: Scalar) -> Vec3:
    """a + (b - a) * t."""
    return a + (b - a) * t


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """v - 2 dot(v, n) n."""
    return v - n * (2.0 * dot(v, n))


def sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign semantics: -1, +1, and the input itself for +-0 and NaN
    (``torch.sign`` maps NaN to 0 and -0 to +0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))
