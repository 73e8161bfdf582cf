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
    for some inputs; a 0-d tensor divisor keeps the true division.  The
    divisor is filled on the device: a copy from the host would wait for
    the device's queued work."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root.  PyTorch's AVX-512 CPU kernel
    is off by one ulp on about 0.6% of inputs; the f64 root rounded to f32
    is exact (f64 has more than 2 * 24 + 2 bits), as XLA's and CUDA's are."""
    return torch.sqrt(x.double()).float()


# fdlibm's float atan (s_atanf.c): atan(0.5), atan(1), atan(1.5) and
# atan(inf) split hi + lo, and the odd polynomial's coefficients
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_ATAN_T = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
           -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
           6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
           -3.6531571299e-02, 1.6285819933e-02)
_PI, _PI_LO, _PI_O_2 = 3.1415927410e+00, -8.7422776573e-08, 1.5707963705e+00


def _f32(c: float) -> float:
    return float(np.float32(c))


def _pick(index: torch.Tensor, values) -> torch.Tensor:
    """values[index] for index in [0, len(values)), as f32 constants."""
    out = torch.full(index.shape, _f32(values[-1]), dtype=torch.float32,
                     device=index.device)
    for i in range(len(values) - 2, -1, -1):
        out = torch.where(index == i, _f32(values[i]), out)
    return out


def _atan_abs(x: torch.Tensor) -> torch.Tensor:
    """atan(x) for x >= 0 (inf included), fdlibm's float form: reduce by
    the interval of x (0.4375, 0.6875, 1.1875, 2.4375), then the odd
    polynomial split in even and odd halves."""
    ix = x.view(torch.int32)
    idx = ((ix >= 0x3EE00000).int() + (ix >= 0x3F300000).int()
           + (ix >= 0x3F980000).int() + (ix >= 0x401C0000).int() - 1)
    r = torch.where(idx == 0, (2.0 * x - 1.0) / (2.0 + x),
                    torch.where(idx == 1, (x - 1.0) / (x + 1.0),
                                torch.where(idx == 2,
                                            (x - 1.5) / (1.0 + 1.5 * x),
                                            torch.where(idx == 3, -1.0 / x,
                                                        x))))
    t = [_f32(c) for c in _ATAN_T]
    z = r * r
    w = z * z
    s1 = z * (t[0] + w * (t[2] + w * (t[4] + w * (t[6] + w * (t[8]
                                                              + w * t[10])))))
    s2 = w * (t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * t[9]))))
    k = idx.clamp_min(0)
    big = _pick(k, _ATAN_HI) - ((r * (s1 + s2) - _pick(k, _ATAN_LO)) - r)
    out = torch.where(idx < 0, r - r * (s1 + s2), big)
    return torch.where(ix >= 0x4C000000, _f32(_ATAN_HI[3]) + _f32(_ATAN_LO[3]),
                       out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f32 atan2(y, x) for finite (or NaN) inputs as XLA:CPU computes it:
    it calls the C library's atan2f, which in glibc is fdlibm's float form
    (e_atan2f.c, s_atanf.c), about 1 ulp from the true value.  PyTorch's
    CPU and CUDA atan2 differ from it in the last bit on about 16% of
    unit-vector inputs, which moves an equirect texture tap by up to 1e-4
    of a texel; this form gives XLA:CPU's bits on both devices.  The C
    source's other early returns (x == 1, |y / x| beyond 2^60 either way)
    give the same bits as the general path for finite inputs, and a
    direction is never infinite, so only the zeros and NaN are kept."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)      # 2 * sign(x) + sign(y)
    z = _atan_abs(torch.abs(y / x))
    pi, pi_lo, half = _f32(_PI), _f32(_PI_LO), _f32(_PI_O_2)
    out = torch.where(m == 0, z, torch.where(
        m == 1, -z, torch.where(m == 2, pi - (z - pi_lo), (z - pi_lo) - pi)))
    # the C source's early returns, the first one winning
    out = torch.where((hx & 0x7FFFFFFF) == 0,
                      torch.where(hy < 0, -half, half), out)
    out = torch.where((hy & 0x7FFFFFFF) == 0,
                      torch.where(m < 2, y, torch.where(m == 2, pi, -pi)), out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


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
