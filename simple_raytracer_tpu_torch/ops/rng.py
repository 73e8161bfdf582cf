"""The reference's uint32 hash RNG, bit for bit, on int64 tensors.

Every draw maps ``seed -> (new_seed, value)`` over a whole batch, exactly
as ``simple_raytracer_tpu.ops.rng`` does:

  seed   = seed * 747796405 + 2891336453
  result = ((seed >> ((seed >> 28) + 4)) ^ seed) * 277803737
  result = (result >> 22) ^ result
  value  = f32(result) * 2^-32

PyTorch has no uint32 ``+`` or ``>>`` on the CPU, so seeds travel as int64
holding a value in [0, 2^32), masked after every operation that can carry
past bit 31.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .vec import Vec3, dot, normalize, sign, sqrt

MASK = 0xFFFFFFFF
_MUL = 747796405
_INC = 2891336453
_OUT = 277803737
_INV = 2.0 ** -32    # exact scale: f32(result) / f32(UINT_MAX) == this


def mul_u32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for values in [0, 2^32), split in 16-bit halves so
    no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _u32_to_f32(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest f32 of a uint32 through the exact hi/lo split the
    reference uses: ``hi * 65536`` and ``lo`` are exact, so the one
    addition is the one rounding."""
    hi = (x >> 16).to(torch.float32)
    lo = (x & 0xFFFF).to(torch.float32)
    return hi * 65536.0 + lo


def next_uniform(seed: torch.Tensor):
    """One draw: int64 seeds in [0, 2^32) -> (seed', f32 in [0, 1))."""
    seed = (seed * _MUL + _INC) & MASK
    shift = (seed >> 28) + 4
    result = (((seed >> shift) ^ seed) * _OUT) & MASK
    result = (result >> 22) ^ result
    return seed, _u32_to_f32(result) * _INV


# cos(2 pi y) Taylor coefficients in y^2, k = 7..0, evaluated in float64
# and rounded to f32 exactly as the reference builds them
COS2PI_C = [float(np.float32((-1.0) ** k * (2.0 * np.pi) ** (2 * k)
                             / float(math.factorial(2 * k))))
            for k in range(7, -1, -1)]


def cos_2pi(u: torch.Tensor) -> torch.Tensor:
    """cos(2 pi u) for u in turns: fold to a quarter period (exact) and
    evaluate the degree-14 polynomial, as the reference does."""
    w = u - torch.round(u)
    a = torch.abs(w)
    flip = a > 0.25
    y = torch.where(flip, 0.5 - a, a)
    y2 = y * y
    p = torch.full_like(y2, COS2PI_C[0])
    for c in COS2PI_C[1:]:
        p = p * y2 + c
    return torch.where(flip, -p, p)


def fma(a, b, c) -> torch.Tensor:
    """f32 fused multiply-add, a * b + c rounded once.  The f32 product is
    exact in f64, so only the f64 sum can round before the f32 rounding;
    that double rounding changes the result with probability about 2^-29
    per call."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else v
    return (f64(a) * f64(b) + f64(c)).float()


# f32 log as the reference evaluates it on the CPU: the Cephes polynomial
# (Eigen's plog) that XLA:CPU emits for jnp.log, with the fused
# multiply-adds its x86 code generator forms.  Using it instead of
# torch.log keeps next_normal bit-identical to the reference (torch.log
# differs from it by one ulp on about a seventh of inputs).
LOG_MIN_NORMAL = float.fromhex("0x1p-126")
LOG_SQRTHF = float.fromhex("0x1.6a09e6p-1")
LOG_P = [float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a370p-4", "0x1.de4a34p-4", "-0x1.fcba9ep-4",
    "0x1.23d37ep-3", "-0x1.555ca0p-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
    "0x1.555554p-2")]
LOG_Q1 = float.fromhex("-0x1.bd0106p-13")
LOG_Q2 = float.fromhex("0x1.630000p-1")


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of f32 values: -inf at 0 and for subnormals (XLA:CPU
    treats them as 0), NaN below 0 and for NaN."""
    xc = torch.where(x > LOG_MIN_NORMAL, x, LOG_MIN_NORMAL)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32)
    e = 1.0 + e
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)  # 0x807FFFFF
    low = m < LOG_SQRTHF
    e = e - torch.where(low, 1.0, 0.0)
    r = (m - 1.0) + torch.where(low, m, 0.0)
    r2 = r * r
    r3 = r2 * r
    p = LOG_P
    y = fma(r, p[0], p[1])
    y1 = fma(r, p[3], p[4])
    y2 = fma(r, p[6], p[7])
    y = fma(r, y, p[2])
    y1 = fma(r, y1, p[5])
    y2 = fma(r, y2, p[8])
    y = fma(r3, y, y1)
    y = fma(r3, y, y2)
    y = fma(r3, y, LOG_Q1 * e)
    out = fma(-0.5, r2, r) + y
    out = fma(LOG_Q2, e, out)
    out = torch.where((x >= 0.0) & (x < LOG_MIN_NORMAL), -math.inf, out)
    out = torch.where(x == math.inf, math.inf, out)
    return torch.where((x < 0.0) | torch.isnan(x), math.nan, out)


def next_normal(seed: torch.Tensor):
    """Box-Muller normal from 2 uniforms: sqrt(-2 ln u2) cos(2 pi u1).

    Deliberately kept hazard: the hash can return u2 == 0 exactly
    (1 in 2^32 draws); ln(0) = -inf then makes the sample infinite, as in
    the reference, so a large render can grow a few non-finite pixels.
    Fixing it here would break RNG-stream parity."""
    seed, u1 = next_uniform(seed)
    seed, u2 = next_uniform(seed)
    rho = sqrt(-2.0 * log(u2))
    return seed, rho * cos_2pi(u1)


def next_direction(seed: torch.Tensor):
    """Uniform sphere direction from 3 normals drawn x, y, z."""
    seed, nx = next_normal(seed)
    seed, ny = next_normal(seed)
    seed, nz = next_normal(seed)
    return seed, normalize(Vec3(nx, ny, nz))


def next_direction_hemisphere(normal: Vec3, seed: torch.Tensor):
    """dir * sign(dot(normal, dir)), with sign(0) == 0."""
    seed, d = next_direction(seed)
    return seed, d * sign(dot(normal, d))


def pixel_seed(sample, pixel_id: torch.Tensor, num_samples: int, time: int):
    """(sample + pixel_id * num_samples) * time * 5304 in wrapping uint32."""
    s = (sample + pixel_id * num_samples) & MASK
    return (mul_u32(s, int(time) & MASK) * 5304) & MASK
