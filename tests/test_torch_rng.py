"""The port's RNG against simple_raytracer_tpu.ops.rng: bit for bit.

Both sides run elementwise op by op (JAX eagerly on the CPU), so every
draw, log, cosine and seed must be identical, not merely close.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from simple_raytracer_tpu.ops import rng as jrng
from simple_raytracer_tpu_torch.ops import rng as trng
from simple_raytracer_tpu_torch.ops.cuda import trace_kernel

from torch_port_helpers import jvec, seeds, to_np, tvec, unit_vectors

N = 1 << 20   # >= 1M seeds per stream


def _t(seed_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(seed_u32.astype(np.int64))


def test_next_uniform_bit_exact():
    s = seeds(np.random.default_rng(0), N)
    js, ju = jrng.next_uniform(jnp.asarray(s))
    ts, tu = trng.next_uniform(_t(s))
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_pixel_seed_bit_exact():
    r = np.random.default_rng(1)
    pixel_id = r.integers(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)
    for sample, num_samples, time in [(0, 1, 1), (1, 2, 1000),
                                      (3, 4, 0xFFFFFFFF), (7, 8, 2 ** 31 + 5)]:
        j = jrng.pixel_seed(sample, jnp.asarray(pixel_id), num_samples, time)
        t = trng.pixel_seed(sample, _t(pixel_id), num_samples, time)
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                      t.numpy())


def test_next_normal_bit_exact():
    s = seeds(np.random.default_rng(2), N)
    js, jn = jrng.next_normal(jnp.asarray(s))
    ts, tn = trng.next_normal(_t(s))
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


def test_cos_2pi_bit_exact():
    u = np.random.default_rng(3).uniform(-4, 4, N).astype(np.float32)
    u[:5] = [0.0, 0.25, 0.5, -0.75, 1.0]
    np.testing.assert_array_equal(np.asarray(jrng.cos_2pi(jnp.asarray(u))),
                                  trng.cos_2pi(torch.from_numpy(u)).numpy())


def test_log_matches_reference_log():
    """The port's log is XLA:CPU's jnp.log bit for bit, including ln(0) =
    -inf, the hazard the RNG keeps (a u2 == 0 draw gives an infinite
    normal sample)."""
    r = np.random.default_rng(4)
    x = np.concatenate([
        r.random(N, dtype=np.float32),
        r.integers(1, 0x7F800000, N).astype(np.int32).view(np.float32),
        np.array([0.0, 2.0 ** -32, 1.0, np.inf, -1.0, np.nan, 1e-40],
                 np.float32)])
    j = np.asarray(jnp.log(jnp.asarray(x)))
    t = trng.log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(j, t)
    assert t[-7] == -np.inf
    rho = trng.sqrt(-2.0 * trng.log(torch.zeros(1)))
    assert rho.item() == np.inf


def test_direction_hemisphere_bit_exact():
    r = np.random.default_rng(5)
    n = 1 << 16
    normal = unit_vectors(r, n)
    s = seeds(r, n)
    js, jd = jrng.next_direction_hemisphere(jvec(normal), jnp.asarray(s))
    ts, td = trng.next_direction_hemisphere(tvec(normal), _t(s))
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
    np.testing.assert_array_equal(to_np(jd), to_np(td))


def test_kernel_source_constants_match():
    """The CUDA source spells the cos and log constants as hex floats; they
    must be exactly the plain version's.  They sit in the header the
    kernels include (csrc/path_common.cuh), which both kernels read."""
    path = Path(trace_kernel.SOURCE)
    src = path.read_text()
    for header in re.findall(r'#include "(\w+\.cuh)"', src):
        src += (path.parent / header).read_text()
    const = {name: float.fromhex(val) for name, val in re.findall(
        r"constexpr float (k\w+) = (-?0x[0-9a-fA-Fp.+-]+)f;", src)}
    assert [const[f"kCos{i}"] for i in range(8)] == trng.COS2PI_C
    assert [const[f"kLogP{i}"] for i in range(9)] == trng.LOG_P
    assert const["kLogQ1"] == trng.LOG_Q1
    assert const["kLogQ2"] == trng.LOG_Q2
    assert const["kLogSqrtHf"] == trng.LOG_SQRTHF
    assert const["kLogMinNormal"] == trng.LOG_MIN_NORMAL
