"""The modules the measuring process must not hold: JAX, its libraries
and the JAX package, compared by whole top-level names, so the port
(``simple_raytracer_tpu_torch``) is not taken for the JAX package."""
from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "simple_raytracer_tpu")


def forbidden_modules(modules) -> list:
    """The forbidden top-level names among ``modules``' names."""
    return sorted({m.split(".")[0] for m in modules
                   if m.split(".")[0] in FORBIDDEN})
