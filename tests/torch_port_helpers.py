"""Shared helpers for the tests that hold the PyTorch port
(simple_raytracer_tpu_torch) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU, as the JAX package's own tests run it.
"""
import numpy as np
import torch

from simple_raytracer_tpu.ops.vec import Vec3 as JVec3
from simple_raytracer_tpu_torch.ops.vec import Vec3 as TVec3


def jax_scene_arrays(ds) -> dict:
    """Flatten a JAX DeviceScene into the numpy arrays that the port's
    ``from_numpy`` takes (the port's counterpart of carrying weights)."""
    a = lambda v: np.asarray(v)
    v3 = lambda v: np.stack([a(v.x), a(v.y), a(v.z)], axis=-1)
    out = {
        "spheres.center": v3(ds.spheres.center),
        "spheres.radius": a(ds.spheres.radius),
        "spheres.material": a(ds.spheres.material),
        "spheres.active": a(ds.spheres.active),
        "planes.position": v3(ds.planes.position),
        "planes.normal": v3(ds.planes.normal),
        "planes.material": a(ds.planes.material),
        "planes.active": a(ds.planes.active),
        "sky.sun_focus": a(ds.sky.sun_focus),
        "sky.sun_intensity": a(ds.sky.sun_intensity),
        "sky_reachable": ds.flags.sky_reachable,
    }
    tr = ds.triangles
    for k in ("v0", "v1", "v2", "n0", "n1", "n2"):
        out[f"triangles.{k}"] = v3(getattr(tr, k))
    out["triangles.material"] = a(tr.material)
    out["triangles.active"] = a(tr.active)
    if tr.clusters is not None:
        # the cluster slots from the TPU kernel's row table: column 19
        # marks a filled slot, column 20 holds its triangle index
        table = a(tr.clusters.table_t)
        c = tr.clusters.aabb.shape[0]
        out["clusters.aabb"] = a(tr.clusters.aabb)
        out["clusters.slots"] = np.where(table[:, 19] > 0, table[:, 20],
                                         -1).astype(np.int32).reshape(c, -1)
    m = ds.materials
    for k in ("smoothness", "metallic", "specular", "emission_strength",
              "transmittance", "refraction_index"):
        out[f"materials.{k}"] = a(getattr(m, k))
    out["materials.color"] = v3(m.color)
    out["materials.emission"] = v3(m.emission)
    for k in ("sun_color", "sun_direction", "horizon_color", "zenith_color",
              "ground_color"):
        out[f"sky.{k}"] = v3(getattr(ds.sky, k))
    if ds.skybox is not None:
        out["skybox"] = jax_skybox_image(ds.skybox)
    return out


def jax_skybox_image(skybox) -> np.ndarray:
    """A JAX DeviceScene's skybox as the (H, W, 3) f32 image it was built
    from.  A quad-packed ``SkyboxTex`` is decoded from its anchor texels
    (``quad[..., 0]``) with numpy, by the expressions ``pack_skybox_quad``
    accepted it with, so the image comes back bit for bit."""
    from simple_raytracer_tpu.io.image import _rgbe_to_float
    from simple_raytracer_tpu.ops.scene_types import SkyboxTex
    if not isinstance(skybox, SkyboxTex):
        return np.stack([np.asarray(c) for c in skybox], axis=-1)
    q = np.asarray(skybox.quad)[..., 0]
    channels = np.stack([(q >> (8 * c)) & 0xFF for c in range(4)],
                        axis=-1).astype(np.uint8)
    if skybox.mode == "rgb8":
        return np.power(channels[..., :3].astype(np.float32) / 255.0,
                        np.float32(2.2), dtype=np.float32)
    return _rgbe_to_float(channels)


def unit_vectors(rng: np.random.Generator, n: int) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def seeds(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def jvec(a: np.ndarray) -> JVec3:
    import jax.numpy as jnp
    return JVec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                 jnp.asarray(a[:, 2]))


def tvec(a: np.ndarray) -> TVec3:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return TVec3(t[:, 0], t[:, 1], t[:, 2])


def to_np(v) -> np.ndarray:
    """A Vec3 of either package -> (N, 3) numpy array."""
    return np.stack([np.asarray(c) for c in v], axis=-1)
