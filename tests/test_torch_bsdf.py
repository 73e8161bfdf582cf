"""The port's material sample against simple_raytracer_tpu.ops.bsdf.

Random hits (numpy, from a seed) over materials that cover every branch
(diffuse, metallic, specular, glass from both sides, emissive) go through
both packages.  The JAX side runs eagerly, op by op, so the new origin,
direction, throughput factor and seed must be identical (tolerance 0),
and with them the Schlick draw that only a transparent ray without total
internal reflection consumes.
"""
import jax.numpy as jnp
import numpy as np
import torch

from simple_raytracer_tpu.models.presets import CONFIGS as JCONFIGS
from simple_raytracer_tpu.ops import bsdf as jbsdf
from simple_raytracer_tpu_torch.ops import bsdf as tbsdf
from simple_raytracer_tpu_torch.ops.scene_types import from_numpy

from torch_port_helpers import (jax_scene_arrays, jvec, seeds, to_np, tvec,
                                unit_vectors)

N = 1 << 16


def _inputs(seed):
    r = np.random.default_rng(seed)
    normal = unit_vectors(r, N)
    in_dir = unit_vectors(r, N)
    # the normal faces the ray, as closest_hit leaves it
    flip = np.sum(normal * in_dir, axis=1, keepdims=True) > 0
    normal = np.where(flip, -normal, normal).astype(np.float32)
    position = r.uniform(-3, 3, size=(N, 3)).astype(np.float32)
    front = r.random(N) < 0.5
    return position, normal, front, in_dir, seeds(r, N)


def _materials():
    """Config 2's table (diffuse, metal, mirror, glass, lamp) plus random
    rows with every field in [0, 1] and an IOR in [1, 2.5]."""
    scene, _, _ = JCONFIGS[2](width=64, height=16)
    ds = scene.build()
    arrays = jax_scene_arrays(ds)
    r = np.random.default_rng(7)
    k = 8
    for f in ("smoothness", "metallic", "specular", "emission_strength",
              "transmittance"):
        arrays[f"materials.{f}"] = np.concatenate(
            [arrays[f"materials.{f}"], r.random(k).astype(np.float32)])
    arrays["materials.refraction_index"] = np.concatenate(
        [arrays["materials.refraction_index"],
         r.uniform(1, 2.5, k).astype(np.float32)])
    for f in ("color", "emission"):
        arrays[f"materials.{f}"] = np.concatenate(
            [arrays[f"materials.{f}"], r.random((k, 3)).astype(np.float32)])
    from simple_raytracer_tpu.ops.scene_types import MaterialsSoA
    from simple_raytracer_tpu.ops.vec import Vec3 as JVec3
    c = arrays["materials.color"]
    e = arrays["materials.emission"]
    jm = MaterialsSoA(
        **{f: jnp.asarray(arrays[f"materials.{f}"]) for f in (
            "smoothness", "metallic", "specular", "emission_strength",
            "transmittance", "refraction_index")},
        color=JVec3(*(jnp.asarray(c[:, i]) for i in range(3))),
        emission=JVec3(*(jnp.asarray(e[:, i]) for i in range(3))))
    return jm, from_numpy(arrays, "cpu").materials


def test_gather_and_sample_material_match():
    jm, tm = _materials()
    position, normal, front, in_dir, s = _inputs(0)
    idx = np.random.default_rng(1).integers(0, tm.smoothness.shape[0], N)
    jf = jbsdf.gather_materials(jm, jnp.asarray(idx.astype(np.int32)))
    tf = tbsdf.gather_materials(tm, torch.from_numpy(idx))
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(to_np(a) if isinstance(a, tuple)
                                      else np.asarray(a),
                                      to_np(b) if isinstance(b, tuple)
                                      else b.numpy())

    js = jbsdf.sample_material(jvec(position), jvec(normal),
                               jnp.asarray(front), jvec(in_dir), jf,
                               jnp.asarray(s))
    ts = tbsdf.sample_material(tvec(position), tvec(normal),
                               torch.from_numpy(front), tvec(in_dir), tf,
                               torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(js.seed).astype(np.int64),
                                  ts.seed.numpy())
    for name in ("origin", "direction", "mask_mul"):
        np.testing.assert_array_equal(to_np(getattr(js, name)),
                                      to_np(getattr(ts, name)), err_msg=name)
    # every branch was exercised: glass rays that refracted, that reflected,
    # and opaque rays
    trans = np.asarray(jf.transmittance) > 0.99
    assert trans.sum() > 1000 and (~trans).sum() > 1000


def test_shlick_reflectance_matches():
    r = np.random.default_rng(3)
    mu = r.uniform(0.3, 2.5, 4096).astype(np.float32)
    cos = r.uniform(-1, 1, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jbsdf.shlick_reflectance(jnp.asarray(mu), jnp.asarray(cos))),
        tbsdf.shlick_reflectance(torch.from_numpy(mu),
                                 torch.from_numpy(cos)).numpy())
