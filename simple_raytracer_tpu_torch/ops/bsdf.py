"""One stochastic material interaction per ray, as a select lattice.

The counterpart of ``simple_raytracer_tpu.ops.bsdf``, with its draw order:
6 uniforms for the hemisphere direction, then metallic, specular,
transmittance, and the Schlick uniform, which is consumed only when the
ray is transparent and not totally internally reflected.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng
from .scene_types import Materials
from .vec import (Vec3, dot, length_squared, mix, normalize, reflect, sign,
                  sqrt, where as vwhere)


class MaterialSample(NamedTuple):
    origin: Vec3          # new ray origin, offset off the surface
    direction: Vec3       # new unit direction
    mask_mul: Vec3        # factor on the path throughput
    seed: torch.Tensor    # advanced RNG state


class MatFields(NamedTuple):
    smoothness: torch.Tensor
    metallic: torch.Tensor
    specular: torch.Tensor
    emission_strength: torch.Tensor
    transmittance: torch.Tensor
    refraction_index: torch.Tensor
    color: Vec3
    emission: Vec3


def shlick_reflectance(mu, cos_theta):
    r0 = (1.0 - mu) / (1.0 + mu)
    r0 = r0 * r0
    m = 1.0 - cos_theta
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def gather_materials(materials: Materials, idx: torch.Tensor) -> MatFields:
    """Per-ray material fields for an (R,) index tensor."""
    return MatFields(
        smoothness=materials.smoothness[idx],
        metallic=materials.metallic[idx],
        specular=materials.specular[idx],
        emission_strength=materials.emission_strength[idx],
        transmittance=materials.transmittance[idx],
        refraction_index=materials.refraction_index[idx],
        color=Vec3.from_array(materials.color[idx]),
        emission=Vec3.from_array(materials.emission[idx]))


def sample_material(position: Vec3, normal: Vec3, front: torch.Tensor,
                    in_dir: Vec3, mat: MatFields,
                    seed: torch.Tensor) -> MaterialSample:
    """``normal`` already faces the ray; ``front`` (the side hit) picks the
    index-of-refraction ratio."""
    seed, hemi = rng.next_direction_hemisphere(normal, seed)
    random_dir = normalize(normal + hemi)
    reflected_dir = reflect(in_dir, normal)

    seed, u_metal = rng.next_uniform(seed)
    seed, u_spec = rng.next_uniform(seed)
    is_metallic = mat.metallic > u_metal
    is_specular = mat.specular > u_spec

    rough_dir = mix(random_dir, reflected_dir, mat.smoothness)

    seed, u_trans = rng.next_uniform(seed)
    is_transparent = mat.transmittance > u_trans
    seed_opaque = seed

    # opaque: diffuse, or glossy toward the mirror direction
    mirror_like = (is_metallic | is_specular).to(torch.float32)
    dir_opaque = mix(random_dir, rough_dir, mirror_like)
    one = Vec3.full(1.0)
    mask_opaque = mix(mat.color, one, is_specular.to(torch.float32))

    # transparent: Schlick reflection, total internal reflection, refraction
    refl_smooth = reflect(rough_dir, normal)
    mu = torch.where(front, 1.0 / mat.refraction_index, mat.refraction_index)
    cos_theta = torch.clamp_max(dot(refl_smooth, -normal), 1.0)
    sin_theta = sqrt(1.0 - cos_theta * cos_theta)
    tir = mu * sin_theta > 1.0
    seed_schlick, u_schlick = rng.next_uniform(seed)
    seed_transparent = torch.where(tir, seed, seed_schlick)
    reflected_trans = tir | (shlick_reflectance(mu, cos_theta) > u_schlick)

    out_perp = (refl_smooth + normal * cos_theta) * mu
    out_parallel = normal * (-sqrt(torch.abs(1.0 - length_squared(out_perp))))
    refracted_dir = out_perp + out_parallel

    dir_trans = vwhere(reflected_trans, rough_dir, refracted_dir)
    mask_trans = vwhere(reflected_trans, one, mat.color)

    new_dir = normalize(vwhere(is_transparent, dir_trans, dir_opaque))
    mask_mul = vwhere(is_transparent, mask_trans, mask_opaque)
    seed = torch.where(is_transparent, seed_transparent, seed_opaque)

    origin = position + normal * (sign(dot(normal, new_dir)) * 0.001)
    return MaterialSample(origin=origin, direction=new_dir,
                          mask_mul=mask_mul, seed=seed)
