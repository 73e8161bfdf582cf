"""The ray state of the fused per-bounce path, and one bounce over it.

The XLA side of ``simple_raytracer_tpu/ops/pallas/bounce_kernel.py``: the
(20, Rp) f32 ray state (``make_state``, ``unpack_state``) and
``bounce_step``, one bounce of every ray: the kernel
``ops/cuda/bounce_kernel.py`` (``csrc/bounce_kernel.cu``) for a state on a
CUDA device, its plain version ``bounce_step_plain`` for one on the CPU.

State rows (rays on columns, padded to a multiple of the block with dead
rays):

    0-2  origin              8-10  path throughput (mask)
    3-5  direction          11-13  accumulated color
    6    RNG seed (uint32   14-16  deferred-sky throughput
         bits in an f32)    17-19  deferred-sky direction
    7    alive (0 or 1)

The seed row carries the uint32 bits: it is written through an int32 view
and read back through one, never by a float operation, which could change
a NaN pattern and with it the RNG stream.

``bounce_step_plain`` is the bounce body of ``_bounce_body`` (:500-581),
in the split path's operation order (``intersect.closest_hit_split``'s
``_resolve`` and ``shade_from_position``, ``bsdf.sample_material``), with
the nearest triangle given as the BVH kernel's winner (t, table slot).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import rng
from .bsdf import gather_materials, sample_material
from .intersect import _resolve, _spheres_planes, shade_from_position
from .scene_types import DeviceScene, prim_tables
from .vec import Vec3, where as vwhere

ST_ROWS = 20
BLOCK = 256          # the kernel's thread block, make_state's padding unit


def seed_bits(seed: torch.Tensor) -> torch.Tensor:
    """int64 seeds in [0, 2^32) -> their uint32 bits as an f32 row."""
    signed = torch.where(seed >= 2 ** 31, seed - 2 ** 32, seed)
    return signed.to(torch.int32).view(torch.float32)


def seed_of(row: torch.Tensor) -> torch.Tensor:
    """An f32 row of uint32 bits -> int64 seeds in [0, 2^32)."""
    return row.view(torch.int32).to(torch.int64) & rng.MASK


def make_state(o: Vec3, d: Vec3, seed: torch.Tensor,
               block_r: int = BLOCK) -> torch.Tensor:
    """Pack (R,) primary rays into the (20, Rp) state, Rp padded to a
    multiple of ``block_r`` with dead rays (bounce_kernel.make_state)."""
    n = o.x.shape[0]
    pad = (-n) % block_r
    dev = o.x.device
    row = lambda c, fill=0.0: torch.cat(
        [c, torch.full((pad,), fill, dtype=c.dtype, device=dev)])
    zero = torch.zeros(n + pad, dtype=torch.float32, device=dev)
    one = torch.ones(n + pad, dtype=torch.float32, device=dev)
    alive = row(torch.ones(n, dtype=torch.float32, device=dev))
    rows = [row(o.x), row(o.y), row(o.z), row(d.x), row(d.y), row(d.z),
            row(seed_bits(seed)), alive, one, one, one, zero, zero, zero,
            zero, zero, zero, zero, zero, one]
    # stacked as int32 bits: a copy that cannot touch the seed's pattern
    return torch.stack([r.view(torch.int32) for r in rows]).view(
        torch.float32)


def unpack_state(state: torch.Tensor, n: int):
    """Rows -> (color, sky_mask, sky_dir) Vec3s of (n,) components."""
    r = lambda i: state[i, :n]
    return (Vec3(r(11), r(12), r(13)), Vec3(r(14), r(15), r(16)),
            Vec3(r(17), r(18), r(19)))


def bounce_step_plain(state: torch.Tensor, is_last: bool,
                      scene: DeviceScene, tri=None) -> torch.Tensor:
    """One bounce of every ray of the (20, Rp) state -> the next state.
    ``tri`` is the BVH kernel's (t (Rp,) f32, slot (Rp,) int32) for a mesh
    scene, None for one without triangles.  A dead ray's rows come back
    unchanged."""
    row = lambda i: Vec3(state[i], state[i + 1], state[i + 2])
    o, d, mask = row(0), row(3), row(8)
    color, sky_mask, sky_dir = row(11), row(14), row(17)
    seed = seed_of(state[6])
    alive = state[7] > 0.0
    t_s, i_s, t_p, i_p = _spheres_planes(scene, o, d)
    tr = scene.triangles
    if tri is None:
        t_t, shade = torch.full_like(o.x, math.inf), None
    else:
        t_t, slot = tri
        rows = tr.table[slot.clamp_min(0).long()]   # slot -1: t is +inf
        shade = lambda position: shade_from_position(rows, position)
    hit = _resolve(scene, o, d, t_s, i_s, t_p, i_p, t_t, shade)

    h_alive = alive & hit.hit
    m_alive = alive & ~hit.hit
    sky_mask = vwhere(m_alive, mask, sky_mask)
    sky_dir = vwhere(m_alive, d, sky_dir)
    mat = gather_materials(scene.materials, hit.material)
    emission = mask * mat.emission * mat.emission_strength
    color = vwhere(h_alive, color + emission, color)
    if is_last:
        cont = torch.zeros_like(alive)
    else:
        cont = h_alive
        ms = sample_material(hit.position, hit.normal, hit.front, d, mat,
                             seed)
        o = vwhere(cont, ms.origin, o)
        d = vwhere(cont, ms.direction, d)
        mask = vwhere(cont, mask * ms.mask_mul, mask)
        seed = torch.where(cont, ms.seed, seed)
    rows = [*o, *d, seed_bits(seed), cont.to(torch.float32), *mask, *color,
            *sky_mask, *sky_dir]
    return torch.stack([r.view(torch.int32) for r in rows]).view(
        torch.float32)


def bounce_step(state: torch.Tensor, is_last: bool, scene: DeviceScene,
                tri=None, tables: Optional[tuple] = None) -> torch.Tensor:
    """One bounce of the (20, Rp) state: the plain version for a state on
    the CPU, the kernel for one on a CUDA device (it raises there rather
    than fall back).  ``tables`` are ``prim_tables(scene)``, packed once
    per trace by the caller."""
    if state.device.type == "cpu":
        return bounce_step_plain(state, is_last, scene, tri)
    from .cuda import bounce_kernel
    if tables is None:
        tables = prim_tables(scene)
    return bounce_kernel.launch(bounce_kernel.prepare(
        state, is_last, scene, tri, tables))
