"""The per-bounce shade kernel of the fused per-bounce path
(``csrc/bounce_kernel.cu``).

It replaces the TPU kernel ``_bounce_kernel`` of
``simple_raytracer_tpu/ops/pallas/bounce_kernel.py`` (through its
``bounce_step``): one bounce of the (20, Rp) ray state, with the nearest
triangle given as the BVH kernel's winner (t, table slot), whose row the
kernel gathers from the slot table itself.  Its plain PyTorch version is
``ops/bounce.bounce_step_plain``; ``ops/bounce.bounce_step`` takes one or
the other by the state's device.

``prepare`` checks a CUDA launch's arguments and packs them; ``launch``
runs it on the current stream into a new state and counts the launch.
Nothing falls back: a state off the card raises.  The kernel is built on
first use (``ops/cuda/build.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from .build import PACKAGE_DIR, Kernel

SOURCE = PACKAGE_DIR / "csrc" / "bounce_kernel.cu"
ST_ROWS = 20


class BounceParams(ctypes.Structure):
    """By-value launch parameters; the layout of ``BounceParams`` in the
    CUDA source."""
    _fields_ = [
        ("n_rays", ctypes.c_int32),
        ("n_spheres", ctypes.c_int32),
        ("n_planes", ctypes.c_int32),
        ("n_materials", ctypes.c_int32),
        ("has_tris", ctypes.c_int32),
        ("is_last", ctypes.c_int32),
    ]


# srt_bounce_launch(state, out, tri_t, tri_slot, table, sph, pln, mat,
#                   params, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 8 + [BounceParams, ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    lib.srt_bounce_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_bounce_launch.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)


@dataclasses.dataclass
class Prepared:
    """One launch, checked and packed."""
    state: torch.Tensor          # (20, Rp) f32, read
    tri: tuple                   # (t f32, slot int32, table f32) or Nones
    tables: tuple                # spheres, planes, materials
    params: BounceParams


def prepare(state: torch.Tensor, is_last: bool, scene, tri,
            tables: tuple) -> Prepared:
    """Check a CUDA launch's arguments and pack them: the state, the BVH
    winner ``tri`` = (t, slot) (None for a scene without triangles) and
    ``tables`` = ``ops/scene_types.prim_tables(scene)``."""
    device = state.device
    if device.type != "cuda":
        raise ValueError(f"bounce kernel: unsupported device {device}")
    if (state.dim() != 2 or state.shape[0] != ST_ROWS
            or state.dtype != torch.float32 or not state.is_contiguous()):
        raise ValueError(f"bounce kernel: bad state {tuple(state.shape)} "
                         f"{state.dtype}")
    n = state.shape[1]
    if n >= 2 ** 31 - 256:
        raise ValueError(f"bounce kernel: {n} rays overflow int32")
    has_tris = scene.triangles.material.shape[0] > 0
    if has_tris != (tri is not None):
        raise ValueError("bounce kernel: a mesh scene needs the BVH "
                         "winner, and only a mesh scene")
    if tri is not None:
        t, slot = tri
        table = scene.triangles.table
        for name, x, dtype, shape in (
                ("winner t", t, torch.float32, (n,)),
                ("winner slot", slot, torch.int32, (n,)),
                ("table", table, torch.float32, (table.shape[0], 20))):
            if (x.device != device or x.dtype != dtype or x.shape != shape
                    or not x.is_contiguous()):
                raise ValueError(f"bounce kernel: bad {name} "
                                 f"{tuple(x.shape)} {x.dtype} on {x.device}")
        tri = (t, slot, table)
    else:
        tri = (None, None, None)
    sph, pln, mat = tables
    for name, x, cols in (("spheres", sph, 8), ("planes", pln, 8),
                          ("materials", mat, 16)):
        if (x.device != device or x.dtype != torch.float32
                or x.dim() != 2 or x.shape[1] != cols
                or not x.is_contiguous()):
            raise ValueError(f"bounce kernel: bad {name} table")
    p = BounceParams()
    p.n_rays = n
    p.n_spheres, p.n_planes, p.n_materials = (sph.shape[0], pln.shape[0],
                                              mat.shape[0])
    p.has_tris = int(has_tris)
    p.is_last = int(bool(is_last))
    return Prepared(state, tri, tables, p)


def launch(prep: Prepared, out: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Launch on the current stream into ``out`` (a (20, Rp) f32 state,
    allocated when not given; never the input state) and count the
    launch."""
    state = prep.state
    if out is None:
        out = torch.empty_like(state)
    elif (out.shape != state.shape or out.dtype != state.dtype
          or out.device != state.device or not out.is_contiguous()
          or out.data_ptr() == state.data_ptr()):
        raise ValueError("bounce kernel: bad output tensor")
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = KERNEL.library()
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.srt_bounce_launch(state.data_ptr(), out.data_ptr(),
                                    *map(ptr, prep.tri + prep.tables),
                                    prep.params, stream)
    KERNEL.check(err, "bounce kernel")
    KERNEL.count("bounce")
    return out
