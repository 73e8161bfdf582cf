"""The brute-force nearest-triangle kernel of the ``tri_backend="pallas"``
route (``csrc/triangle_kernel.cu``).

It replaces the TPU kernel ``_kernel`` of
``simple_raytracer_tpu/ops/pallas/triangle_kernel.py`` (through
``intersect_triangles_pallas``): every ray against every triangle of the
packed (16, T) table (``ops/triangle.pack_triangles``), the nearest
Moller-Trumbore hit as (t, index int32).  Its plain PyTorch version is
``ops/triangle.intersect_packed_plain``.

``intersect_triangles_packed`` takes the plain version only for rays on
the CPU.  For rays on a CUDA device it launches the kernel or raises:
there is no fallback.  The kernel is built on first use
(``ops/cuda/build.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..triangle import PACKED_ROWS, intersect_packed_plain
from ..vec import Vec3
from .build import PACKAGE_DIR, Kernel

SOURCE = PACKAGE_DIR / "csrc" / "triangle_kernel.cu"


class TriParams(ctypes.Structure):
    """By-value launch parameters; the layout of ``TriParams`` in the CUDA
    source."""
    _fields_ = [
        ("n_rays", ctypes.c_int32),
        ("n_tris", ctypes.c_int32),
    ]


# srt_triangle_launch(rays, tri, t_out, idx_out, params, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 4 + [TriParams, ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    lib.srt_triangle_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_triangle_launch.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)


@dataclasses.dataclass
class Prepared:
    """One launch, checked and packed."""
    rays: torch.Tensor       # (6, R) f32: o, d
    packed: torch.Tensor     # (16, T) f32
    params: TriParams


def prepare(o: Vec3, d: Vec3, packed: torch.Tensor) -> Prepared:
    """Check a CUDA launch's arguments and pack the rays."""
    device = o.x.device
    if device.type != "cuda":
        raise ValueError(f"triangle kernel: unsupported device {device}")
    n_rays = o.x.shape[0]
    if n_rays >= 2 ** 31 - 1024 or packed.shape[-1] >= 2 ** 31 - 1024:
        raise ValueError(f"triangle kernel: {n_rays} rays or "
                         f"{packed.shape[-1]} triangles overflow int32")
    if (packed.ndim != 2 or packed.shape[0] != PACKED_ROWS
            or packed.device != device or packed.dtype != torch.float32
            or not packed.is_contiguous()):
        raise ValueError(f"triangle kernel: bad packed table "
                         f"{tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}")
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z]).to(torch.float32)
    return Prepared(rays.contiguous(), packed,
                    TriParams(n_rays, packed.shape[1]))


def launch(prep: Prepared, out=None):
    """Launch on the current stream into ``out`` ((R,) f32 t, (R,) int32
    index; allocated when not given) and count the launch."""
    n = prep.params.n_rays
    device = prep.rays.device
    if out is None:
        out = (torch.empty(n, dtype=torch.float32, device=device),
               torch.empty(n, dtype=torch.int32, device=device))
    elif any(t.shape != (n,) or t.dtype != dtype or t.device != device
             or not t.is_contiguous()
             for t, dtype in zip(out, (torch.float32, torch.int32))):
        raise ValueError("triangle kernel: bad output tensors")
    lib = KERNEL.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.srt_triangle_launch(prep.rays.data_ptr(),
                                      prep.packed.data_ptr(),
                                      out[0].data_ptr(), out[1].data_ptr(),
                                      prep.params, stream)
    KERNEL.check(err, "triangle kernel")
    KERNEL.count("triangle")
    return out


def intersect_triangles_packed(o: Vec3, d: Vec3, packed: torch.Tensor):
    """(R,) rays x the packed (16, T) table -> (t f32, idx int32): each
    ray's nearest triangle hit, (+inf, 0) where there is none; the first
    triangle wins an exact tie."""
    if o.x.device.type == "cpu":
        return intersect_packed_plain(o, d, packed)
    return launch(prepare(o, d, packed))
