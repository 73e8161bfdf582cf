"""The brute-force nearest-triangle kernel of the ``tri_backend="pallas"``
route (``csrc/triangle_kernel.cu``).

It replaces the TPU kernel ``_kernel`` of
``simple_raytracer_tpu/ops/pallas/triangle_kernel.py`` (through
``intersect_triangles_pallas``): each live ray against every active
triangle, the nearest Moller-Trumbore hit as (t, index int32), (+inf, 0)
for a dead ray.  It reads the scene's staged table
(``ops/triangle.staged_table``, built from the packed (16, T) table on
the first launch and kept on the scene).  Its plain PyTorch version is
``ops/triangle.intersect_packed_plain``.

With an alive mask the live rays are compacted on the device, in the
same launch (the kernel's ``compact_live``: their indices and count in
scratch tensors, never read back to the host); the kernel's blocks past
the count exit at once.  The result is one (R,) int64 key a ray, (t bits
<< 32) | index, set to the miss (+inf, 0) before the launch and lowered
with atomicMin by the blocks that share a ray (the kernel splits the
triangle range across blocks when few rays are live); t and index are
views of it.

``intersect_triangles_packed`` takes the plain version only for rays on
the CPU.  For rays on a CUDA device it launches the kernel or raises:
there is no fallback.  The kernel is built on first use
(``ops/cuda/build.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..triangle import PACKED_ROWS, STAGED_COLS, intersect_packed_plain
from ..vec import Vec3
from .build import PACKAGE_DIR, Kernel

SOURCE = PACKAGE_DIR / "csrc" / "triangle_kernel.cu"
# the kernel's block: (kThreads, kRays), threads and rays a thread
SHAPE = (128, 4)


class TriParams(ctypes.Structure):
    """By-value launch parameters; the layout of ``TriParams`` in the CUDA
    source."""
    _fields_ = [
        ("n_rays", ctypes.c_int32),
        ("n_tris", ctypes.c_int32),
    ]


# srt_triangle_launch(rays, staged, alive, order, count, key_out, params,
#                     stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 6 + [TriParams, ctypes.c_void_p]
# a ray's key before the launch: the miss, (+inf, 0)
MISS_KEY = 0x7F800000 << 32


def _bind(lib: ctypes.CDLL) -> None:
    lib.srt_triangle_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_triangle_launch.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)


@dataclasses.dataclass
class Prepared:
    """One launch, checked and packed."""
    rays: torch.Tensor       # (6, R) f32: o, d
    packed: torch.Tensor     # (16, T) f32, the plain version's table
    staged: torch.Tensor     # (Ta, STAGED_COLS) f32, the kernel's
    alive: Optional[torch.Tensor]   # (R,) bool, None: every ray
    # the launch's scratch with a mask: the live rays' indices ((R,)
    # int32, the first ``count`` set) and their count ((1,) int32)
    order: Optional[torch.Tensor]
    count: Optional[torch.Tensor]
    params: TriParams


def prepare(o: Vec3, d: Vec3, packed: torch.Tensor, alive,
            staged) -> Prepared:
    """Check a CUDA launch's arguments (``staged``: the table's
    ``stage_triangles``, on the card), pack the rays and, with a mask,
    allocate the scratch of the live-ray list."""
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
    if (staged is None or staged.ndim != 2 or staged.shape[1] != STAGED_COLS
            or staged.shape[0] > packed.shape[1] or staged.device != device
            or staged.dtype != torch.float32 or not staged.is_contiguous()
            or staged.data_ptr() % 16):
        raise ValueError("triangle kernel: bad staged table "
                         + ("None" if staged is None else
                            f"{tuple(staged.shape)} {staged.dtype} on "
                            f"{staged.device}"))
    order = count = None
    if alive is not None:
        if alive.shape != (n_rays,) or alive.dtype != torch.bool \
                or alive.device != device:
            raise ValueError(f"triangle kernel: bad alive mask "
                             f"{tuple(alive.shape)} {alive.dtype}")
        alive = alive.contiguous()
        order = torch.empty(n_rays, dtype=torch.int32, device=device)
        count = torch.empty(1, dtype=torch.int32, device=device)
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z]).to(torch.float32)
    return Prepared(rays.contiguous(), packed, staged, alive, order, count,
                    TriParams(n_rays, staged.shape[0]))


def split_key(key: torch.Tensor):
    """(R,) int64 keys -> (t f32, idx int32), views of the key's high and
    low words."""
    n = key.shape[0]
    return (key.view(torch.float32).view(n, 2)[:, 1],
            key.view(torch.int32).view(n, 2)[:, 0])


def launch(prep: Prepared, key=None):
    """Set ``key`` ((R,) int64, allocated when not given) to the miss,
    launch on the current stream, count the launch and return (t, idx),
    views of ``key``."""
    n = prep.params.n_rays
    device = prep.rays.device
    if key is None:
        key = torch.empty(n, dtype=torch.int64, device=device)
    elif (key.shape != (n,) or key.dtype != torch.int64
          or key.device != device or not key.is_contiguous()):
        raise ValueError("triangle kernel: bad key tensor")
    key.fill_(MISS_KEY)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    lib = KERNEL.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.srt_triangle_launch(prep.rays.data_ptr(),
                                      prep.staged.data_ptr(),
                                      ptr(prep.alive), ptr(prep.order),
                                      ptr(prep.count),
                                      key.data_ptr(), prep.params, stream)
    KERNEL.check(err, "triangle kernel")
    KERNEL.count("triangle")
    return split_key(key)


def intersect_triangles_packed(o: Vec3, d: Vec3, packed: torch.Tensor,
                               alive=None, staged=None):
    """(R,) rays x the packed (16, T) table -> (t f32, idx int32): each
    live ray's nearest triangle hit, (+inf, 0) where there is none and for
    a dead ray (``alive`` (R,) bool; None: every ray is live); the first
    triangle wins an exact tie.  On the card ``staged``, the scene's
    ``triangle.staged_table``, is the kernel's table."""
    if o.x.device.type == "cpu":
        return intersect_packed_plain(o, d, packed, alive)
    return launch(prepare(o, d, packed, alive, staged))
