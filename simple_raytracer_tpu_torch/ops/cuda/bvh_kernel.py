"""The BVH nearest-hit kernel of the per-bounce paths
(``csrc/bvh_kernel.cu``).

It replaces three TPU kernels of
``simple_raytracer_tpu/ops/pallas/bvh_kernel.py``: ``_kernel`` (a row
table of at most ``VMEM_TABLE_MAX_SLOTS`` slots) as the ``flat`` variant,
``_kernel_packed`` (group -> super -> cluster gates, config 6) as the
``two_level`` variant, and ``_kernel_hbm`` (the same gates over a table
the TPU streams from HBM: config 7, and every clustered mesh under
``tri_backend="clustered"``) as the ``streamed`` variant, which stages
each admitted cluster in shared memory once per warp, 128 slots at a
time, so a cluster may hold any number of slots.  Its plain PyTorch
version is ``ops/bvh.intersect_triangles_bvh_plain``.

Under ``SRT_BVH_MT=plucker`` the ``two_level`` and ``streamed`` variants
take the Plucker form of Moller-Trumbore (``_mt_update_sub_mxu`` and
``_plucker_lt``, row 5a) where ``ops/bvh.resolve_plucker`` grants it:
each slot's coefficients come from ``ops/bvh.plucker_coefficients``, built
once per scene, and a launch is counted as "<variant>/plucker".

``intersect_triangles_bvh`` takes the plain version only for rays on the
CPU.  For rays on a CUDA device it launches the kernel or raises: there
is no fallback.  With ``compact``, the rays are first sorted by
``ops/bvh.compact_order`` and the kernel walks them in that order, with
the count of admitted rays read from device memory, so no bounce waits on
the host.  The kernel is built on first use (``ops/cuda/build.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from .. import bvh
from ..vec import Vec3
from .build import PACKAGE_DIR, Kernel

SOURCE = PACKAGE_DIR / "csrc" / "bvh_kernel.cu"
# the kernel's variants, as the CUDA source's Variant
VARIANTS = {"flat": 0, "two_level": 1, "streamed": 2}


class BvhParams(ctypes.Structure):
    """By-value launch parameters; the layout of ``BvhParams`` in the CUDA
    source."""
    _fields_ = [
        ("n_rays", ctypes.c_int32),
        ("n_order", ctypes.c_int32),
        ("n_clusters", ctypes.c_int32),
        ("k", ctypes.c_int32),
        ("variant", ctypes.c_int32),
        ("plucker", ctypes.c_int32),
    ]


# srt_bvh_launch(rays, table, coeffs, gidx, boxes, supers, groups, order,
#                perm, count, t_out, slot_out, params, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 12 + [BvhParams, ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    lib.srt_bvh_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_bvh_launch.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)


def bvh_variant(clusters, force_streamed: bool = False) -> str:
    """The kernel variant for a cluster table, by the TPU's residency rule
    (``intersect_triangles_bvh``): "streamed" for a table the TPU streams
    from HBM (``_kernel_hbm``: ``bvh.table_streams_hbm``, or any table
    when ``force_streamed``, as ``hbm_table=True`` under
    ``tri_backend="clustered"``), else "flat" for at most
    VMEM_TABLE_MAX_SLOTS slots (``_kernel``), else "two_level" for a table
    the TPU keeps resident packed (``_kernel_packed``)."""
    if force_streamed or bvh.table_streams_hbm(clusters):
        return "streamed"
    if clusters.slots.numel() <= bvh.VMEM_TABLE_MAX_SLOTS:
        return "flat"
    return "two_level"


@dataclasses.dataclass
class Prepared:
    """One launch, checked and packed."""
    rays: torch.Tensor           # (8, R) f32: o, d, alive, t_init
    tensors: tuple               # table, gidx, boxes, supers, groups, order
    perm: Optional[torch.Tensor]   # (R,) int32 ray order, or None
    count: Optional[torch.Tensor]  # 0-d int32 admitted rays, or None
    variant: str
    params: BvhParams
    coeffs: Optional[torch.Tensor] = None   # the Plucker form's table

    @property
    def label(self) -> str:
        """The variant as counted: "<variant>/plucker" for that form."""
        return self.variant + ("/plucker" if self.params.plucker else "")


def prepare(o: Vec3, d: Vec3, alive: torch.Tensor, t_init: torch.Tensor,
            clusters, table: torch.Tensor, order=None, count=None,
            force_streamed: bool = False) -> Prepared:
    """Check a CUDA launch's arguments and pack them; ``order``/``count``
    are a compaction's (``ops/bvh.compact_order``).  The MT form is
    resolved here (``ops/bvh.resolve_plucker``)."""
    device = o.x.device
    if device.type != "cuda":
        raise ValueError(f"BVH kernel: unsupported device {device}")
    variant = bvh_variant(clusters, force_streamed)
    n_rays = o.x.shape[0]
    if n_rays >= 2 ** 31 - 1024:
        raise ValueError(f"BVH kernel: {n_rays} rays overflow int32")
    hier = clusters.hierarchy
    n_cl, k = clusters.slots.shape
    coeffs = None
    if bvh.resolve_plucker(clusters, variant):
        coeffs = bvh.plucker_coefficients(clusters, table)
        if (coeffs.device != device or coeffs.dtype != torch.float32
                or coeffs.shape != (n_cl * k, bvh.PLUCKER_COLS)
                or not coeffs.is_contiguous() or coeffs.data_ptr() % 16):
            raise ValueError("BVH kernel: bad Plucker coefficient table")
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z,
                        alive.to(torch.float32), t_init])
    if variant == "flat":
        boxes = clusters.aabb
        visit = bvh.front_to_back(boxes, o, alive > 0)
    else:
        boxes = hier.boxes
        visit = bvh.front_to_back(hier.groups, o, alive > 0)
    tensors = (table, hier.gidx, boxes, hier.supers, hier.groups, visit)
    for name, t, dtype in zip(
            ("table", "slot indices", "boxes", "supers", "groups", "order"),
            tensors, (torch.float32, torch.int32, torch.float32,
                      torch.float32, torch.float32, torch.int32)):
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"BVH kernel: bad {name} {t.dtype} on "
                             f"{t.device}")
    if table.shape != (n_cl * k, 20) or hier.gidx.shape != (n_cl * k,):
        raise ValueError(f"BVH kernel: table {tuple(table.shape)} for "
                         f"{n_cl} clusters of {k}")
    if (order is None) != (count is None):
        raise ValueError("BVH kernel: a compaction needs order and count")
    perm = cnt = None
    if order is not None:
        perm = order.to(device=device, dtype=torch.int32).contiguous()
        cnt = count.to(device=device, dtype=torch.int32).reshape(())
        if perm.shape != (n_rays,):
            raise ValueError("BVH kernel: the order must list every ray")
    p = BvhParams()
    p.n_rays, p.n_order, p.n_clusters, p.k = n_rays, visit.shape[0], n_cl, k
    p.variant = VARIANTS[variant]
    p.plucker = int(coeffs is not None)
    return Prepared(rays, tensors, perm, cnt, variant, p, coeffs)


def launch(prep: Prepared, out=None):
    """Launch on the current stream into ``out`` ((R,) f32 t, (R,) int32
    slot; allocated when not given) and count the launch."""
    n = prep.params.n_rays
    device = prep.rays.device
    if out is None:
        out = (torch.empty(n, dtype=torch.float32, device=device),
               torch.empty(n, dtype=torch.int32, device=device))
    elif any(t.shape != (n,) or t.dtype != dtype or t.device != device
             or not t.is_contiguous()
             for t, dtype in zip(out, (torch.float32, torch.int32))):
        raise ValueError("BVH kernel: bad output tensors")
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = KERNEL.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        table, *rest = map(ptr, prep.tensors)
        err = lib.srt_bvh_launch(prep.rays.data_ptr(), table,
                                 ptr(prep.coeffs), *rest, ptr(prep.perm),
                                 ptr(prep.count), out[0].data_ptr(),
                                 out[1].data_ptr(), prep.params, stream)
    KERNEL.check(err, "BVH kernel")
    KERNEL.count(prep.label)
    return out


def intersect_triangles_bvh(o: Vec3, d: Vec3, alive: torch.Tensor,
                            t_init: torch.Tensor, clusters,
                            table: torch.Tensor, compact: bool = False,
                            force_streamed: bool = False):
    """(R,) rays x a clustered mesh -> (t f32, slot int32): the nearest
    triangle hit strictly closer than ``t_init`` per live ray and the
    table slot of its triangle, (+inf, -1) where none is
    (``ops/bvh.triangle_index`` maps a slot to the triangle's index).
    ``compact`` walks only the rays that enter an admission box, and
    ``force_streamed`` takes the streamed variant for any table; neither
    changes a live ray's result.  The MT form follows SRT_BVH_MT
    (``ops/bvh.resolve_plucker``), on the CPU as on the card."""
    order = count = None
    if compact:
        order, count = bvh.compact_order(o, d, alive, t_init,
                                         clusters.hierarchy.admission)
    if o.x.device.type == "cpu":
        form = ("plucker" if bvh.resolve_plucker(
            clusters, bvh_variant(clusters, force_streamed)) else "mt")
        if compact:
            return bvh.intersect_compacted_plain(o, d, alive, t_init,
                                                 clusters, table, order,
                                                 int(count), form)
        return bvh.intersect_triangles_bvh_plain(o, d, alive, t_init,
                                                 clusters, table, form)
    return launch(prepare(o, d, alive, t_init, clusters, table, order,
                          count, force_streamed))
