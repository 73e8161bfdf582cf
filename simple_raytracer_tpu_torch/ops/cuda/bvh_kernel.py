"""The BVH nearest-hit kernel of the per-bounce paths
(``csrc/bvh_kernel.cu``).

It replaces three TPU kernels of
``simple_raytracer_tpu/ops/pallas/bvh_kernel.py``: ``_kernel`` (a row
table of at most ``VMEM_TABLE_MAX_SLOTS`` slots: configs 4 and 5 under
``tri_backend="bvh"``) as the ``flat`` variant, ``_kernel_packed``
(group -> super -> cluster gates, config 6) as the ``two_level`` variant,
and ``_kernel_hbm`` (the same gates over a table the TPU streams from
HBM: config 7, and every clustered mesh under ``tri_backend="clustered"``)
as the ``streamed`` variant.  All three launch one warp walk down the
hierarchy (``clusters.hierarchy``): the warp tests each level's gates
together, stages each cluster some lane admits from a per-scene table of
the bytes MT reads (``ops/bvh.staged_slots``) with asynchronous bulk
copies into shared memory, and splits MT pair by pair across the lanes
when few of them admit a cluster.  Its plain PyTorch version is
``ops/bvh.intersect_triangles_bvh_plain``.

Under ``SRT_BVH_SUBBOX`` (2, 4 or 8) the ``two_level`` and ``streamed``
variants take the sub-box form (``_subbox_word`` and ``_mt_gated_sub``,
the JAX package's fourth culling level) where ``ops/bvh._sub_box_rows``
allows it: when the walk takes a super, its 16 clusters' rows of the
sub-box table (``Clusters.sub_aabb`` coarsened by
``ops/bvh.coarsen_sub_aabb``, 4 KB a super) come in one bulk copy, and
each lane slabs the ``div`` sub-boxes of every cluster of it that it
admits, then runs MT only over the slot ranges it meets; a launch in that
form is counted as "<variant>/subbox".  ``flat`` never gates sub-boxes.

Under ``SRT_BVH_MT=plucker`` the ``two_level`` and ``streamed`` variants
take the Plucker form of Moller-Trumbore (``_mt_update_sub_mxu`` and
``_plucker_lt``, row 5a) where ``ops/bvh.resolve_plucker`` grants it:
each slot's coefficients come from ``ops/bvh.plucker_coefficients``, built
once per scene, and a launch is counted as "<variant>/plucker".

``intersect_triangles_bvh`` takes the plain version only for rays on the
CPU.  For rays on a CUDA device it launches the kernel or raises: there
is no fallback.  A launch orders the groups front to back and, with
``compact``, compacts the rays (those that enter an admission box first,
as ``ops/bvh.compact_order`` orders them, their count left in device
memory) on the card before the walk, so no bounce waits on the host.
The kernel is built on first use (``ops/cuda/build.py``).

The JAX package's opt-in switches of this kernel, each read at each call
as there; none changes a result:
  - ``SRT_BVH_ORDER=rev`` visits the groups back to front
    (``ops/bvh.reverse_order``; ``BvhOptions.reverse``), never the
    compaction's rank;
  - ``SRT_BVH_COMPACT_KEY=morton`` sorts the compaction by the origins'
    Morton cells (``ops/bvh.compact_key``): the card makes each ray's
    packed key (``srt_bvh_morton_keys``) and ``torch.sort`` orders them,
    as the JAX package's ``lax.sort`` does, before the walk (a launch in
    that form counts as "<variant>/.../morton");
  - ``SRT_BVH_DMA_SLOTS`` sets the ring of ``streamed`` (``_kernel_hbm``'s
    DMA slots, ``resolve_dma_slots``): a build of the source of its own
    with ``-DSRT_BVH_STAGES=<v>`` (``ring_kernel``), which the launch uses
    and counts; unset, the port's ring of ``STAGES``;
  - ``sort_rays=True`` (an argument, ``_sort_rays_by_super``) permutes an
    uncompacted ``streamed`` launch's rays by the first super they may
    meet (``ops/bvh.sort_rays_by_super``, PyTorch, as the JAX package
    sorts them in XLA) and scatters the results back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
from typing import Optional

import torch

from .. import bvh
from ..vec import Vec3
from ...utils import metrics
from .build import PACKAGE_DIR, Kernel, interface

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
        ("n_admission", ctypes.c_int32),
        ("alive_u8", ctypes.c_int32),
        ("sub_rows", ctypes.c_int32),
    ]


class BvhOptions(ctypes.Structure):
    """The launch's opt-in switches, by value beside BvhParams; the
    layout of ``BvhOptions`` in the CUDA source."""
    _fields_ = [
        ("reverse", ctypes.c_int32),    # SRT_BVH_ORDER=rev
        ("morton", ctypes.c_int32),     # SRT_BVH_COMPACT_KEY=morton
    ]


# the most boxes a visiting order ranks (the CUDA source's kRankMax): the
# groups
RANK_MAX = 8192
# the C interface's version (srt_bvh_interface in the CUDA source)
INTERFACE = 4
# srt_bvh_launch(ox, oy, oz, dx, dy, dz, alive, t_init, staged, coeffs,
#                gidx, boxes, supers, groups, admission, subboxes, work,
#                perm, count, t_out, slot_out, options, params, stream)
LAUNCH_POINTERS = 21
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * LAUNCH_POINTERS
                   + [BvhOptions, BvhParams, ctypes.c_void_p])
# srt_bvh_count_launch: the same, and the counters before the options
COUNT_ARGTYPES = ([ctypes.c_void_p] * (LAUNCH_POINTERS + 1)
                  + [BvhOptions, BvhParams, ctypes.c_void_p])
# srt_bvh_morton_keys(ox, oy, oz, dx, dy, dz, alive, t_init, admission,
#                     keys, count, params, stream)
MORTON_ARGTYPES = [ctypes.c_void_p] * 11 + [BvhParams, ctypes.c_void_p]
# The warp walk's constants (the CUDA source's defaults): the slots of a
# chunk and the port's ring of chunk buffers, chosen by chip_smoke.py's
# sweep; its warps a block, and the sub-box form's super block and pair
# list a warp, in bytes
CHUNK = 64
STAGES = 2
WALK_WARPS = 4
SUB_BLOCK_BYTES = 4096
SUB_PAIRS_BYTES = 1024
# the counting instance's int64 counters, in the CUDA source's Count order,
# then HIST_BINS: the stagings by the lanes that admit them
COUNTERS = ("walked", "stagings", "chunks", "slots", "pairs", "mt_steps",
            "group_tests", "super_tests", "cluster_tests", "split", "wasted",
            "warps", "box_tests", "sub_tests", "sub_skipped", "chunks_skipped",
            "walk_cycles", "sub_wait_cycles", "sub_word_cycles")
HIST_BINS = ("1", "2", "3-4", "5-8", "9-16", "17-24", "25-31", "32")


def _bind(lib: ctypes.CDLL) -> None:
    version = interface(lib, "srt_bvh_interface")
    if version != INTERFACE:
        raise RuntimeError(f"BVH kernel: the build has C interface "
                           f"{version}, want {INTERFACE}")
    lib.srt_bvh_launch.argtypes = LAUNCH_ARGTYPES
    lib.srt_bvh_launch.restype = ctypes.c_int
    lib.srt_bvh_count_launch.argtypes = COUNT_ARGTYPES
    lib.srt_bvh_count_launch.restype = ctypes.c_int
    lib.srt_bvh_work_words.argtypes = [BvhParams]
    lib.srt_bvh_work_words.restype = ctypes.c_longlong
    lib.srt_bvh_morton_keys.argtypes = MORTON_ARGTYPES
    lib.srt_bvh_morton_keys.restype = ctypes.c_int


KERNEL = Kernel(SOURCE, _bind)
# the builds of other ring depths (SRT_BVH_DMA_SLOTS), by depth
_RINGS = {}
_RINGS_LOCK = threading.Lock()


def ring_kernel(stages: int) -> Kernel:
    """The kernel built with a ring of ``stages`` chunks
    (``-DSRT_BVH_STAGES``, a file of its own under ``build/`` named by the
    depth), built on first use; the port's own depth is ``KERNEL``."""
    if stages == STAGES:
        return KERNEL
    with _RINGS_LOCK:
        if stages not in _RINGS:
            _RINGS[stages] = Kernel(SOURCE, _bind,
                                    [f"-DSRT_BVH_STAGES={stages}"],
                                    tag=f"ring{stages}")
        return _RINGS[stages]


def resolve_dma_slots() -> Optional[int]:
    """The ring depth SRT_BVH_DMA_SLOTS asks of a ``streamed`` launch, read
    at each launch (bvh_kernel._resolve_dma_slots): None when it is unset
    (the port keeps its own ring, STAGES, not the TPU's 8), else the
    depth; a value below 2 raises ValueError in the JAX package's words,
    and one int() refuses raises ValueError too."""
    env = os.environ.get("SRT_BVH_DMA_SLOTS")
    if env is None:
        return None
    v = int(env)
    if v < 2:
        raise ValueError(f"SRT_BVH_DMA_SLOTS must be >= 2, got {v}")
    return v


def walk_shared_bytes(stages: int, plucker: bool, sub_rows: int) -> int:
    """Shared memory a block of the warp walk takes with a ring of
    ``stages`` chunks: the source's walk_smem (each warp's ring of
    CHUNK-slot buffers of staged rows or Plucker coefficients, and in the
    sub-box form its super block and pair list) and its mbarriers."""
    row = 4 * (bvh.PLUCKER_COLS if plucker else bvh.STAGED_COLS)
    sub = 1 if sub_rows else 0
    return WALK_WARPS * (stages * CHUNK * row
                         + sub * (SUB_BLOCK_BYTES + SUB_PAIRS_BYTES)
                         + (stages + sub) * 8)


def check_ring(stages: int, plucker: bool, sub_rows: int, limit: int) -> None:
    """Raise ValueError, before any launch, when the walk's ring of
    ``stages`` chunks does not fit the ``limit`` bytes of shared memory a
    block may opt in to (227 KB on an H100)."""
    need = walk_shared_bytes(stages, plucker, sub_rows)
    if need > limit:
        raise ValueError(f"SRT_BVH_DMA_SLOTS={stages}: the BVH walk's ring "
                         f"takes {need} B of shared memory a block, above "
                         f"the device's limit of {limit} B")


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
    # (R,) o.x, o.y, o.z, d.x, d.y, d.z, alive (bool or f32), t_init
    rays: tuple
    # staged (or None), coeffs (or None), gidx, boxes, supers, groups,
    # admission (or None), subboxes (or None): the kernel's tables
    tensors: tuple
    work: torch.Tensor               # int32 scratch (srt_bvh_work_words)
    # with a compaction, written by each launch: the (R,) int32 ray order
    # (the admitted rays first) and the (1,) int32 count of admitted rays
    perm: Optional[torch.Tensor]
    count: Optional[torch.Tensor]
    variant: str
    params: BvhParams
    options: BvhOptions = dataclasses.field(default_factory=BvhOptions)
    # under the Morton key: the (R,) int32 packed keys, made by each launch
    keys: Optional[torch.Tensor] = None
    # the ring depth of the build it launches (None: KERNEL's, STAGES)
    stages: Optional[int] = None

    @property
    def label(self) -> str:
        """The variant as counted: "<variant>/plucker" or
        "<variant>/subbox" for those forms, and "/morton" after it under
        the Morton key."""
        return (self.variant
                + ("/plucker" if self.params.plucker else
                   "/subbox" if self.params.sub_rows else "")
                + ("/morton" if self.options.morton else ""))

    @property
    def kernel(self) -> Kernel:
        """The build it launches: KERNEL, or the ring's of ``stages``."""
        return KERNEL if self.stages is None else ring_kernel(self.stages)

    @property
    def device(self) -> torch.device:
        return self.rays[0].device


def _ray(t: torch.Tensor, n: int, device, dtype=torch.float32):
    if t.shape != (n,) or t.device != device:
        raise ValueError(f"BVH kernel: a ray array {tuple(t.shape)} on "
                         f"{t.device}, want ({n},) on {device}")
    return t.to(dtype).contiguous()


def sub_box_gate(clusters, variant: str):
    """(sub_aabb, sub_div) a launch of ``variant`` gates sub-boxes with,
    as the plain version takes them: ``ops/bvh.maybe_sub_aabb`` for
    ``two_level`` and ``streamed`` (_kernel_packed and _kernel_hbm), never
    for ``flat`` (_kernel), which gets (None, 8)."""
    return (None, 8) if variant == "flat" else bvh.maybe_sub_aabb(clusters)


def launch_tables(clusters, table: torch.Tensor, variant: str,
                  compact: bool):
    """The tables a launch of ``variant`` reads: ((staged, coeffs, gidx,
    boxes, supers, groups, admission, subboxes), the visiting order's
    boxes (the groups), whether it takes the Plucker form, the slots a
    sub-box bounds (0: no sub-box gate)).  The MT form is resolved here
    (``ops/bvh.resolve_plucker``): the warp walk reads
    ``bvh.staged_slots`` in the MT form and ``bvh.plucker_coefficients``
    in the Plucker form (never ``flat``), each built on first use (the
    other None), and the hierarchy's boxes (padded with sentinels to whole
    groups), supers and groups; the admission boxes with ``compact``, else
    None; the sub-box table coarsened to the launch's division
    (``bvh.coarsen_sub_aabb``) where ``bvh._sub_box_rows`` gates, else
    None."""
    hier = clusters.hierarchy
    coeffs = staged = subboxes = None
    plucker = bvh.resolve_plucker(clusters, variant)
    if plucker:
        coeffs = bvh.plucker_coefficients(clusters, table)
    else:
        staged = bvh.staged_slots(clusters, table)
    sub, div = sub_box_gate(clusters, variant)
    sub_rows = bvh._sub_box_rows(clusters.k, sub, div)
    if sub_rows:
        subboxes = bvh.coarsen_sub_aabb(sub, div)
    return ((staged, coeffs, hier.gidx, hier.boxes, hier.supers,
             hier.groups, hier.admission if compact else None, subboxes),
            hier.groups.shape[0], plucker, sub_rows)


def prepare(o: Vec3, d: Vec3, alive: torch.Tensor, t_init: torch.Tensor,
            clusters, table: torch.Tensor, compact: bool = False,
            force_streamed: bool = False) -> Prepared:
    """Check a CUDA launch's arguments and pack them (``launch_tables``);
    with ``compact`` the launch first orders the rays by the compaction
    (admitted rays first, ``perm`` and ``count``), on the card."""
    device = o.x.device
    if device.type != "cuda":
        raise ValueError(f"BVH kernel: unsupported device {device}")
    variant = bvh_variant(clusters, force_streamed)
    n_rays = o.x.shape[0]
    if n_rays >= 2 ** 31 - 1024:
        raise ValueError(f"BVH kernel: {n_rays} rays overflow int32")
    n_cl, k = clusters.slots.shape
    tensors, n_order, plucker, sub_rows = launch_tables(clusters, table,
                                                        variant, compact)
    staged, coeffs, gidx, boxes, supers, groups, admission, subboxes = tensors
    rows = coeffs if plucker else staged
    if (rows.device != device or rows.dtype != torch.float32
            or rows.shape != (n_cl * k, bvh.PLUCKER_COLS if plucker
                              else bvh.STAGED_COLS)
            or not rows.is_contiguous() or rows.data_ptr() % 16):
        raise ValueError("BVH kernel: bad "
                         + ("Plucker coefficient" if plucker
                            else "staged slot") + " table")
    alive_u8 = alive.dtype == torch.bool
    rays = tuple(_ray(t, n_rays, device) for t in (o.x, o.y, o.z, d.x, d.y,
                                                     d.z))
    rays += (_ray(alive, n_rays, device,
                  torch.bool if alive_u8 else torch.float32),
             _ray(t_init, n_rays, device))
    for name, t, dtype in zip(
            ("slot indices", "boxes", "supers", "groups", "admission boxes",
             "sub-boxes"),
            (gidx, boxes, supers, groups, admission, subboxes),
            (torch.int32, torch.float32, torch.float32, torch.float32,
             torch.float32, torch.float32)):
        if t is not None and (t.device != device or t.dtype != dtype
                              or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"BVH kernel: bad {name} {t.dtype} on "
                             f"{t.device}")
    if table.shape != (n_cl * k, 20) or gidx.shape != (n_cl * k,):
        raise ValueError(f"BVH kernel: table {tuple(table.shape)} for "
                         f"{n_cl} clusters of {k}")
    if subboxes is not None and subboxes.shape != (n_cl * 8, 8):
        raise ValueError(f"BVH kernel: sub-boxes {tuple(subboxes.shape)} "
                         f"for {n_cl} clusters")
    if n_order > RANK_MAX:
        raise ValueError(f"BVH kernel: {n_order} boxes to order, at most "
                         f"{RANK_MAX}")
    stages = resolve_dma_slots() if variant == "streamed" else None
    if stages is not None:
        check_ring(stages, plucker, sub_rows, shared_optin(device))
        if stages == STAGES:
            stages = None
    p = BvhParams()
    p.n_rays, p.n_order, p.n_clusters, p.k = n_rays, n_order, n_cl, k
    p.variant = VARIANTS[variant]
    p.plucker = int(plucker)
    p.n_admission = admission.shape[0] if compact else 0
    p.alive_u8 = int(alive_u8)
    p.sub_rows = sub_rows
    opt = BvhOptions()
    opt.reverse = int(bvh.reverse_order())
    opt.morton = int(compact and bvh.compact_key(n_rays) == "morton")
    if not 0 < p.n_admission <= bvh.ADMISSION_MAX and compact:
        raise ValueError(f"BVH kernel: {p.n_admission} admission boxes")
    work = torch.empty(KERNEL.library().srt_bvh_work_words(p),
                       dtype=torch.int32, device=device)
    perm = cnt = keys = None
    if compact:
        perm = torch.empty(n_rays, dtype=torch.int32, device=device)
        cnt = torch.empty(1, dtype=torch.int32, device=device)
    if opt.morton:
        keys = torch.empty(n_rays, dtype=torch.int32, device=device)
    return Prepared(rays, tensors, work, perm, cnt, variant, p, opt, keys,
                    stages)


def shared_optin(device: torch.device) -> int:
    """The dynamic shared memory a block of ``device`` may opt in to."""
    from .trace_kernel import shared_limit
    return shared_limit(device.index if device.index is not None
                        else torch.cuda.current_device())


def _outputs(prep: Prepared, out):
    n = prep.params.n_rays
    device = prep.device
    if out is None:
        return (torch.empty(n, dtype=torch.float32, device=device),
                torch.empty(n, dtype=torch.int32, device=device))
    if any(t.shape != (n,) or t.dtype != dtype or t.device != device
           or not t.is_contiguous()
           for t, dtype in zip(out, (torch.float32, torch.int32))):
        raise ValueError("BVH kernel: bad output tensors")
    return out


def _args(prep: Prepared, out) -> list:
    ptr = lambda t: None if t is None else t.data_ptr()
    return ([t.data_ptr() for t in prep.rays] + [ptr(t) for t in prep.tensors]
            + [prep.work.data_ptr(), ptr(prep.perm), ptr(prep.count),
               out[0].data_ptr(), out[1].data_ptr()])


def _morton_order(prep: Prepared, kernel: Kernel, stream) -> None:
    """Under the Morton key: each ray's packed key and the admitted
    count on the card (srt_bvh_morton_keys), then the keys sorted into
    ``perm`` (their low bits, the ray indices), on the same stream."""
    p = prep.params
    admission = prep.tensors[6]
    err = kernel.library().srt_bvh_morton_keys(
        *[t.data_ptr() for t in prep.rays], admission.data_ptr(),
        prep.keys.data_ptr(), prep.count.data_ptr(), p, stream)
    kernel.check(err, "BVH kernel (Morton keys)")
    mask = (1 << bvh.index_bits(p.n_rays)) - 1
    torch.bitwise_and(torch.sort(prep.keys).values, mask, out=prep.perm)


def launch(prep: Prepared, out=None):
    """Launch on the current stream into ``out`` ((R,) f32 t, (R,) int32
    slot; allocated when not given) and count the launch on its build
    (``Prepared.kernel``): the visiting order (and the compaction) on the
    card, then the walk."""
    out = _outputs(prep, out)
    kernel = prep.kernel
    lib = kernel.library()
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        if prep.options.morton:
            _morton_order(prep, kernel, stream)
        err = lib.srt_bvh_launch(*_args(prep, out), prep.options,
                                 prep.params, stream)
    kernel.check(err, "BVH kernel")
    kernel.count(prep.label)
    return out


def launch_counted(prep: Prepared):
    """One launch of the kernel's counting instance (a kernel of its own,
    which the route never launches; it is not counted with the route's
    launches): ((t, slot), what the walk did by ``COUNTERS`` name, with
    the (warp, cluster) visits by admitting lanes under "hist")."""
    out = _outputs(prep, None)
    counters = torch.zeros(len(COUNTERS) + len(HIST_BINS),
                           dtype=torch.int64, device=prep.device)
    kernel = prep.kernel
    lib = kernel.library()
    with torch.cuda.device(prep.device):
        stream = torch.cuda.current_stream(prep.device).cuda_stream
        if prep.options.morton:
            _morton_order(prep, kernel, stream)
        err = lib.srt_bvh_count_launch(*_args(prep, out),
                                       counters.data_ptr(), prep.options,
                                       prep.params, stream)
    kernel.check(err, "BVH kernel (counting)")
    values = counters.tolist()
    res = dict(zip(COUNTERS, values))
    res["hist"] = dict(zip(HIST_BINS, values[len(COUNTERS):]))
    return out, res


def intersect_triangles_bvh(o: Vec3, d: Vec3, alive: torch.Tensor,
                            t_init: torch.Tensor, clusters,
                            table: torch.Tensor, compact: bool = False,
                            force_streamed: bool = False,
                            sort_rays: bool = False):
    """(R,) rays x a clustered mesh -> (t f32, slot int32): the nearest
    triangle hit strictly closer than ``t_init`` per live ray and the
    table slot of its triangle, (+inf, -1) where none is
    (``ops/bvh.triangle_index`` maps a slot to the triangle's index).
    ``compact`` walks only the rays that enter an admission box, under the
    key SRT_BVH_COMPACT_KEY asks (``ops/bvh.compact_key``);
    ``force_streamed`` takes the streamed variant for any table;
    ``sort_rays`` (off, as in the JAX package, which measured it 13x
    slower on the TPU) permutes an uncompacted ``streamed`` launch's rays
    by ``sort_rays_order`` and returns each result in its ray's place.
    None of them changes a live ray's result.  The MT form follows
    SRT_BVH_MT (``ops/bvh.resolve_plucker``) and the sub-box gate
    SRT_BVH_SUBBOX (``sub_box_gate``), on the CPU as on the card.  A
    compacting call feeds the counters (``count_compaction``)."""
    variant = bvh_variant(clusters, force_streamed)
    if sort_rays and not compact and variant == "streamed":
        perm = sort_rays_order(o, d, alive, t_init, clusters)
        take = lambda v: v[perm]
        t_s, s_s = intersect_triangles_bvh(
            Vec3(take(o.x), take(o.y), take(o.z)),
            Vec3(take(d.x), take(d.y), take(d.z)), take(alive),
            take(t_init), clusters, table, False, force_streamed)
        t, slot = torch.empty_like(t_s), torch.empty_like(s_s)
        t[perm] = t_s
        slot[perm] = s_s
        return t, slot
    if o.x.device.type == "cpu":
        form = "plucker" if bvh.resolve_plucker(clusters, variant) else "mt"
        sub = sub_box_gate(clusters, variant)
        if compact:
            order, count = bvh.compact_order(
                o, d, alive, t_init, clusters.hierarchy.admission,
                bvh.compact_key(o.x.shape[0]))
            count_compaction(o.x.shape[0], count)
            return bvh.intersect_compacted_plain(o, d, alive, t_init,
                                                 clusters, table, order,
                                                 int(count), form, *sub)
        return bvh.intersect_triangles_bvh_plain(o, d, alive, t_init,
                                                 clusters, table, form, *sub)
    prep = prepare(o, d, alive, t_init, clusters, table, compact,
                   force_streamed)
    out = launch(prep)
    if compact:
        count_compaction(o.x.shape[0], prep.count)
    return out


def count_compaction(n_rays: int, admitted: torch.Tensor) -> None:
    """A compacting launch's rays and the rays it admitted (its count, on
    the device) into the counters ``bvh.compacted_rays`` and
    ``bvh.admitted``, while they are on."""
    metrics.count("bvh.compacted_rays", n_rays)
    metrics.count("bvh.admitted", admitted)


def sort_rays_order(o: Vec3, d: Vec3, alive: torch.Tensor,
                    t_init: torch.Tensor, clusters) -> torch.Tensor:
    """``sort_rays``' permutation of a launch's rays: ``bvh.
    sort_rays_by_super`` over the hierarchy's supers (the JAX wrapper's
    super_aabb, padded to whole groups) in their visiting order of these
    rays (``bvh.front_to_back``, reversed under SRT_BVH_ORDER=rev)."""
    supers = clusters.hierarchy.supers
    order = bvh.front_to_back(supers, o, alive > 0, bvh.reverse_order())
    return bvh.sort_rays_by_super(o, d, alive, t_init, supers, order)
