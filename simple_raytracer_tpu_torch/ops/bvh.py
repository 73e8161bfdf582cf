"""BVH clusters on the per-bounce paths: the host side of
``simple_raytracer_tpu/ops/pallas/bvh_kernel.py`` and the plain version of
the Hopper BVH kernel (``csrc/bvh_kernel.cu``, wrapped by
``ops/cuda/bvh_kernel.py``).

A clustered mesh is C clusters of K triangle slots, each with its box.
``build_hierarchy`` adds, once per scene, the coarser levels the kernel
variants and the plain version gate with: supers of ``SUPER`` clusters
and groups of ``GROUP`` supers (sentinel-aware unions, ``union_boxes8``),
and the admission boxes of the ray compaction.

Every gate is the slab test of ``_visit_prepass`` (``slab_maybe``): the
interval [near, far] is closed, far is capped by the ray's bound, the
``near >= 1e38`` term rejects the 3e38 padding boxes, and a NaN (0 * inf
on a box plane) counts as a hit.  There is no margin.

``intersect_triangles_bvh_plain`` is the plain version of the kernel: the
slab test of every admitted (live ray, cluster) pair against the ray's
``t_init``, Moller-Trumbore on every slot of every admitted cluster (in
the broadcast form of ``_mt_update``, or under ``form="plucker"`` in the
Plucker form of ``_mt_update_sub_mxu``), and the commit rule of
``_mt_update``: the lexicographic least (t, global index) wins, seeded
with (t_init, -1), so only triangle hits strictly closer than t_init are
reported.  The pairs come through the hierarchy's gates, groups, then
supers, then clusters, each the same closed slab test against t_init; a
union box contains its members, so the coarse gates reject no pair the
cluster's own test admits, and the result is that of testing every
(ray, cluster) pair.  It is chunked, so config 7's
11,008 clusters stay within memory.  It reports the winner's table slot,
whose row the caller shades from.

The sub-box gate (``SRT_BVH_SUBBOX``, ``maybe_sub_aabb``) is the JAX
package's fourth culling level: a cluster's 8 slot-range sub-boxes
(``Clusters.sub_aabb``, built by the scene only under the knob), unioned
into ``div`` wider ones (``coarsen_sub_aabb``), gate each admitted pair's
MT range by range.  ``_sub_box_rows`` is the one rule of where it runs
(a table, K % (8 * div) == 0, a single packet), which the plain version
and the kernel's wrapper both read; it never changes a result.

The Plucker form (``SRT_BVH_MT=plucker``, ``mt_form``) evaluates the
same predicate from per-slot coefficients (``plucker_table``, built once
per scene and cached on the clusters) dotted with the per-ray vector
[d, o x d, o, 1]; ``resolve_plucker`` decides, by the JAX package's
``_resolve_plucker`` rule, whether a launch takes it.

``compact_order`` is ``_compact_prefix``: the rays sorted by their
bucket, under the "super" key the front-to-back rank of the first
admission box they enter and their direction octant, under the "morton"
key (``SRT_BVH_COMPACT_KEY``, ``resolve_sort_key``) their origin's Morton
cell over the admission boxes' bounds and their octant, the rays that
enter none last, and the count of those that enter one.  No order changes
a result.  It is the plain version of the card's compaction, which runs
inside the kernel's launch (the Morton keys are sorted beside it) and
admits the same rays.  ``resolve_compact_cap`` and ``compacts`` are the
JAX package's compaction policy, ``SRT_BVH_COMPACT`` and
``SRT_BVH_COMPACT_CAP`` included.

``front_to_back`` is the visiting order (``SRT_BVH_ORDER=rev`` reverses
it, ``reverse_order``; never the compaction's rank), and
``sort_rays_by_super`` the permutation of the wrapper's ``sort_rays``.

``stage_slots`` is the kernel's warp walk's own layout of the slot table
(48 bytes a slot, the columns Moller-Trumbore reads), kept per scene by
``staged_slots``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Optional

import torch

from .vec import Vec3

SUPER = 16           # clusters per super (bvh_kernel._SUPER)
GROUP = 16           # supers per group (bvh_kernel._GROUP)
SENTINEL = 3.0e38    # every plane of a padding box
ADMISSION_MAX = 256  # the compaction's admission boxes, at most
# the TPU's table residency limits: a row table of at most this many slots
# stays resident (bvh_kernel.VMEM_TABLE_MAX_SLOTS), a packed one of at
# most this many (24, 128) tiles (PACKED_VMEM_MAX_CLUSTERS, read from
# SRT_BVH_PACKED_VMEM_MAX once, at import, as bvh_kernel.py:1036 reads it)
VMEM_TABLE_MAX_SLOTS = 8192
PACKED_VMEM_MAX_CLUSTERS = int(os.environ.get("SRT_BVH_PACKED_VMEM_MAX",
                                              "800"))
PACKET = 128         # triangles per packed tile
BLOCK_R = 1536       # the TPU wrapper's ray block, compact_cap_auto's unit
# (ray, cluster) pairs x K slots per chunk of the plain version, by device
# type (as triangle.TRI_CHUNK_ELEMS)
PAIR_CHUNK_ELEMS = {"cpu": 2 ** 22, "cuda": 2 ** 26}
_NO_KEY = 2 ** 62
# a slot's Plucker coefficients (plucker_table): the nonzero entries of
# the JAX package's LT planes, in its order
PLUCKER_COLS = 20
# a slot's row in the warp walk's staged table (stage_slots)
STAGED_COLS = 12
# the plain version's calls in the Plucker form, as
# bvh_kernel._PLUCKER_TRACES counts traces (the kernel counts its launches
# in that form as "<variant>/plucker")
PLUCKER_CALLS = 0


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    """The gates above the cluster boxes, built once per scene."""
    boxes: torch.Tensor      # (c_pad, 8) f32 cluster boxes, padded with
                             # sentinels to a multiple of SUPER * GROUP
    supers: torch.Tensor     # (c_pad / SUPER, 8) f32
    groups: torch.Tensor     # (c_pad / (SUPER * GROUP), 8) f32
    admission: torch.Tensor  # (<= ADMISSION_MAX, 8) f32
    gidx: torch.Tensor       # (C * K,) int32 triangle index of each slot,
                             # -1 for an empty one


def union_boxes8(stack: torch.Tensor) -> torch.Tensor:
    """Sentinel-aware union over axis -2 of a (..., G, 8) box stack
    (bvh_kernel._union_boxes8): members with lo >= 1e37 do not count, and
    a union of none is a sentinel box.  Columns 6:8 are zero."""
    real = stack[..., 0] < 1.0e37
    lo = torch.where(real[..., None], stack[..., 0:3], SENTINEL).amin(dim=-2)
    hi = torch.where(real[..., None], stack[..., 3:6], -SENTINEL).amax(dim=-2)
    empty = hi[..., 0:1] < lo[..., 0:1]
    lo = torch.where(empty, SENTINEL, lo)
    hi = torch.where(empty, SENTINEL, hi)
    return torch.cat([lo, hi, torch.zeros_like(lo[..., :2])], dim=-1)


def pad_boxes(boxes: torch.Tensor, quantum: int) -> torch.Tensor:
    """Append sentinel boxes up to a multiple of ``quantum`` rows."""
    pad = (-boxes.shape[0]) % quantum
    if not pad:
        return boxes
    sent = torch.full((pad, 8), SENTINEL, dtype=boxes.dtype,
                      device=boxes.device)
    sent[:, 6:] = 0.0
    return torch.cat([boxes, sent])


def admission_boxes(aabb: torch.Tensor) -> torch.Tensor:
    """bvh_kernel._admission_boxes: the SUPER-way unions of the cluster
    boxes, unioned again in SUPER groups until at most ADMISSION_MAX
    remain."""
    boxes = union_boxes8(pad_boxes(aabb, SUPER).reshape(-1, SUPER, 8))
    while boxes.shape[0] > ADMISSION_MAX:
        boxes = union_boxes8(pad_boxes(boxes, SUPER).reshape(-1, SUPER, 8))
    return boxes


def build_hierarchy(aabb: torch.Tensor, slots: torch.Tensor) -> Hierarchy:
    """The supers, groups and admission boxes of a (C, 8) box table, and
    the int32 slot indices of its (C, K) slots."""
    boxes = pad_boxes(aabb, SUPER * GROUP)
    supers = union_boxes8(boxes.reshape(-1, SUPER, 8))
    groups = union_boxes8(supers.reshape(-1, GROUP, 8))
    return Hierarchy(boxes=boxes, supers=supers, groups=groups,
                     admission=admission_boxes(aabb),
                     gidx=slots.reshape(-1).to(torch.int32).contiguous())


def table_streams_hbm(clusters) -> bool:
    """bvh_kernel.table_streams_hbm: would the TPU stream this table from
    HBM (neither the row table nor the packed one resident)?  It flips
    the bounce-0 compaction policy."""
    if clusters is None:
        return False
    if clusters.slots.numel() <= VMEM_TABLE_MAX_SLOTS:
        return False
    k = clusters.k
    if not packable(k):
        return True       # no packed table
    packets = (k + PACKET - 1) // PACKET
    return clusters.slots.shape[0] * packets > PACKED_VMEM_MAX_CLUSTERS


def packable(k: int) -> bool:
    """Does the TPU pack a table of K-slot clusters into (24, 128) tiles
    (Scene.build's table_tr rule)?"""
    return k <= PACKET or k % PACKET == 0


def mt_form() -> str:
    """The Moller-Trumbore form SRT_BVH_MT asks for, read at each call
    (bvh_kernel._mt_form): "plucker", or else "mt"."""
    return ("plucker" if os.environ.get("SRT_BVH_MT", "mt") == "plucker"
            else "mt")


def maybe_sub_aabb(clusters):
    """(sub_aabb, sub_div) as the SRT_BVH_SUBBOX knob asks, read at each
    call (bvh_kernel.maybe_sub_aabb): "0" or unset, or clusters built
    without a sub-box table, gives (None, 8); "2", "4" or "8" that many
    sub-boxes a cluster ("1": 8); any other value raises."""
    v = os.environ.get("SRT_BVH_SUBBOX", "0")
    if v == "0" or clusters.sub_aabb is None:
        return None, 8
    if v not in ("1", "2", "4", "8"):
        raise ValueError(f"SRT_BVH_SUBBOX must be 0/1/2/4/8, got {v!r}")
    return clusters.sub_aabb, 8 if v == "1" else int(v)


def _sub_box_rows(k: int, sub_aabb, div: int) -> int:
    """The slots a sub-box bounds in a launch over K-slot clusters, 0 for
    no sub-box gate: the rule of intersect_triangles_bvh, a sub-box table
    (``maybe_sub_aabb``), K % (8 * div) == 0 and a single packet.  The
    plain version and the kernel's wrapper both read it; "flat" (the TPU's
    _kernel) never gates sub-boxes, so its callers pass no table."""
    packets = -(-k // PACKET) if packable(k) else 1
    return (k // div if sub_aabb is not None and k % (8 * div) == 0
            and packets == 1 else 0)


def coarsen_sub_aabb(sub_aabb: torch.Tensor, div: int) -> torch.Tensor:
    """(C * 8, 8) sub-box table -> the same shape with each cluster's 8
    slot-range boxes unioned into ``div`` wider ones (rows 0 to div - 1
    of the cluster; the rest sentinel boxes): box j then bounds slots
    [j * K / div, (j + 1) * K / div) (bvh_kernel.coarsen_sub_aabb)."""
    if div == 8:
        return sub_aabb
    boxes = union_boxes8(sub_aabb.reshape(-1, div, 8 // div, 8))
    pad = torch.zeros(boxes.shape[0], 8 - div, 8, dtype=boxes.dtype,
                      device=boxes.device)
    pad[..., 0:6] = SENTINEL
    return torch.cat([boxes, pad], dim=1).reshape(sub_aabb.shape)


def resolve_plucker(clusters, variant: str) -> bool:
    """Does a launch of kernel ``variant`` over ``clusters`` take the
    Plucker form?  bvh_kernel._resolve_plucker's rule: only when
    SRT_BVH_MT asks for it, in "two_level" (_kernel_packed) and in
    "streamed" over a table the TPU packs (_kernel_hbm over table_tr),
    and only where the JAX package would not gate sub-boxes.  "flat"
    (_kernel, which never asks) quietly keeps MT; every other refusal
    warns in _resolve_plucker's words and keeps MT."""
    if mt_form() != "plucker" or variant == "flat":
        return False
    packed = variant == "two_level" or packable(clusters.k)
    sub_rows = _sub_box_rows(clusters.k, *maybe_sub_aabb(clusters))
    if packed and sub_rows == 0:
        return True
    why = [] if packed else ["the triangle table is not packed"]
    if sub_rows != 0:
        why.append("sub-box gating is on (SRT_BVH_SUBBOX)")
    warnings.warn("SRT_BVH_MT=plucker ignored: " + " and ".join(why)
                  + "; tracing the VPU 'mt' form instead", stacklevel=3)
    return False


def compact_cap_auto(n_rays: int, block_r: int = BLOCK_R) -> Optional[int]:
    """bvh_kernel.compact_cap_auto: 1/20 of the rays, in whole blocks, at
    least 16 blocks; None (no compaction) below 64 blocks.  On the card
    only its None decides anything: whether a bounce compacts."""
    if n_rays < 64 * block_r:
        return None
    blocks = -(-n_rays // (20 * block_r))
    return max(blocks, 16) * block_r


def resolve_compact_cap(n_rays: int, compact="auto") -> Optional[int]:
    """The compaction policy of the JAX package's BVH call sites
    (intersect.resolve_compact_cap): ``compact`` is "auto" (the cap of
    compact_cap_auto), an int cap, or None or 0 (off).  SRT_BVH_COMPACT,
    read at each call, overrides it: "0" off, "auto", or an int cap (which
    compacts every bounce, bounce 0 included); under "auto"
    SRT_BVH_COMPACT_CAP sizes the cap without flattening the per-bounce
    policy.  A value int() refuses raises ValueError.

    The TPU wrapper compacts the first ``cap`` rays of the order and falls
    back to the dense kernel when more rays admit.  The card's compaction
    walks every admitted ray, so here a cap decides only whether a bounce
    compacts (``compacts``); no cap changes a result."""
    env = os.environ.get("SRT_BVH_COMPACT")
    if env is not None:
        compact = "auto" if env == "auto" else (int(env) or None)
    if compact == "auto":
        cap_env = os.environ.get("SRT_BVH_COMPACT_CAP")
        if cap_env:
            return int(cap_env)
        return compact_cap_auto(n_rays)
    return compact or None


def index_bits(n_rays: int) -> int:
    """The bits of a ray index in the compaction's packed key; the other
    31 - index_bits are the bucket's (_compact_prefix)."""
    return max((n_rays - 1).bit_length(), 1)


def compacts(n_rays: int, compact="auto") -> bool:
    """Whether a bounce of ``n_rays`` rays takes the compacted route: a cap
    from ``resolve_compact_cap(n_rays, compact)`` below the ray count, and
    room for the key's bucket bits beside the ray index
    (intersect_triangles_bvh_compact)."""
    cap = resolve_compact_cap(n_rays, compact)
    return bool(cap) and cap < n_rays and 31 - index_bits(n_rays) >= 4


def resolve_sort_key(bucket_bits: int) -> str:
    """The compaction's key (bvh_kernel._resolve_sort_key, whose callers
    pass no key of their own): "super" (the rank of the first admission
    box a ray enters) or "morton" (its origin's Morton cell), as
    SRT_BVH_COMPACT_KEY asks, read at each call: "super", "morton" or
    "auto" (as unset: "super"); any other value raises ValueError.
    "morton" falls back to "super" below 6 bucket bits."""
    env = os.environ.get("SRT_BVH_COMPACT_KEY")
    if env and env not in ("super", "morton", "auto"):
        raise ValueError(
            f"SRT_BVH_COMPACT_KEY must be super/morton/auto: {env!r}")
    if env == "morton" and bucket_bits >= 6:
        return "morton"
    return "super"


def compact_key(n_rays: int) -> str:
    """The key a compacted launch of ``n_rays`` rays sorts by
    (``resolve_sort_key`` at its bucket bits)."""
    return resolve_sort_key(31 - index_bits(n_rays))


def reverse_order() -> bool:
    """Does SRT_BVH_ORDER ask for the visiting order back to front?  Read
    at each call, as the JAX front_to_back reads it ("rev"; a debug knob
    that measures what the order buys)."""
    return os.environ.get("SRT_BVH_ORDER") == "rev"


def inverse(d: Vec3) -> Vec3:
    return Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)


def _slab(col, o: Vec3, inv: Vec3, t_far: torch.Tensor) -> torch.Tensor:
    """_visit_prepass's slab test in its operation order, for box columns
    ``col(j)`` and rays that broadcast against each other;
    torch.minimum/maximum propagate NaN as jnp's do."""
    t1x = (col(0) - o.x) * inv.x
    t2x = (col(3) - o.x) * inv.x
    t1y = (col(1) - o.y) * inv.y
    t2y = (col(4) - o.y) * inv.y
    t1z = (col(2) - o.z) * inv.z
    t2z = (col(5) - o.z) * inv.z
    mn, mx = torch.minimum, torch.maximum
    near = mx(mx(mn(t1x, t2x), mn(t1y, t2y)), mn(t1z, t2z).clamp_min(0.0))
    far = mn(mn(mx(t1x, t2x), mx(t1y, t2y)), mn(mx(t1z, t2z), t_far))
    return ~((near > far) | (near >= 1.0e38))


def slab_maybe(boxes: torch.Tensor, o: Vec3, inv: Vec3,
               t_far: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(N, 8) boxes x (R,) rays -> (N, R) bool: may the live ray meet the
    box before ``t_far``?"""
    row = lambda v: Vec3(v.x[None], v.y[None], v.z[None])
    return _slab(lambda j: boxes[:, j, None], row(o), row(inv),
                 t_far[None]) & live[None]


def slab_pairs(boxes: torch.Tensor, o: Vec3, inv: Vec3,
               t_far: torch.Tensor) -> torch.Tensor:
    """(P, 8) boxes and (P,) rays, pair by pair -> (P,) bool: the same
    test as ``slab_maybe``."""
    return _slab(lambda j: boxes[:, j], o, inv, t_far)


def front_to_back(boxes: torch.Tensor, o: Vec3, alive: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """The boxes' visiting order (int32): ascending squared distance of
    their centers from the mean live-ray origin (intersect_triangles_bvh's
    front_to_back; ``reverse``, the knob's ``reverse_order``, negates the
    distance, as SRT_BVH_ORDER=rev does there).  Sentinels sort last, or
    under ``reverse`` first.  The order changes no result.  The
    compaction's rank (``compact_order``) never reverses: _compact_prefix
    computes its own distance."""
    w = alive.to(torch.float32)
    origin = torch.stack([(o.x * w).sum(), (o.y * w).sum(), (o.z * w).sum()]
                         ) / w.sum().clamp_min(1.0)
    centers = (boxes[:, 0:3] + boxes[:, 3:6]) * 0.5
    d2 = ((centers - origin[None, :]) ** 2).sum(dim=1)
    if reverse:
        d2 = -d2
    return torch.argsort(d2, stable=True).to(torch.int32)


def morton_cells(o: Vec3, admission: torch.Tensor,
                 bucket_bits: int) -> torch.Tensor:
    """(R,) int64: each origin's Morton cell over the bounds of the real
    admission boxes (_compact_prefix's "morton" key): ``bucket_bits - 3``
    bits split x, y, z as [(mb + 2) // 3, (mb + 1) // 3, mb // 3], each
    axis quantised as ((v - lo) / span * cells) truncated, saturated and
    clipped to its cells (a NaN to cell 0, as XLA's and CUDA's conversions
    give), the bits interleaved MSB first."""
    mb = bucket_bits - 3
    nbits = [(mb + 2) // 3, (mb + 1) // 3, mb // 3]
    real = admission[:, 0] < 1.0e37
    lo = torch.where(real[:, None], admission[:, 0:3], SENTINEL).amin(dim=0)
    hi = torch.where(real[:, None], admission[:, 3:6], -SENTINEL).amax(dim=0)
    span = (hi - lo).clamp_min(1.0e-20)
    qs = []
    for axis, (v, bits) in enumerate(zip((o.x, o.y, o.z), nbits)):
        cells = float(1 << bits)
        x = (v - lo[axis]) / span[axis] * cells
        x = torch.where(torch.isnan(x), 0.0, x)
        qs.append(x.clamp(0.0, cells - 1.0).to(torch.int64))
    morton = torch.zeros_like(qs[0])
    out_pos = mb
    for level in range(max(nbits)):
        for a in range(3):
            if level < nbits[a]:
                out_pos -= 1
                morton |= ((qs[a] >> (nbits[a] - 1 - level)) & 1) << out_pos
    return morton


def compact_order(o: Vec3, d: Vec3, alive: torch.Tensor,
                  t_init: torch.Tensor, admission: torch.Tensor,
                  key_kind: str = "super"):
    """_compact_prefix -> (order (R,) int64, count 0-d int64 tensor): the
    rays sorted by one packed key, bucket << bits | ray index, whose
    bucket is 8 x the rank of the first admission box the ray enters
    (``key_kind`` "super") or its origin's Morton cell (``morton_cells``,
    "morton") plus its direction octant, clamped to the last real bucket,
    or the last bucket when it enters none; ``count`` rays enter one.
    ``compact_key`` resolves the key a launch takes.  Nothing is read back
    to the host."""
    if key_kind not in ("super", "morton"):
        raise ValueError(f"unknown compaction key {key_kind!r}")
    n_rays = o.x.shape[0]
    n_box = admission.shape[0]
    live = alive > 0
    rank = torch.empty(n_box, dtype=torch.int64, device=admission.device)
    rank[front_to_back(admission, o, live).long()] = torch.arange(
        n_box, device=admission.device)
    maybe = slab_maybe(admission, o, inverse(d), t_init, live)
    first = torch.where(maybe, rank[:, None], n_box).amin(dim=0)
    admitted = first < n_box
    idx_bits = index_bits(n_rays)
    n_buckets = 1 << (31 - idx_bits)
    octant = ((d.x < 0).long() * 4 + (d.y < 0).long() * 2
              + (d.z < 0).long())
    cell = (morton_cells(o, admission, 31 - idx_bits)
            if key_kind == "morton" else first)
    bucket = torch.where(admitted, (cell * 8 + octant).clamp_max(
        n_buckets - 2), n_buckets - 1)
    key = (bucket << idx_bits) | torch.arange(n_rays, device=bucket.device)
    # below 2^31, as the JAX package's int32 key: sorted as int32
    order = torch.sort(key.to(torch.int32)).values.long() & (
        (1 << idx_bits) - 1)
    return order, admitted.sum()


def sort_rays_by_super(o: Vec3, d: Vec3, alive: torch.Tensor,
                       t_init: torch.Tensor, supers: torch.Tensor,
                       order: torch.Tensor) -> torch.Tensor:
    """bvh_kernel._sort_rays_by_super -> (R,) int64 permutation: the rays
    stably sorted by the rank in ``order`` (the supers' visiting order) of
    the first super whose box the live ray may meet before its t_init,
    the rays that meet none and the dead rays last.  The (supers, rays)
    slab tests run a chunk of rays at a time (``PAIR_CHUNK_ELEMS`` tests),
    so config 7's 704 supers x 2M rays never stand in memory at once."""
    n_super = supers.shape[0]
    dev = o.x.device
    rank = torch.empty(n_super, dtype=torch.int64, device=dev)
    rank[order.long()] = torch.arange(n_super, device=dev)
    inv = inverse(d)
    live = alive > 0
    key = torch.empty(o.x.shape, dtype=torch.int64, device=dev)
    chunk = max(1, PAIR_CHUNK_ELEMS.get(dev.type, 2 ** 22) // 4
                // max(n_super, 1))
    for r0 in range(0, o.x.shape[0], chunk):
        rs = slice(r0, r0 + chunk)
        pick = lambda v: Vec3(v.x[rs], v.y[rs], v.z[rs])
        maybe = slab_maybe(supers, pick(o), pick(inv), t_init[rs], live[rs])
        key[rs] = torch.where(maybe, rank[:, None], n_super).amin(dim=0)
    return torch.argsort(key, stable=True)


def stage_slots(table: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """(N, 20) slot rows and their (N,) int32 global indices ->
    (N, STAGED_COLS) f32, the warp walk's MT rows in the slot
    table's order (a cluster's slots are one contiguous copy): v0 and the
    index's int32 bits, e1 and the active flag, e2 and 0, three float4s."""
    out = table.new_zeros((table.shape[0], STAGED_COLS))
    out[:, 0:3] = table[:, 0:3]
    out[:, 3] = gidx.to(torch.int32).view(torch.float32)
    out[:, 4:7] = table[:, 3:6]
    out[:, 7] = table[:, 19]
    out[:, 8:11] = table[:, 6:9]
    return out


def staged_slots(clusters, table: torch.Tensor) -> torch.Tensor:
    """``stage_slots`` of the clusters' slot table, built on first use and
    kept on the clusters (once per scene): only the warp walks read it,
    the BVH kernel's (every variant, in the MT form) and the whole-trace
    kernel's (its ``clustered`` variant)."""
    if clusters.staged is None:
        # the dataclass is frozen; the field is a cache of its table
        object.__setattr__(clusters, "staged",
                           stage_slots(table, clusters.hierarchy.gidx))
    return clusters.staged


def _mt(ox, oy, oz, dx, dy, dz, col):
    """Moller-Trumbore in _mt_update's operation order; ``col(j)`` is
    table column j at each (pair, slot).  Returns (t, valid)."""
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / a
    sx = ox - col(0)
    sy = oy - col(1)
    sz = oz - col(2)
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = ((a != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0) & (col(19) > 0.0))
    return t, valid


def plucker_table(table: torch.Tensor) -> torch.Tensor:
    """(N, 20) slot rows -> (N, PLUCKER_COLS) f32 Plucker coefficients,
    _plucker_lt's in its operation order: with n = e1 x e2, w1 = v0 x e1,
    w2 = v0 x e2 and pd = n . v0, a row is [w2, e2 | -w1, -e1 | -n |
    n, -pd | active], the coefficients of u*a and v*a on [d, o x d], of a
    on d and of t*a on [o, 1] (LT's nonzero entries), and the active
    flag.  An empty slot (a zero row) gives a = 0: never a hit."""
    col = lambda j: table[:, j]
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    w1x = v0y * e1z - v0z * e1y            # v0 x e1
    w1y = v0z * e1x - v0x * e1z
    w1z = v0x * e1y - v0y * e1x
    w2x = v0y * e2z - v0z * e2y            # v0 x e2
    w2y = v0z * e2x - v0x * e2z
    w2z = v0x * e2y - v0y * e2x
    pd = nx * v0x + ny * v0y + nz * v0z    # n . v0
    return torch.stack([w2x, w2y, w2z, e2x, e2y, e2z,
                        -w1x, -w1y, -w1z, -e1x, -e1y, -e1z,
                        -nx, -ny, -nz, nx, ny, nz, -pd, col(19)], dim=1)


def plucker_coefficients(clusters, table: torch.Tensor) -> torch.Tensor:
    """``plucker_table(table)`` of the clusters' slot table, built on first
    use and kept on the clusters (once per scene)."""
    if clusters.plucker is None:
        # the dataclass is frozen; the field is a cache of its table
        object.__setattr__(clusters, "plucker", plucker_table(table))
    return clusters.plucker


def _mt_plucker(ox, oy, oz, dx, dy, dz, col):
    """_mt_update_sub_mxu's arithmetic; ``col(j)`` is Plucker column j
    (plucker_table) at each (pair, slot).  Each numerator is the dot
    product of the coefficients with the ray vector [d, m = o x d, o, 1]
    in its index order, over the nonzero coefficients only (an x * 0 term
    of a finite ray adds a zero and changes no sum).  The same tests as
    ``_mt``.  Returns (t, valid)."""
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    unum = (col(0) * dx + col(1) * dy + col(2) * dz + col(3) * mx
            + col(4) * my + col(5) * mz)
    vnum = (col(6) * dx + col(7) * dy + col(8) * dz + col(9) * mx
            + col(10) * my + col(11) * mz)
    a = col(12) * dx + col(13) * dy + col(14) * dz
    tnum = col(15) * ox + col(16) * oy + col(17) * oz + col(18)
    f = 1.0 / a
    u = f * unum
    v = f * vnum
    t = f * tnum
    valid = ((a != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > 0.0) & (col(19) > 0.0))
    return t, valid


def admitted_pairs(o: Vec3, inv: Vec3, live: torch.Tensor,
                   t_init: torch.Tensor, clusters, elems: int):
    """The (cluster, ray) pairs whose cluster box the live ray may meet
    before its ``t_init``, in chunks of at most about ``elems`` slab tests:
    the groups are tested against every ray, each admitted group's SUPER
    supers against its rays, each admitted super's SUPER clusters against
    theirs.  Yields (cluster index, ray index) int64 pairs."""
    hier = clusters.hierarchy
    n_rays, n_cl = o.x.shape[0], clusters.slots.shape[0]
    dev = o.x.device
    lanes = torch.arange(SUPER, device=dev)   # SUPER == GROUP
    ray_chunk = max(1, elems // max(hier.groups.shape[0], 1))
    group_chunk = max(1, elems // (GROUP * SUPER))
    pick = lambda v, r: Vec3(v.x[r], v.y[r], v.z[r])

    def children(parent, ray, boxes, width):
        """Expand each (parent, ray) pair to the parent's ``width``
        children and keep those whose box the ray may meet."""
        child = (parent[:, None] * width + lanes[None, :width]).reshape(-1)
        ray = ray.repeat_interleave(width)
        keep = slab_pairs(boxes[child], pick(o, ray), pick(inv, ray),
                          t_init[ray])
        return child[keep], ray[keep]

    for r0 in range(0, n_rays, ray_chunk):
        rs = slice(r0, r0 + ray_chunk)
        g, r = slab_maybe(hier.groups, pick(o, rs), pick(inv, rs),
                          t_init[rs], live[rs]).nonzero(as_tuple=True)
        r = r + r0
        for p0 in range(0, g.shape[0], group_chunk):
            sl = slice(p0, p0 + group_chunk)
            s, rs_ = children(g[sl], r[sl], hier.supers, GROUP)
            c, rc = children(s, rs_, hier.boxes, SUPER)
            real = c < n_cl           # the hierarchy's own padding boxes
            yield c[real], rc[real]


def intersect_triangles_bvh_plain(o: Vec3, d: Vec3, alive: torch.Tensor,
                                  t_init: torch.Tensor, clusters,
                                  table: torch.Tensor, form: str = "mt",
                                  sub_aabb: Optional[torch.Tensor] = None,
                                  sub_div: int = 8):
    """(R,) rays x a clustered mesh -> (t (R,) f32, slot (R,) int32): the
    nearest triangle hit strictly closer than ``t_init`` and the table slot
    of its triangle, (+inf, -1) when none is (``triangle_index`` maps a
    slot to the triangle's index).  ``clusters`` carries the (C, 8) boxes
    and the hierarchy, ``table`` the (C * K, 20) slot rows; ``form`` is
    the MT form, "mt" or "plucker" (the form only, never the commit); a
    call in the Plucker form is counted in PLUCKER_CALLS.

    ``sub_aabb`` ((C * 8, 8), ``maybe_sub_aabb``) with ``sub_div`` gates
    each admitted pair's slot ranges where ``_sub_box_rows`` allows it
    (the sub-box form, _mt_gated_sub): the pair runs MT only over the
    ranges of K / div slots whose sub-box (``coarsen_sub_aabb``) the ray
    may meet, by the same slab test as every gate.  Its far bound is the
    ray's t_init, as every gate's here: the kernel's best t when it finds
    the cluster is at most t_init, and a box beyond a ray's best t holds
    no hit that could win, so the result is that of testing every slot."""
    global PLUCKER_CALLS
    n_rays = o.x.shape[0]
    n_cl, k = clusters.slots.shape
    rows = _sub_box_rows(k, sub_aabb, sub_div)
    if rows:
        if form != "mt":
            raise ValueError("the sub-box gate takes the MT form only")
        sub = coarsen_sub_aabb(sub_aabb, k // rows).reshape(
            n_cl, 8, 8)[:, :k // rows]
    dev = o.x.device
    live = alive > 0
    inv = inverse(d)
    if form == "plucker":
        PLUCKER_CALLS += 1
        mt = _mt_plucker
        cols = plucker_coefficients(clusters, table).reshape(
            n_cl, k, PLUCKER_COLS)
    elif form == "mt":
        mt = _mt
        cols = table.reshape(n_cl, k, table.shape[1])
    else:
        raise ValueError(f"unknown MT form {form!r}")
    # a candidate's key: (global index << 32) | slot, so the least key is
    # the least index and carries its slot
    gidx = clusters.hierarchy.gidx.to(torch.int64)
    key = ((gidx << 32) | torch.arange(n_cl * k, device=dev)).reshape(n_cl, k)
    best_t = t_init.clone()
    best_key = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    elems = PAIR_CHUNK_ELEMS.get(dev.type, 2 ** 22)
    pair_chunk = max(1, elems // k)
    for c_all, r_all in admitted_pairs(o, inv, live, t_init, clusters,
                                       elems):
        for p0 in range(0, c_all.shape[0], pair_chunk):
            c_idx = c_all[p0:p0 + pair_chunk]
            r_idx = r_all[p0:p0 + pair_chunk]
            ray = lambda v: v[r_idx][:, None]
            t, valid = mt(ray(o.x), ray(o.y), ray(o.z), ray(d.x), ray(d.y),
                          ray(d.z), lambda j: cols[:, :, j][c_idx])
            if rows:
                boxes = sub[c_idx]                     # (P, div, 8)
                meet = _slab(lambda j: boxes[:, :, j],
                             Vec3(ray(o.x), ray(o.y), ray(o.z)),
                             Vec3(ray(inv.x), ray(inv.y), ray(inv.z)),
                             ray(t_init))              # (P, div)
                valid = valid & meet.repeat_interleave(rows, dim=1)
            t = torch.where(valid, t, math.inf)
            local_t = t.amin(dim=1)
            local_key = torch.where(valid & (t == local_t[:, None]),
                                    key[c_idx], _NO_KEY).amin(dim=1)
            # the lexicographic least (t, index) per ray; the seed's -1
            # keeps an exact tie with t_init
            new_t = best_t.scatter_reduce(0, r_idx, local_t, "amin")
            cand = torch.where(local_t == new_t[r_idx], local_key, _NO_KEY)
            keep = torch.where(best_t == new_t, best_key, _NO_KEY)
            best_key = keep.scatter_reduce(0, r_idx, cand, "amin")
            best_t = new_t
    won = best_key >= 0
    return (torch.where(won, best_t, math.inf),
            torch.where(won, best_key & 0xFFFFFFFF, -1).to(torch.int32))


def triangle_index(clusters, slot: torch.Tensor) -> torch.Tensor:
    """The global triangle index (int32) of each table slot, -1 for -1."""
    gidx = clusters.hierarchy.gidx
    return torch.where(slot >= 0, gidx[slot.clamp_min(0).long()], -1)


def intersect_compacted_plain(o: Vec3, d: Vec3, alive: torch.Tensor,
                              t_init: torch.Tensor, clusters,
                              table: torch.Tensor, order: torch.Tensor,
                              count: int, form: str = "mt",
                              sub_aabb: Optional[torch.Tensor] = None,
                              sub_div: int = 8):
    """The plain version over the first ``count`` rays of ``order`` only;
    every other ray reports a miss, as the kernel's compacted launch
    does."""
    sel = order[:count]
    pick = lambda v: Vec3(v.x[sel], v.y[sel], v.z[sel])
    t_c, s_c = intersect_triangles_bvh_plain(pick(o), pick(d), alive[sel],
                                             t_init[sel], clusters, table,
                                             form, sub_aabb, sub_div)
    t = torch.full_like(o.x, math.inf)
    slot = torch.full(o.x.shape, -1, dtype=torch.int32, device=o.x.device)
    t[sel] = t_c
    slot[sel] = s_c
    return t, slot
